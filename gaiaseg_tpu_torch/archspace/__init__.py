from .meta import fold_dict, meta_hash, meta_json, unfold_dict
from .samplers import (AnchorSampler, BaseSampler, CandidateSampler,
                       CompositeSampler, ConcatSampler, RangeSampler,
                       RepeatSampler, build_model_sampler)
from .rules import BaseRule, build_sample_rule
from .model_space import ModelSpace, ModelSpaceManager
from .complexity import get_model_complexity_info

__all__ = ["fold_dict", "unfold_dict", "meta_hash", "meta_json",
           "BaseSampler", "AnchorSampler", "RangeSampler", "CandidateSampler",
           "CompositeSampler", "RepeatSampler", "ConcatSampler",
           "build_model_sampler", "BaseRule", "build_sample_rule",
           "ModelSpace", "ModelSpaceManager", "get_model_complexity_info"]
