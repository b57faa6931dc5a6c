from .meta import fold_dict, meta_hash, meta_json, unfold_dict
from .samplers import (AnchorSampler, BaseSampler, CandidateSampler,
                       CompositeSampler, ConcatSampler, RangeSampler,
                       RepeatSampler, build_model_sampler)

__all__ = ["fold_dict", "unfold_dict", "meta_hash", "meta_json",
           "BaseSampler", "AnchorSampler", "RangeSampler", "CandidateSampler",
           "CompositeSampler", "RepeatSampler", "ConcatSampler",
           "build_model_sampler"]
