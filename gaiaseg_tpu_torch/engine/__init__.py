from .convert import variables_to_state_dict
from .evaluate import evaluate_arch
from .optim import (build_lr_schedule, build_optimizer, clip_grad_norm,
                    grad_clip_norm, scale_lr, set_learning_rate)
from .train import (configure_numerics, prepare_batch, train_segmentor,
                    train_step)

__all__ = ["variables_to_state_dict", "evaluate_arch", "build_lr_schedule",
           "build_optimizer", "clip_grad_norm", "grad_clip_norm", "scale_lr",
           "set_learning_rate",
           "configure_numerics", "prepare_batch", "train_segmentor",
           "train_step"]
