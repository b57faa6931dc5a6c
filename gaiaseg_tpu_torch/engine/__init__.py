from .calibrate import bn_stats, calibrate_bn, load_bn_stats, reset_bn_stats
from .checkpoint import (latest_checkpoint, load_checkpoint, save_checkpoint,
                         subnet_ckpt_name, update_latest)
from .convert import variables_to_state_dict
from .extract import extract_subnet, subnet_model_cfg, subnet_name
from .evaluate import cross_arch_evaluate, evaluate, evaluate_population
from .inference import (Segmentor, inference_segmentor, init_segmentor,
                        show_result)
from .label_surgery import remap_classifier
from .optim import (build_lr_schedule, build_optimizer, clip_grad_norm,
                    freeze_labels, grad_clip_norm, scale_lr,
                    set_learning_rate, trainable_parameters)
from .teacher import load_teacher_checkpoint
from .train import (TrainState, configure_numerics, prepare_batch,
                    train_segmentor, train_step)

__all__ = ["bn_stats", "calibrate_bn", "load_bn_stats", "reset_bn_stats",
           "latest_checkpoint", "load_checkpoint", "save_checkpoint",
           "subnet_ckpt_name", "update_latest", "variables_to_state_dict",
           "extract_subnet", "subnet_model_cfg", "subnet_name",
           "cross_arch_evaluate", "evaluate", "evaluate_population",
           "Segmentor", "inference_segmentor", "init_segmentor",
           "show_result", "remap_classifier", "build_lr_schedule",
           "build_optimizer", "clip_grad_norm", "grad_clip_norm", "scale_lr",
           "set_learning_rate", "freeze_labels", "trainable_parameters",
           "load_teacher_checkpoint", "TrainState", "configure_numerics",
           "prepare_batch", "train_segmentor", "train_step"]
