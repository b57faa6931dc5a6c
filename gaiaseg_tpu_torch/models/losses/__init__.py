from .cross_entropy import (CrossEntropyLoss, binary_cross_entropy,
                            distill_softened_ce, pairwise_gram_loss,
                            softmax_cross_entropy, weight_reduce_loss)
from .dice_focal import (DiceLoss, FocalLoss, MixedLoss, binary_dice,
                         multiclass_dice, pixel_accuracy, sigmoid_focal,
                         softmax_focal)
from .eql import (EQLCrossEntropyLoss, decode_packed_labels, equalize_loss,
                  mask_cross_entropy, self_cross_entropy)

__all__ = [
    "CrossEntropyLoss", "softmax_cross_entropy", "binary_cross_entropy",
    "weight_reduce_loss", "distill_softened_ce", "pairwise_gram_loss",
    "DiceLoss", "FocalLoss", "MixedLoss", "multiclass_dice", "binary_dice",
    "pixel_accuracy", "sigmoid_focal", "softmax_focal",
    "EQLCrossEntropyLoss", "equalize_loss", "decode_packed_labels",
    "mask_cross_entropy", "self_cross_entropy",
]
