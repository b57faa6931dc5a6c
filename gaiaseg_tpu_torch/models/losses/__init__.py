from .cross_entropy import (CrossEntropyLoss, distill_softened_ce,
                            pairwise_gram_loss, softmax_cross_entropy)
from .dice_focal import pixel_accuracy

__all__ = ["CrossEntropyLoss", "softmax_cross_entropy",
           "distill_softened_ce", "pairwise_gram_loss", "pixel_accuracy"]
