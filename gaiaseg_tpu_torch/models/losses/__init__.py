from .cross_entropy import CrossEntropyLoss, softmax_cross_entropy

__all__ = ["CrossEntropyLoss", "softmax_cross_entropy"]
