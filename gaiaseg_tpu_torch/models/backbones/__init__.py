from .dynamic_resnet import DynamicResNet

__all__ = ["DynamicResNet"]
