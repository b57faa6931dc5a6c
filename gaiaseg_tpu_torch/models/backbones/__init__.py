from .beit import BEiT
from .dynamic_resnet import DynamicResNet
from .elastic_transformer import ElasticTransformer

__all__ = ["BEiT", "DynamicResNet", "ElasticTransformer"]
