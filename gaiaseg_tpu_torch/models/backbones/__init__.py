from .beit import BEiT
from .dynamic_convnext import DynamicConvNeXt
from .dynamic_resnet import DynamicResNet
from .elastic_convformer import ElasticConvformer
from .elastic_mixvit import ElasticMixViT
from .elastic_transformer import ElasticTransformer

__all__ = ["BEiT", "DynamicConvNeXt", "DynamicResNet", "ElasticConvformer",
           "ElasticMixViT", "ElasticTransformer"]
