from .dynamic_distiller import DynamicDistiller
from .encoder_decoder import DynamicEncoderDecoder

__all__ = ["DynamicDistiller", "DynamicEncoderDecoder"]
