from .encoder_decoder import DynamicEncoderDecoder

__all__ = ["DynamicEncoderDecoder"]
