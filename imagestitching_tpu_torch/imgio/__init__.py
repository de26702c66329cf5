"""The port's own copy of ``imagestitching_tpu/imgio``."""

from . import codec
from .codec import ImageInfo, decode, encode, encode_bytes, get_image_info

__all__ = ["codec", "ImageInfo", "decode", "encode", "encode_bytes",
           "get_image_info"]
