"""The port's native image IO: a C++ PNG and baseline JPEG codec with a
threaded loader and an asynchronous writer, and Pillow's LANCZOS resize
(counterpart of ``patch_toon_tpu/native``, and of what the JAX tools take
from Pillow)."""

from patch_toon_tpu_torch.native.frameio import (
    FrameLoader,
    FrameWriter,
    Refused,
    decode_counts,
    decode_native,
    decode_png,
    encode_jpeg,
    encode_png,
    probe,
    resize_lanczos,
    zero_decode_counts,
)

__all__ = ["FrameLoader", "FrameWriter", "Refused", "decode_counts",
           "decode_native", "decode_png", "encode_jpeg", "encode_png",
           "probe", "resize_lanczos", "zero_decode_counts"]
