"""The port's native frame IO: a C++ PNG codec with a threaded loader and
an asynchronous writer (counterpart of ``patch_toon_tpu/native``)."""

from patch_toon_tpu_torch.native.frameio import (
    FrameLoader,
    FrameWriter,
    decode_png,
    encode_png,
)

__all__ = ["FrameLoader", "FrameWriter", "decode_png", "encode_png"]
