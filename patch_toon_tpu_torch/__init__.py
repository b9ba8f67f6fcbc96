"""patch-toon-tpu-torch: the PyTorch/CUDA port of patch_toon_tpu.

Video stylization (tiled, full-frame, with or without the temporal guide)
and GAN training with the GeneratorJ model on NVIDIA GPUs, one or several
(``parallel/``). The two Pallas kernels of the JAX package become CUDA
kernels written for Hopper (``csrc/``), built with plain ``nvcc`` at first
use and bound with ``ctypes`` (``_build.py``). Every kernel wrapper runs
its plain PyTorch version for a tensor on the CPU, which is what the CPU
tests exercise.

The package imports ``torch`` and ``numpy`` only: no JAX, nothing of
``patch_toon_tpu``, and no PIL or yaml at module level.
"""

from patch_toon_tpu_torch.version import __version__

__all__ = ["__version__"]
