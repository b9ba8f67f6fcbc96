"""Build the CUDA kernels of ``csrc/`` with plain nvcc; load them with ctypes.

One ``nvcc`` call compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into
one shared library with a plain C interface. Nothing includes PyTorch's
headers, so the build takes seconds, not the minutes that
``torch.utils.cpp_extension`` needs. The library is named by a hash of the
sources and flags and written into ``_build/`` beside this file (listed in
``.gitignore``): a changed source builds a new file, an unchanged one is
reused. nvcc writes to a temporary name that ``os.replace`` moves into
place, so a build that is killed leaves no lock and no half-written library.

Each C entry point takes pointers, sizes, the device index and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point: a pointer or the stream must be c_void_p,
# or ctypes passes it as a 32-bit int and cuts it
SIGNATURES = {
    # x, y, mean, rstd (null, or (n, c) fp32 for the backward pass), n, hw,
    # c, group, k, dtype (0 f32, 1 bf16), act (0 none, 1 relu,
    # 2 leaky_relu), slope, eps, device, stream
    "ptt_instance_norm_act_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _F, _F, _I, _P],
    # x, y, mean, rstd, n, hw, c, dtype, act, slope, eps, device, stream
    "ptt_instance_norm_act_streaming": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _F, _F, _I, _P],
    # x, dy, mean, rstd, dx, n, hw, c, group, k, dtype, act, slope, device,
    # stream
    "ptt_instance_norm_act_backward_cluster": [_P, _P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I, _F, _I, _P],
    # x, dy, mean, rstd, dx, n, hw, c, dtype, act, slope, device, stream
    "ptt_instance_norm_act_backward_streaming": [_P, _P, _P, _P, _P, _I, _I,
                                                 _I, _I, _I, _F, _I, _P],
    # x, y, mean, rstd ((n, c) fp32, always written), part (workspace of
    # 2 * units * group * chunks fp32), counters (units zeros, left zero),
    # n, hw, c, group, ppc (pixels a chunk), chunks, dtype, act, slope, eps,
    # device, stream
    "ptt_instance_norm_act_split": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _F, _F, _I, _P],
    # the cluster variant's shared-memory budget a CTA, in bytes
    "ptt_instance_norm_slice_bytes": [],
    # gen, weights, positions, offsets, ids, canvas, wcanvas, n_tiles, ps,
    # canvas_h, canvas_w, block, device, stream
    "ptt_blend_tiles": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
}

_lib: Optional[ctypes.CDLL] = None
# seconds the last build in this process took (0.0 when it was reused) and
# what nvcc printed (registers, shared memory and spills of each kernel),
# kept beside the library so that a reused build reports it too
last_build_seconds: Optional[float] = None
last_build_log: str = ""


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    global last_build_seconds, last_build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        last_build_seconds = 0.0
        last_build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}")
        log.write_text(proc.stderr + proc.stdout)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stderr + proc.stdout
    return out


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().ptt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
