"""Build the CUDA kernels of ``csrc/`` with plain nvcc; load them with ctypes.

Each ``csrc/*.cu`` compiles for Hopper (``sm_90a``) in its own ``nvcc -c``
process, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain C interface. Nothing includes
PyTorch's headers, so the build takes seconds, not the minutes that
``torch.utils.cpp_extension`` needs. The library is named by a hash of the
sources and flags and written into ``_build/`` beside this file (listed in
``.gitignore``): a changed source builds a new file, an unchanged one is
reused. The objects go to a temporary directory and the library to a
temporary name that ``os.replace`` moves into place, so a build that is
killed leaves no lock and no half-written library.

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
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
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
    # x, y, mean, rstd (null, or (n, c) fp32 outputs), part (workspace of
    # 2 * n * c * round_up(chunks, 4) fp32), n, hw, c, group, ppc (pixels a
    # chunk), chunks, dtype, act, slope, eps, device, stream
    "ptt_instance_norm_act_resident": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _F, _F, _I, _P],
    # x, y, mean, rstd (null, or (n, c) fp32 outputs), n, hw, c, k (CTAs a
    # sample), dtype, act, slope, eps, device, stream
    "ptt_instance_norm_act_sample": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _F, _I, _P],
    # x, dy, mean, rstd, dx, n, hw, c, dy's pixel and sample strides (in
    # elements), k, dtype, act, slope, device, stream
    "ptt_instance_norm_act_backward_sample": [_P, _P, _P, _P, _P, _I, _I, _I,
                                              _L, _L, _I, _I, _I, _F, _I,
                                              _P],
    # ppc, c, item, backward: the sample variant's shared memory a CTA
    "ptt_instance_norm_sample_smem": [_I, _I, _I, _I],
    # the cluster variant's shared-memory budget a CTA, in bytes
    "ptt_instance_norm_slice_bytes": [],
    # the resident variant's shared-memory budget a CTA, in bytes
    "ptt_instance_norm_resident_bytes": [],
    # gen, weights, positions, offsets, ids, canvas, wcanvas, n_tiles, ps,
    # canvas_h, canvas_w, block, device, stream
    "ptt_blend_tiles": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    # image, out, points, colors, valid (u8), n, h, w, r, s2, device, stream
    "ptt_splat_points": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x (NHWC), xq (NHWC, cp channels, int8), s (one fp32 on the device),
    # pixels, c, cp, dtype (0 f32, 1 bf16), device, stream
    "ptt_quantize_act": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xq, wq (cout, kp) packed, s, w_s, bias (or null), out, n, h, w, cp,
    # cout, kp, k, stride, pad, ho, wo, out_dtype (0 f32, 1 bf16, 2 the
    # int32 accumulator), the plan's variant, bn, stages and resident,
    # device, stream
    "ptt_conv_s8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # cout, kp, k, stride, out_dtype, variant (-1: conv_s8's own choice),
    # resident, stages (0: as deep as fits), plan (6 ints out): a conv_s8
    # layer's launch plan
    "ptt_conv_s8_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
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


def _run(cmds, what: str) -> str:
    """Run the commands side by side; their output, or raise naming the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            logs.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({what}) with code {rc}: "
                           f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one
    ``nvcc -c`` a source, all at once, then one link."""
    global last_build_seconds, last_build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        last_build_seconds = 0.0
        last_build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp.so")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            cus = [s for s in sources() if s.suffix == ".cu"]
            objs = [str(Path(objdir) / f"{s.stem}.o") for s in cus]
            text = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                         for s, o in zip(cus, objs)], "compile")
            text += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *objs]], "link")
        log.write_text(text)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    last_build_seconds = time.perf_counter() - t0
    last_build_log = text
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


def count_launch(wrapper, t) -> None:
    """One launch of ``wrapper``'s kernel on ``t``'s card: ``.launches``
    counts every launch, ``.by_device`` the launches a card index."""
    wrapper.launches += 1
    idx = t.device.index
    wrapper.by_device[idx] = wrapper.by_device.get(idx, 0) + 1


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
