"""Time ``conv_s8`` at the generator's int8 sites under other launch plans.

For each site of ``chip_smoke.INT8_SITES`` at B = 512 tiles in bf16, the
device time (``chip_smoke.queued_ms``) under :func:`ops.quant.conv_plan`'s
plan and under each kernel that takes the site (gather, halo) at
every ring depth that fits in shared memory, the gather's weight resident
or streamed (plans from ``csrc/quant_conv.cu``'s ``ptt_conv_s8_plan``).
Every variant is checked bitwise against the plain version first; one that
differs is reported and not timed.
Needs a CUDA card::

    python3 tools/conv_s8_plans_torch.py [--sites conv11 resnet ...]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from patch_toon_tpu_torch.ops import quant  # noqa: E402


def variants(cout, kp, k, stride):
    """The default plan, then each kernel's plan at every ring depth that
    fits (the gather kernel's with the weight resident and streamed)."""
    dt = torch.bfloat16
    out = [quant.conv_plan(cout, kp, dt, k, stride)]
    for v, resident in ((0, True), (0, False), (1, False)):
        for stages in range(2, 7):
            p = quant._plan(cout, kp, dt, k, stride, v, resident, stages)
            if p is not None and p not in out:
                out.append(p)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", nargs="*",
                    default=[r[0] for r in smoke.INT8_SITES])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for i, (name, h, w, cin, cout, k, stride, _) in \
            enumerate(smoke.INT8_SITES):
        if name not in args.sites:
            continue
        x, s, wp, w_s, bias, _ = smoke._int8_inputs(
            smoke.B, h, w, cin, cout, k, torch.bfloat16, dev, 100 + i)
        xq = quant.quantize_act(x, s)
        pad = k // 2
        ho, wo = quant.out_size(h, k, stride, pad), \
            quant.out_size(w, k, stride, pad)
        ops = 2 * smoke.B * ho * wo * cout * cin * k * k
        bound = ops / smoke.INT8_OPS * 1e3
        base = quant.conv_plan(cout, wp.shape[1], torch.bfloat16, k, stride)
        want = quant.conv_s8_plain(xq, wp, s, w_s, bias, k, stride, pad,
                                   torch.bfloat16)
        for p in variants(cout, wp.shape[1], k, stride):
            got = quant._conv_s8(xq, wp, s, w_s, bias, k, stride, pad,
                                 torch.bfloat16, p)
            if not torch.equal(got, want):  # reported, not timed
                print(f"[plans] site={name} plan={p} bitwise=False "
                      f"differing={int((got != want).sum())}", flush=True)
                continue
            ms = smoke.queued_ms([lambda: quant._conv_s8(
                xq, wp, s, w_s, bias, k, stride, pad, torch.bfloat16, p)],
                args.reps)
            print(f"[plans] site={name} default={p == base} "
                  f"plan={smoke._plan_text(p)} "
                  f"ms={ms:.4f} bound_ms={bound:.4f} "
                  f"share_of_bound={bound / ms:.3f}", flush=True)
        del x, xq, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
