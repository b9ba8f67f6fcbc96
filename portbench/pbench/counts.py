"""The benchmark's yardstick: the chip's peaks, and the operations and bytes
that the configurations' shapes and a window's work need.

Counts come from shapes alone (tiles served, steps taken), never from
what the program launched, so they stay right when a kernel is fused or
replaced. Operations are those of the convolutions and of the upsample's
matrix products (two multiply-adds are two operations), as
``torch.utils.flop_counter`` counts them; elementwise work is not counted.
Bytes of a kernel: each input read once and each output written once.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# One NVIDIA H100 SXM (data sheet, dense rates): the arithmetic a cell
# runs, and HBM3's bandwidth.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

Conv = Tuple[int, int, int, int, int]  # cout, cin, k, hout, wout


def _sites_and_convs(args: dict, cin: int, h: int, w: int):
    """GeneratorJ at an (h, w) input: its convs, its upsample products'
    operations per sample, and its InstanceNorm sites (h, w, c)."""
    f = list(args["filters"])
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    convs: List[Conv] = [(f[0], cin, 7, h, w), (f[1], f[0], 3, h2, w2),
                         (f[2], f[1], 3, h4, w4)]
    sites = [(h, w, f[0]), (h2, w2, f[1]), (h4, w4, f[2])]
    for _ in range(int(args["resnet_blocks"])):
        convs += [(f[2], f[2], 3, h4, w4)] * 2
        sites += [(h4, w4, f[2])] * 2
    up = 0

    def upsample(c, hh, ww):  # rows' product, then the columns'
        return 2 * (2 * hh) * hh * ww * c + 2 * (2 * ww) * ww * (2 * hh) * c

    up += upsample(2 * f[2], h4, w4)
    convs.append((f[4], 2 * f[2], 3, h2, w2))
    sites.append((h2, w2, f[4]))
    up += upsample(f[4] + f[1], h2, w2)
    convs.append((f[4], f[4] + f[1], 3, h, w))
    sites.append((h, w, f[4]))
    convs.append((f[5], f[4] + f[0] + cin, 7, h, w))
    if args.get("append_smoothers", True):
        convs += [(f[5], f[5], 3, h, w)] * 2
    convs.append((3, f[5], 1, h, w))
    return convs, up, sites


def _flops(convs: Sequence[Conv]) -> int:
    return sum(2 * co * ci * k * k * ho * wo for co, ci, k, ho, wo in convs)


def generator_flops(args: dict, cin: int, h: int, w: int) -> int:
    """Operations of one GeneratorJ forward over one (h, w) sample."""
    convs, up, _ = _sites_and_convs(args, cin, h, w)
    return _flops(convs) + up


def _disc_convs(args: dict, h: int, w: int) -> List[Conv]:
    nf = int(args["num_filters"])
    out: List[Conv] = []
    h, w = h // 2, w // 2
    out.append((nf, int(args.get("input_channels", 3)), 4, h, w))
    curr = nf
    for _ in range(1, int(args["n_layers"])):
        nxt = min(curr * 2, nf * 8)
        h, w = h // 2, w // 2
        out.append((nxt, curr, 4, h, w))
        curr = nxt
    nxt = min(curr * 2, nf * 8)
    h, w = h - 1, w - 1
    out.append((nxt, curr, 4, h, w))
    out.append((1, nxt, 4, h - 1, w - 1))
    return out


def _disc_sites(args: dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    return [(ho, wo, co) for co, _, _, ho, wo in _disc_convs(args, h, w)[1:-1]]


def _vgg_convs(layers: Sequence[int], h: int, w: int) -> List[Conv]:
    widths = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M")
    out, cin, idx = [], 3, 0
    for width in widths:
        if idx > max(layers):
            break
        if width == "M":
            h, w, idx = h // 2, w // 2, idx + 1
        else:
            out.append((int(width), cin, 3, h, w))
            cin, idx = int(width), idx + 2
    return out


def train_step_flops(model: dict, cin: int, batch: int, ps: int) -> int:
    """Operations of one GAN step on ``batch`` patches of ``ps x ps``: the
    generator's forward, its backward for the weights and for every input
    but the patches'; the discriminator's forward on real and fake and its
    backward for the weights and inner inputs (D phase), its forward and
    input backward on the generated batch (G phase); the VGG prefix's
    forward on both images and its input backward on the generated one.
    Recomputation is not counted (the step recomputes nothing)."""
    g_convs, g_up, _ = _sites_and_convs(model["generator"]["args"], cin, ps,
                                        ps)
    d = _disc_convs(model["discriminator"]["args"], ps, ps)
    p = _vgg_convs(model["perception_loss"]["perception_model"]["args"][
        "feature_layers"], ps, ps)
    fg, fd, fp = _flops(g_convs), _flops(d), _flops(p)
    g = 3 * fg - _flops(g_convs[:1]) + 2 * g_up
    dph = 2 * (3 * fd - _flops(d[:1]))
    gph = 2 * fd
    return batch * (g + dph + gph + 3 * fp)


def b1_forward_bytes(args: dict, cin: int, h: int, w: int,
                     itemsize: int) -> int:
    """B1's forward at the generator's 19 sites of one (h, w) sample: each
    site's input read once and output written once."""
    _, _, sites = _sites_and_convs(args, cin, h, w)
    return sum(2 * a * b * c * itemsize for a, b, c in sites)


def b1_backward_bytes_step(model: dict, cin: int, batch: int, ps: int,
                           itemsize: int) -> int:
    """B1's backward over one training step: x and dy read, dx written, at
    the generator's sites and the discriminator's normalized sites of its
    three calls (real and fake in the D phase, the generated batch in the
    G phase)."""
    _, _, g_sites = _sites_and_convs(model["generator"]["args"], cin, ps, ps)
    d_sites = _disc_sites(model["discriminator"]["args"], ps, ps)
    el = sum(a * b * c for a, b, c in g_sites) + 3 * sum(
        a * b * c for a, b, c in d_sites)
    return 3 * el * itemsize * batch


def b2_bytes(tiles: int, ps: int, frames: int, h: int, w: int) -> int:
    """B2 over one call: each tile's 3 fp32 values and its fp32 weight read,
    the fp32 canvas of 3 values and the weight sum written, of each frame's
    (h + ps) x (w + ps) rows; the small CSR tables are not counted."""
    return tiles * ps * ps * 16 + frames * (h + ps) * (w + ps) * 16


def _kind(precision: str) -> str:
    p = str(precision)
    if p in ("bf16", "bfloat16", "16"):
        return "bf16"
    if p in ("32", "fp32", "float32"):  # the program turns TF32 off there
        return "fp32"
    raise ValueError(f"no peak for precision {precision!r}")


def peak(precision: str) -> float:
    """The chip's operations a second at a serving or training precision."""
    return PEAK_FLOPS[_kind(precision)]


def itemsize(precision: str) -> int:
    """Bytes of an activation at a precision."""
    return 2 if _kind(precision) == "bf16" else 4
