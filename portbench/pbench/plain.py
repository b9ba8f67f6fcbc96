"""Plain reference of what the program serves and trains, in fp32 PyTorch
and NumPy, independent of the program: it imports nothing of it and takes
nothing it made. The networks come from the configuration's reference
module (``configs/<reference>.py``), passed in as ``net``.

Serving a frame tiled (the reference implementation's semantics): the
mask binarized (> 128) and eroded (a pixel survives when its whole 7x7
zero-padded window is set); tile centres walked over the row-major list of
the eroded mask's pixels with step ``stride = int(ps * (1 - overlap))``,
the first of each (y // stride, x // stride) cell kept; a box of
``ps`` centred there, clipped to the frame; each tile the box's pixels
centred in a ``ps x ps`` square of zeros; the generator over the tiles;
each output weighted by the Gaussian window of its box's size (resized,
half-pixel bilinear, to ``ps``) and added at the box's start; the sum
divided by the summed weights where they exceed 1e-8; the frame's RGB
composited through the eroded mask, clamped, and rounded to bytes.

The temporal chain: the guide of frame t is frame t-1's stylized output
warped (bilinear, clamped at the border) by the backward flow from t to
t-1: pyramidal Lucas-Kanade (4 levels, 4 iterations, a 15x15 window,
1e-4 on the diagonal, updates clamped to the window) between the frames'
ITU-R 601 lumas (PIL's 16.16 fixed-point formula) in [0, 1]; the flow is
zeroed where the frame's mask is not set. A chain's first frame takes its
own RGB as the guide.

Training: the patch batch drawn as the configuration states (an image
uniformly, then one of its valid centres uniformly, from the run's seeded
generator: valid centres are the pixels whose 7x7 window meets the mask,
row-major; the crop ``[max(0, y - ps/2), min(y + ps/2, H - 1))`` and
likewise in x, anchored top-left in zeros); the GAN step in the
reference's order (D on real and the detached fake, MSE to 1 and 0 halved;
then G's L1 times its weight, the VGG features' MSE times its weight and
the updated D's MSE to 1 times its weight); each network's gradients
clipped to a global norm, L2 weight decay added, then Adam.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Box = Tuple[int, int, int, int]


def signed(u8: torch.Tensor) -> torch.Tensor:
    """Bytes to [-1, 1]: x / 255 * 2 - 1 in fp32."""
    return u8.to(torch.float32) / 255.0 * 2.0 - 1.0


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)).to(
        torch.uint8)


def _window_count(m: torch.Tensor, k: int) -> torch.Tensor:
    ones = torch.ones((1, 1, k, k), dtype=torch.float32, device=m.device)
    return F.conv2d(m[None, None].float(), ones, padding=k // 2)[0, 0]


def erode(mask_u8: torch.Tensor, k: int = 7) -> torch.Tensor:
    """(H, W) mask bytes -> the eroded {0, 1} fp32 mask."""
    m = (mask_u8 > 128).float()
    return (_window_count(m, k) > k * k - 0.5).float()


def valid_centres(mask_u8: torch.Tensor, k: int = 7) -> np.ndarray:
    """(M, 2) row-major (y, x) of the pixels whose k x k window meets the
    mask (> 0)."""
    m = (mask_u8 > 0).float()
    return torch.nonzero(_window_count(m, k) > 0.5).cpu().numpy()


def tile_boxes(eroded: np.ndarray, ps: int, overlap: float) -> List[Box]:
    h, w = eroded.shape
    stride = max(1, int(ps * (1.0 - min(max(overlap, 0.0), 100.0) / 100.0)))
    half = ps // 2
    seen, boxes = set(), []
    for idx in np.flatnonzero(eroded.reshape(-1) != 0)[::stride]:
        y, x = divmod(int(idx), w)
        cell = (y // stride, x // stride)
        if cell in seen:
            continue
        seen.add(cell)
        boxes.append((max(0, y - half), min(h, y + half),
                      max(0, x - half), min(w, x + half)))
    return boxes


def tile_weight(bh: int, bw: int, ps: int, device) -> torch.Tensor:
    def axis(n):
        i = torch.arange(n, dtype=torch.float64)
        return torch.exp(-((i - n / 2) ** 2) / (n / 4) ** 2)
    wgt = torch.outer(axis(bh), axis(bw)).float()
    if (bh, bw) != (ps, ps):
        wgt = F.interpolate(wgt[None, None], size=(ps, ps), mode="bilinear",
                            align_corners=False)[0, 0]
    return wgt.to(device)


def serve_tiled(generator: Callable, frame: torch.Tensor,
                rgb_u8: torch.Tensor, eroded: torch.Tensor,
                boxes: Sequence[Box], ps: int, chunk: int = 128
                ) -> torch.Tensor:
    """One frame: ``frame`` (H, W, C) fp32 in [-1, 1] (RGB, then guides),
    its RGB bytes, its eroded mask (H, W), its tile boxes -> (H, W, 3)
    fp32 composite in [-1, 1] (:func:`to_bytes` gives the frame's bytes).
    ``generator`` maps (N, C, ps, ps) to (N, 3, ps, ps)."""
    h, w, c = frame.shape
    dev = frame.device
    tiles = torch.zeros((len(boxes), c, ps, ps), dtype=torch.float32,
                        device=dev)
    chw = frame.permute(2, 0, 1)
    for i, (y0, y1, x0, x1) in enumerate(boxes):
        hoff, woff = (ps - (y1 - y0)) // 2, (ps - (x1 - x0)) // 2
        tiles[i, :, hoff:hoff + y1 - y0, woff:woff + x1 - x0] = \
            chw[:, y0:y1, x0:x1]
    outs = torch.cat([generator(tiles[i:i + chunk])
                      for i in range(0, len(boxes), chunk)]) if boxes \
        else tiles[:, :3]
    canvas = torch.zeros((3, h + ps, w + ps), dtype=torch.float32,
                         device=dev)
    wsum = torch.zeros((h + ps, w + ps), dtype=torch.float32, device=dev)
    for i, (y0, y1, x0, x1) in enumerate(boxes):
        wgt = tile_weight(y1 - y0, x1 - x0, ps, dev)
        canvas[:, y0:y0 + ps, x0:x0 + ps] += outs[i] * wgt
        wsum[y0:y0 + ps, x0:x0 + ps] += wgt
    out = canvas[:, :h, :w] / torch.where(wsum[:h, :w] > 1e-8,
                                          wsum[:h, :w], 1.0)
    rgb = signed(rgb_u8)
    m = eroded[..., None]
    return torch.clamp(rgb * (1.0 - m) + out.permute(1, 2, 0) * m, -1.0, 1.0)


# -- the temporal chain's flow and warp -----------------------------------

def luma(rgb_u8: torch.Tensor) -> torch.Tensor:
    r, g, b = (rgb_u8[..., i].to(torch.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).to(torch.uint8)


def _sample(img: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (C, H, W) at pixel coordinates, clamped to the
    frame."""
    c, h, w = img.shape
    gx = torch.clamp(xs, 0, w - 1) / max(w - 1, 1) * 2 - 1
    gy = torch.clamp(ys, 0, h - 1) / max(h - 1, 1) * 2 - 1
    grid = torch.stack([gx, gy], dim=-1)[None]
    return F.grid_sample(img[None], grid, mode="bilinear",
                         padding_mode="border", align_corners=True)[0]


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(H, W, C) image at (y + dy, x + dx) for an (H, W, 2) flow (dx, dy)."""
    h, w, _ = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    return _sample(img.permute(2, 0, 1).float(), yy + flow[..., 1],
                   xx + flow[..., 0]).permute(1, 2, 0)


def _down2(x: torch.Tensor) -> torch.Tensor:
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    return F.avg_pool2d(x[None, None, :2 * h2, :2 * w2], 2)[0, 0]


def _lk(i1: torch.Tensor, i2: torch.Tensor, flow: torch.Tensor, win: int,
        iters: int, eps: float) -> torch.Tensor:
    h, w = i1.shape
    yy = torch.arange(h, dtype=torch.float32, device=i1.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=i1.device)[None, :]
    for _ in range(iters):
        warped = _sample(i2[None], yy + flow[..., 1], xx + flow[..., 0])[0]
        px = F.pad(warped[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
        py = F.pad(warped[None, None], (0, 0, 1, 1), mode="replicate")[0, 0]
        ix = (px[:, 2:] - px[:, :-2]) * 0.5
        iy = (py[2:] - py[:-2]) * 0.5
        it = warped - i1
        s = F.avg_pool2d(torch.stack([ix * ix, ix * iy, iy * iy, ix * it,
                                      iy * it])[None], win, 1, win // 2,
                         count_include_pad=True)[0] * (win * win)
        axx, axy, ayy = s[0] + eps, s[1], s[2] + eps
        bx, by = -s[3], -s[4]
        det = axx * ayy - axy * axy
        du = torch.clamp((ayy * bx - axy * by) / det, -win, win)
        dv = torch.clamp((axx * by - axy * bx) / det, -win, win)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def backward_flow(gray_t: torch.Tensor, gray_prev: torch.Tensor,
                  levels: int = 4, iters: int = 4, win: int = 15,
                  eps: float = 1e-4) -> torch.Tensor:
    """(H, W, 2) flow (dx, dy) with ``prev[y + dy, x + dx] ~ cur[y, x]``."""
    pyr = [(gray_t.float() / 255.0, gray_prev.float() / 255.0)]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        if min(a.shape) // 2 < max(8, win):
            break
        pyr.append((_down2(a), _down2(b)))
    flow = torch.zeros((*pyr[-1][0].shape, 2), dtype=torch.float32,
                       device=gray_t.device)
    for a, b in reversed(pyr):
        if tuple(flow.shape[:2]) != tuple(a.shape):
            flow = 2.0 * F.interpolate(
                flow.permute(2, 0, 1)[None], size=tuple(a.shape),
                mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
        flow = _lk(a, b, flow, win, iters, eps)
    return flow


def chain_input(rgb_u8: torch.Tensor, guide_u8: torch.Tensor,
                prev_out: Optional[torch.Tensor],
                prev_rgb_u8: Optional[torch.Tensor],
                flow_mask: Optional[torch.Tensor], depth: int
                ) -> torch.Tensor:
    """(H, W, 6 + depth) fp32: RGB, guide, then the warped previous output
    (``prev_out``: its bytes, or its fp32 composite in [-1, 1]; None at a
    chain's start, where the frame's own RGB stands in)."""
    base = signed(torch.cat([rgb_u8, guide_u8], dim=-1))
    if prev_out is None:
        g = signed(rgb_u8)
    else:
        flow = backward_flow(luma(rgb_u8), luma(prev_rgb_u8))
        if flow_mask is not None:
            flow = flow * (flow_mask > 127).float()[..., None]
        g = warp(prev_out if prev_out.is_floating_point()
                 else signed(prev_out), flow)
    return torch.cat([base, g[..., :depth]], dim=-1)


# -- training ------------------------------------------------------------

def draw_batch(gen: torch.Generator, stack: torch.Tensor,
               sizes: Sequence[Tuple[int, int]],
               centres: Sequence[torch.Tensor], batch: int,
               ps: int) -> torch.Tensor:
    """(B, ps, ps, C) patches of ``stack`` (N, H, W, C) fp32, drawn as the
    module's docstring states."""
    n = stack.shape[0]
    dev = stack.device
    img = torch.randint(0, n, (batch,), generator=gen, device=dev)
    u = torch.rand((batch,), generator=gen, device=dev)
    counts = torch.tensor([len(c) for c in centres], device=dev)
    cnt = counts[img]
    cidx = torch.minimum(torch.floor(u * cnt).to(torch.int64), cnt - 1)
    half = ps // 2
    out = torch.zeros((batch, ps, ps, stack.shape[-1]), dtype=stack.dtype,
                      device=dev)
    for b, (i, ci) in enumerate(zip(img.tolist(), cidx.tolist())):
        y, x = (int(v) for v in centres[i][ci])
        h, w = sizes[i]
        y0, x0 = max(0, y - half), max(0, x - half)
        y1, x1 = min(y + half, h - 1), min(x + half, w - 1)
        out[b, :y1 - y0, :x1 - x0] = stack[i, y0:y1, x0:x1]
    return out


class Adam:
    """Clip to a global norm, add L2 weight decay, then Adam with bias
    corrections; fp32, one network's leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Sequence[float], wd: float, clip: Optional[float],
                 eps: float = 1e-8):
        self.params, self.lr, self.wd, self.clip, self.eps = \
            params, lr, wd, clip, eps
        self.b1, self.b2 = (float(b) for b in betas)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.last_grads: Dict[str, torch.Tensor] = {}

    def load(self, state: dict) -> None:
        """Start from ``state``: {"m": {leaf: tensor}, "v": ..., "t": the
        steps taken}."""
        self.m = {k: state["m"][k].clone().float() for k in self.params}
        self.v = {k: state["v"][k].clone().float() for k in self.params}
        self.t = int(state["t"])

    def state(self) -> dict:
        return {"m": {k: v.clone() for k, v in self.m.items()},
                "v": {k: v.clone() for k, v in self.v.items()}, "t": self.t}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                                  for g in grads.values())).float()
            if float(norm) >= self.clip:
                grads = {k: g / norm * self.clip for k, g in grads.items()}
        grads = {k: g + self.wd * self.params[k] for k, g in grads.items()}
        self.last_grads = grads
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            self.params[k].sub_(self.lr * upd)


def mse(a, b):
    return torch.mean(torch.square(a - b))


def train_steps(net, model: dict, sd_g: Dict[str, torch.Tensor],
                sd_d: Dict[str, torch.Tensor], sd_p: Dict[str, torch.Tensor],
                batches: Sequence[torch.Tensor], opt_cfg: dict,
                tcfg: dict, opt_start: Optional[dict] = None
                ) -> Dict[str, object]:
    """Steps of the GAN on ``batches`` ((B, ps, ps, 3 + 3 + guide) fp32:
    pre, post, guide), from copies of the given weights and, with
    ``opt_start`` ({"G": ..., "D": ...}, each as :meth:`Adam.load` takes
    it), the optimizers' states. -> {"losses": [{g_total_loss,
    d_total_loss}] a step, "grads1": each leaf's gradient as the first
    step's optimizer took it (clipped, decayed), "params": the leaves
    after the last step, "state": {"G", "D": every weight and buffer,
    "opt": {"G", "D": the optimizers' states}} after it}."""
    ga, da = model["generator"]["args"], model["discriminator"]["args"]
    layers = model["perception_loss"]["perception_model"]["args"][
        "feature_layers"]
    pw = float(model["perception_loss"]["weight"])
    clip = float(tcfg["gradient_clip_val"]) \
        if tcfg.get("use_gradient_clipping", False) else None
    g_par = {k: v.clone() for k, v in sd_g.items()}
    d_par = {k: v.clone() for k, v in sd_d.items()}
    g_leaves = {k: v for k, v in g_par.items() if v.is_floating_point()
                and not k.endswith(("running_mean", "running_var"))}
    opt_g = Adam(g_leaves, float(opt_cfg["generator"]["lr"]),
                 opt_cfg["generator"]["betas"],
                 float(opt_cfg["generator"]["weight_decay"]), clip)
    opt_d = Adam(d_par, float(opt_cfg["discriminator"]["lr"]),
                 opt_cfg["discriminator"]["betas"],
                 float(opt_cfg["discriminator"]["weight_decay"]), clip)
    if opt_start is not None:
        opt_g.load(opt_start["G"])
        opt_d.load(opt_start["D"])
    rw, aw = float(tcfg["reconstruction_weight"]), \
        float(tcfg["adversarial_weight"])
    losses, grads1 = [], {}
    for step, batch in enumerate(batches):
        pre, post, chans = batch[..., :3], batch[..., 3:6], batch[..., 6:]
        x = torch.cat([pre, chans], dim=-1).permute(0, 3, 1, 2)
        post_c = post.permute(0, 3, 1, 2)
        for t in g_leaves.values():
            t.requires_grad_(True)
        for t in d_par.values():
            t.requires_grad_(True)
        gen = net.generator(g_par, x, ga, train=True)
        real = net.discriminator(d_par, post_c, da)
        fake = net.discriminator(d_par, gen.detach(), da)
        d_loss = (mse(real, torch.ones_like(real))
                  + mse(fake, torch.zeros_like(fake))) * 0.5
        dg = torch.autograd.grad(d_loss, list(d_par.values()))
        opt_d.step(dict(zip(d_par, dg)))
        image = torch.mean(torch.abs(gen - post_c)) * rw
        with torch.no_grad():
            target = net.vgg_features(sd_p, post_c, layers)
        feats = net.vgg_features(sd_p, gen, layers)
        perc = sum(torch.sum(torch.square(a - b)) for a, b in
                   zip(feats, target)) / sum(a.numel() for a in feats) * pw
        logits = net.discriminator(d_par, gen, da)
        adv = mse(logits, torch.ones_like(logits)) * aw
        g_total = image + perc + adv
        gg = torch.autograd.grad(g_total, list(g_leaves.values()))
        opt_g.step(dict(zip(g_leaves, gg)))
        losses.append({"g_total_loss": float(g_total.detach()),
                       "d_total_loss": float(d_loss.detach())})
        if step == 0:
            grads1 = {**{f"G.{k}": v.detach().clone()
                         for k, v in opt_g.last_grads.items()},
                      **{f"D.{k}": v.detach().clone()
                         for k, v in opt_d.last_grads.items()}}
    params = {**{f"G.{k}": v.detach() for k, v in g_leaves.items()},
              **{f"D.{k}": v.detach() for k, v in d_par.items()}}
    state = {"G": {k: v.detach() for k, v in g_par.items()},
             "D": {k: v.detach() for k, v in d_par.items()},
             "opt": {"G": opt_g.state(), "D": opt_d.state()}}
    return {"losses": losses, "grads1": grads1, "params": params,
            "state": state}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between norms, |‖p‖ - ‖r‖| over the larger of
    ‖r‖ and the median leaf's ‖r‖ -> (gap, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    worst, leaf = 0.0, ""
    for k in names:
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        gap = abs(pn - rn[k]) / max(rn[k], med, 1e-30)
        if gap > worst or not leaf:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(grads: Dict[str, torch.Tensor],
                  share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's; the others move under Adam by round-off alone."""
    n = {k: float(torch.linalg.vector_norm(v.double()))
         for k, v in grads.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= share * med]


def unit_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)

