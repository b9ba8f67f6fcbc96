"""The general generator of the benchmark's inputs: shots and keyframes
rendered on the device from a seed and a traffic mix's parameters.

A shot is ``frames`` RGB frames of ``height x width`` with a 3-channel
guide and a mask each. Every frame is a textured background panning on a
closed path, under ``shapes`` textured ellipses that each move on a closed
path of period ``frames`` whose speed never exceeds ``max_speed_px`` a
frame, so a shot played twice over joins without a cut. The guide is a
smooth field (position-like colours on the background, each shape's own
colour and local coordinates on it) that moves with what it guides. The
mask is ``full`` (255 everywhere) or an ellipse covering a share of the
frame of ``mask_fraction``. Every seed gives the same sizes, speeds,
texture frequencies and amplitudes, radii and mask shares, so the same
work; the seed moves the phases, colours and centres and orders the
radii and shares.

Keyframes for training are frames of such a shot at evenly spaced
times, each with a target image (the frame's colours inverted and
posterized) and a mask.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from pbench.seeds import SCENE, stream_seed

WAVES = 8  # sinusoids of a texture


def _texture(gen: torch.Generator, n: int, lo: float, hi: float):
    """Parameters of ``n`` textures: WAVES sinusoids each, of periods spread
    geometrically from lo to hi pixels at evenly spaced angles and one
    amplitude (the same for every seed, so every seed's frames compress
    alike), with the seed's phases and base colour, 3 channels."""
    i = torch.arange(WAVES, dtype=torch.float32)
    per = lo * (hi / lo) ** (i / (WAVES - 1))
    ang = (i * (math.pi / WAVES)).expand(n, WAVES)
    k = 2 * math.pi / per
    return {"kx": k * torch.cos(ang), "ky": k * torch.sin(ang),
            "phase": torch.rand((n, WAVES, 3), generator=gen) * 2 * math.pi,
            "amp": torch.full((n, WAVES, 3), 0.3 / WAVES),
            "base": 0.3 + 0.4 * torch.rand((n, 3), generator=gen)}


def _eval_texture(tex, i: int, x: torch.Tensor, y: torch.Tensor):
    """(H, W, 3) of texture ``i`` at coordinates x, y."""
    dev = x.device
    kx, ky = tex["kx"][i].to(dev), tex["ky"][i].to(dev)
    arg = x[..., None] * kx + y[..., None] * ky       # (H, W, WAVES)
    s = torch.sin(arg[..., None] + tex["phase"][i].to(dev))  # (H,W,WAVES,3)
    return tex["base"][i].to(dev) + (s * tex["amp"][i].to(dev)).sum(dim=-2)


class Shot:
    """A seeded shot; :meth:`frame` renders frame ``t`` on the device."""

    def __init__(self, traffic: dict, seed: int, device: torch.device):
        self.t_len = int(traffic["frames"])
        self.h, self.w = int(traffic["height"]), int(traffic["width"])
        self.n_shapes = int(traffic.get("shapes", 6))
        self.speed = float(traffic.get("max_speed_px", 8.0))
        self.device = device
        gen = torch.Generator().manual_seed(stream_seed(seed, SCENE))
        n = self.n_shapes
        self.bg = _texture(gen, 1, 12.0, 90.0)
        self.tex = _texture(gen, n, 6.0, 40.0)
        self.guide_col = torch.rand((n, 3), generator=gen)
        # radii, centres and phases; every path has the same speed bound
        h, w = self.h, self.w
        # the same radii for every seed, in the seed's order
        order = torch.randperm(n, generator=gen).to(torch.float32)
        self.ry = (0.08 + 0.12 * order / max(n - 1, 1)) * h
        self.rx = (0.06 + 0.10 * order / max(n - 1, 1)) * w
        self.cy = (0.25 + 0.5 * torch.rand(n, generator=gen)) * h
        self.cx = (0.2 + 0.6 * torch.rand(n, generator=gen)) * w
        self.ph = torch.rand((n, 2), generator=gen) * 2 * math.pi
        # a path x = A sin(2 pi t / T + p) moves at most 2 pi A / T a frame
        self.amp = self.speed * self.t_len / (2 * math.pi * math.sqrt(2))
        self.bg_amp = min(self.amp, 2.0 * self.t_len / (2 * math.pi))
        self.bg_ph = float(torch.rand(1, generator=gen)) * 2 * math.pi
        yy = torch.arange(h, dtype=torch.float32, device=device)
        xx = torch.arange(w, dtype=torch.float32, device=device)
        self.y, self.x = torch.meshgrid(yy, xx, indexing="ij")

    def frame(self, t: int):
        """-> ((H, W, 3) uint8 frame, (H, W, 3) uint8 guide)."""
        w_t = 2 * math.pi * (t % self.t_len) / self.t_len
        px = self.bg_amp * math.sin(w_t + self.bg_ph)
        py = self.bg_amp * math.cos(w_t + self.bg_ph)
        bx, by = self.x - px, self.y - py
        img = _eval_texture(self.bg, 0, bx, by)
        guide = torch.stack([bx / self.w, by / self.h,
                             0.5 + 0.25 * torch.sin(bx / 97.0 + by / 61.0)],
                            dim=-1)
        for i in range(self.n_shapes):
            cx = float(self.cx[i]) + self.amp * math.sin(
                w_t + float(self.ph[i, 0]))
            cy = float(self.cy[i]) + self.amp * math.sin(
                w_t + float(self.ph[i, 1]))
            lx, ly = self.x - cx, self.y - cy
            rho = torch.sqrt(torch.square(lx / float(self.rx[i]))
                             + torch.square(ly / float(self.ry[i])))
            # a soft edge about 1.5 px wide
            alpha = torch.clamp((1.0 - rho) * float(min(self.rx[i],
                                                       self.ry[i])) / 1.5
                                + 0.5, 0.0, 1.0)[..., None]
            img = img * (1 - alpha) + _eval_texture(self.tex, i, lx, ly) \
                * alpha
            g = torch.stack([self.guide_col[i, 0].to(self.device)
                             + 0.0 * lx, 0.5 + 0.5 * lx / float(self.rx[i]),
                             0.5 + 0.5 * ly / float(self.ry[i])], dim=-1)
            guide = guide * (1 - alpha) + g * alpha
        return _u8(img), _u8(guide)

    def mask(self, fraction: float) -> torch.Tensor:
        """(H, W) uint8 {0, 255}: a centred ellipse of the frame's aspect
        covering ``fraction`` of it (at most pi/4)."""
        if fraction >= 1.0:
            return torch.full((self.h, self.w), 255, dtype=torch.uint8,
                              device=self.device)
        s = math.sqrt(fraction / math.pi)
        ry, rx = s * self.h, s * self.w
        rho = torch.square((self.x - self.w / 2) / rx) \
            + torch.square((self.y - self.h / 2) / ry)
        return ((rho <= 1.0).to(torch.uint8) * 255)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def target_of(frame: torch.Tensor) -> torch.Tensor:
    """A keyframe's painted target: the frame inverted and posterized to
    six levels a channel (uint8)."""
    inv = 255 - frame.to(torch.int32)
    return (torch.div(inv, 43, rounding_mode="floor") * 51).clamp(
        0, 255).to(torch.uint8)


def keyframes(traffic: dict, seed: int, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """``keyframes`` frames of a shot at evenly spaced times: uint8 tensors
    ``pre``, ``post`` and ``guide`` (K, H, W, 3) and ``mask`` (K, H, W),
    the masks covering shares evenly spaced over ``mask_fraction``."""
    k = int(traffic["keyframes"])
    shot = Shot({**traffic, "frames": int(traffic.get("frames", 96))}, seed,
                device)
    lo, hi = (float(v) for v in traffic["mask_fraction"])
    gen = torch.Generator().manual_seed(stream_seed(seed, SCENE) ^ 0x5A5A)
    # the same shares for every seed, in the seed's order
    fracs = lo + (hi - lo) * torch.randperm(k, generator=gen).to(
        torch.float32) / max(k - 1, 1)
    pre, post, guide, mask = [], [], [], []
    for i in range(k):
        f, g = shot.frame(i * shot.t_len // k)
        pre.append(f)
        post.append(target_of(f))
        guide.append(g)
        mask.append(shot.mask(float(fracs[i])))
    return {"pre": torch.stack(pre), "post": torch.stack(post),
            "guide": torch.stack(guide), "mask": torch.stack(mask)}
