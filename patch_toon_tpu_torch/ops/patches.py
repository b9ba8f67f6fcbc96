"""Batched patch gather for training (counterpart of
patch_toon_tpu/ops/patches.py:22-73).

The keyframe stack lives on the device, zero-padded at the bottom and right
by one patch (``pad_images_for_gather``), and a batch of patches is one
index gather. Crop semantics replicate the reference's ``_cut_patch``
(dataset.py:209-232) with its quirks, as the JAX package does: the crop is
``[max(0, y - s/2), min(y + s/2, H - 1))`` (so even interior crops at the
bottom edge lose the last row), and a short crop is zero-padded anchored
top-left. Each patch names its image and centre explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_images_for_gather(images: torch.Tensor,
                          patch_size: int) -> torch.Tensor:
    """Zero-pad the bottom and right of an (N, H, W, C) stack by
    ``patch_size``, so every window starting inside an image is in range."""
    return F.pad(images, (0, 0, 0, patch_size, 0, patch_size))


def cut_patches(padded: torch.Tensor, sizes: torch.Tensor,
                img_idx: torch.Tensor, centers: torch.Tensor,
                patch_size: int) -> torch.Tensor:
    """(B, ps, ps, C) patches of ``padded`` (N, H+ps, W+ps, C) at
    ``centers`` (B, 2) (y, x) of images ``img_idx`` (B,), with ``sizes``
    (N, 2) the true (H, W) of each image; zero outside the crop."""
    half = patch_size // 2
    img = img_idx.long()
    y, x = centers[:, 0].long(), centers[:, 1].long()
    h, w = sizes[img, 0].long(), sizes[img, 1].long()
    hn = torch.clamp_min(y - half, 0)
    xn = torch.clamp_min(x - half, 0)
    hx = torch.minimum(y + half, h - 1)  # reference dataset.py:216-219
    xx = torch.minimum(x + half, w - 1)
    r = torch.arange(patch_size, device=padded.device)
    patch = padded[img[:, None, None], (hn[:, None] + r)[:, :, None],
                   (xn[:, None] + r)[:, None, :]]
    rows = (r[None, :] < (hx - hn)[:, None]).to(patch.dtype)
    cols = (r[None, :] < (xx - xn)[:, None]).to(patch.dtype)
    return patch * rows[:, :, None, None] * cols[:, None, :, None]
