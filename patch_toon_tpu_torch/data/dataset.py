"""Keyframe dataset on the device with batched patch sampling (counterpart
of patch_toon_tpu/data/dataset.py:56-254).

The keyframes (pre, post, guide channels) live on the device as one
zero-padded stack; valid patch centres follow the reference's 7x7
*dilation* of each mask (dataset.py:161-174) in row-major order; each
training step gathers its whole batch with one index gather
(``ops/patches.py``). Two constructors:

- ``StyleTransferDataset(...)`` builds the device tables (``stack``,
  ``sizes``, ``centers``, ``counts``) from decoded arrays;
- ``StyleTransferDataset.from_directories(...)`` decodes a scene through
  ``data/io.py`` first (needs Pillow).

Sampling is uniform with replacement: an image uniformly, then one of its
valid centres uniformly, drawn from the caller's ``torch.Generator``. The
JAX package's ``permutation`` mode (without replacement) is not ported yet
and raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch_toon_tpu_torch.ops.masks import dilate_valid_centers
from patch_toon_tpu_torch.ops.patches import cut_patches, pad_images_for_gather


def _channel_items(additional_channels: Optional[Dict[str, Any]]
                  ) -> List[Tuple[str, Any, int]]:
    """(name, path, depth) of each guide channel, in declaration order; a
    plain string is a path of depth 1 (reference lightning_model.py:100-115)."""
    items: List[Tuple[str, Any, int]] = []
    for name, cfg in (additional_channels or {}).items():
        if isinstance(cfg, dict):
            path = cfg["path"]
            path = list(path) if isinstance(path, (list, tuple)) else str(path)
            items.append((name, path, int(cfg.get("depth", 1))))
        else:
            items.append((name, str(cfg), 1))
    return items


def _check_sampling(sampling: str) -> None:
    if sampling == "permutation":
        raise NotImplementedError(
            "data.sampling='permutation' is not ported yet (uniform only)")
    if sampling != "uniform":
        raise ValueError(
            f"data.sampling={sampling!r}: expected uniform/permutation")


class StyleTransferDataset:
    """Keyframe triplets (pre / post / mask [+ guide channels]) on a device."""

    def __init__(self, pres: Sequence[np.ndarray],
                 posts: Optional[Sequence[np.ndarray]],
                 masks: Sequence[np.ndarray],
                 channels: Optional[Sequence[np.ndarray]] = None,
                 channel_depths: Sequence[int] = (),
                 patch_size: int = 80, augmentation_factor: int = 1,
                 sampling: str = "uniform", device: Any = "cuda",
                 names: Optional[Sequence[str]] = None):
        """pres / posts: (H, W, 3) float32 in [-1, 1]; masks: (H, W) in
        [0, 1]; channels: (H, W, sum(channel_depths)) float32 per image, or
        None. An image whose mask has no valid centre is skipped."""
        _check_sampling(sampling)
        self.sampling = sampling
        self.patch_size = int(patch_size)
        self.augmentation_factor = max(1, int(augmentation_factor))
        self.channel_depths = [int(d) for d in channel_depths]
        self.channel_depth = sum(self.channel_depths)
        self.has_post = posts is not None
        self.device = torch.device(device)
        names = list(names) if names is not None else \
            [str(i) for i in range(len(pres))]

        keep, centers = [], []
        for i, mask in enumerate(masks):
            ys, xs = np.nonzero(dilate_valid_centers(mask))  # row-major
            if len(ys) == 0:
                print(f"Skipping {names[i]}: empty mask")
                continue
            keep.append(i)
            centers.append(np.stack([ys, xs], axis=1).astype(np.int32))
        if not keep:
            raise RuntimeError("No usable keyframe triplets were loaded")
        self.image_names = [names[i] for i in keep]
        self.num_images = len(keep)
        self.sizes_np = np.asarray([pres[i].shape[:2] for i in keep],
                                   np.int32)
        hmax, wmax = (int(v) for v in self.sizes_np.max(axis=0))

        # one stack [pre | post | channels] on the channel axis, so one
        # gather serves the whole batch
        parts = [[pres[i] for i in keep]]
        self._pre_sl, off = (0, 3), 3
        self._post_sl = self._chan_sl = None
        if self.has_post:
            parts.append([posts[i] for i in keep])
            self._post_sl, off = (off, off + 3), off + 3
        if self.channel_depth:
            parts.append([channels[i] for i in keep])
            self._chan_sl = (off, off + self.channel_depth)
            off += self.channel_depth
        stack = np.zeros((self.num_images, hmax, wmax, off), np.float32)
        col = 0
        for frames in parts:
            width = frames[0].shape[-1]
            for i, f in enumerate(frames):
                stack[i, :f.shape[0], :f.shape[1], col:col + width] = f
            col += width
        self.stack = pad_images_for_gather(
            torch.from_numpy(stack).to(self.device), self.patch_size)
        self.sizes = torch.from_numpy(self.sizes_np).to(self.device)

        self.counts_np = np.asarray([len(c) for c in centers], np.int32)
        table = np.zeros((self.num_images, int(self.counts_np.max()), 2),
                         np.int32)
        for i, c in enumerate(centers):
            table[i, :len(c)] = c
        self.centers_np = table
        self.centers = torch.from_numpy(table).to(self.device)
        self.counts = torch.from_numpy(self.counts_np).to(self.device)

    @classmethod
    def from_directories(cls, dir_pre: Any, dir_post: Any, dir_mask: Any,
                         patch_size: int, augmentation_factor: int = 1,
                         additional_channels: Optional[Dict[str, Any]] = None,
                         sampling: str = "uniform",
                         device: Any = "cuda") -> "StyleTransferDataset":
        """Decode every keyframe of one scene, or of parallel lists of scene
        directories, through ``data/io.py``; a keyframe that fails to load
        is named and skipped (reference dataset.py:129-207)."""
        from patch_toon_tpu_torch.data.io import (
            find_corresponding_image,
            list_images,
            load_image_channels,
            load_image_rgb,
            load_mask,
        )

        _check_sampling(sampling)
        items = _channel_items(additional_channels)
        if isinstance(dir_pre, (list, tuple)):
            pre_dirs, mask_dirs = list(dir_pre), list(dir_mask)
            post_dirs = list(dir_post) if dir_post is not None \
                else [None] * len(pre_dirs)
        else:
            pre_dirs, post_dirs, mask_dirs = [dir_pre], [dir_post], [dir_mask]
        if not len(pre_dirs) == len(post_dirs) == len(mask_dirs):
            raise ValueError("dir_pre/dir_post/dir_mask list lengths differ")
        has_post = post_dirs[0] is not None
        pres, posts, masks, chans, names = [], [], [], [], []
        for si, (dp, dq, dm) in enumerate(zip(pre_dirs, post_dirs,
                                              mask_dirs)):
            scene = list_images(dp)
            if not scene:
                raise FileNotFoundError(f"No images found in {dp}")
            for name in scene:
                try:
                    pre = load_image_rgb(find_corresponding_image(dp, name))
                    post = load_image_rgb(find_corresponding_image(
                        dq, name)) if has_post else None
                    mask = load_mask(find_corresponding_image(dm, name))
                    ch = [load_image_channels(find_corresponding_image(
                        p[si] if isinstance(p, list) else p, name), d)
                        for _, p, d in items]
                except Exception as e:
                    print(f"Skipping {name}: {e}")
                    continue
                pres.append(pre)
                posts.append(post)
                masks.append(mask)
                chans.append(np.concatenate(ch, axis=-1) if ch else None)
                names.append(name)
        if not pres:
            raise RuntimeError("No usable keyframe triplets were loaded")
        return cls(pres, posts if has_post else None, masks,
                   chans if items else None, [d for _, _, d in items],
                   patch_size, augmentation_factor, sampling, device, names)

    # -- the reference's surface -------------------------------------------

    def __len__(self) -> int:
        """Valid centres x augmentation_factor (reference
        dataset.py:296-298)."""
        return int(self.counts_np.sum()) * self.augmentation_factor

    @property
    def total_input_channels(self) -> int:
        return 3 + self.channel_depth

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self) // batch_size)

    # -- sampling on the device --------------------------------------------

    def sample_centers(self, generator: torch.Generator, batch_size: int):
        """(img_idx, centers) of one batch: a uniform image, then a uniform
        valid centre of it, from ``generator`` (on the stack's device)."""
        img = torch.randint(0, self.num_images, (batch_size,),
                            generator=generator, device=self.device)
        u = torch.rand((batch_size,), generator=generator, device=self.device)
        count = self.counts[img]
        cidx = torch.minimum(torch.floor(u * count).to(torch.int64),
                             (count - 1).to(torch.int64))
        return img, self.centers[img, cidx]

    def gather_batch(self, img: torch.Tensor, ctrs: torch.Tensor,
                     aug_ctrs: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """The patch dict of explicit (image, centre) picks: ``pre``,
        ``post``, ``channels``, and with ``aug_ctrs`` ``already`` and
        ``channels_aug`` (dataset.py:276-292)."""
        ps = self.patch_size
        patch = cut_patches(self.stack, self.sizes, img, ctrs, ps)
        out = {"pre": patch[..., self._pre_sl[0]:self._pre_sl[1]]}
        if self._post_sl:
            out["post"] = patch[..., self._post_sl[0]:self._post_sl[1]]
        if self._chan_sl:
            out["channels"] = patch[..., self._chan_sl[0]:self._chan_sl[1]]
        if aug_ctrs is not None and self._post_sl:
            aug = cut_patches(self.stack, self.sizes, img, aug_ctrs, ps)
            out["already"] = aug[..., self._post_sl[0]:self._post_sl[1]]
            if self._chan_sl:
                out["channels_aug"] = aug[..., self._chan_sl[0]:
                                          self._chan_sl[1]]
        return out

    def sample_batch(self, generator: torch.Generator,
                     batch_size: int) -> Dict[str, torch.Tensor]:
        """One training batch. With ``augmentation_factor > 1`` the batch
        also carries ``already`` from a second uniform draw, which the step
        does not consume (as in the reference, lightning_model.py:201-258)."""
        img, ctrs = self.sample_centers(generator, batch_size)
        aug_ctrs = None
        if self.augmentation_factor > 1 and self._post_sl:
            _, aug_ctrs = self.sample_centers(generator, batch_size)
        return self.gather_batch(img, ctrs, aug_ctrs)

    @staticmethod
    def model_input(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """RGB then guide channels (reference lightning_model.py:211-221)."""
        if "channels" in batch:
            return torch.cat([batch["pre"], batch["channels"]], dim=-1)
        return batch["pre"]
