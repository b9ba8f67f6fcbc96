"""The generator runs the real tiles only at bf16 and under int8, in every
tiled route (no padding row of JAX's XLA bucket, no frame repeated to fill
a card's chunk), and JAX's bucket where cuDNN runs full fp32 convs
(precision 32, int8 off).

Each route runs on a small sample scene at bf16 on the CPU (int8 at
precision 32) with the generator's batches recorded (a forward pre-hook on
every replica) next to the tile counts of the groups ``_pack`` was given,
and then again with the
padded plan JAX's engine uses (``bucket_size`` rows, the last frame of a
multi-card group repeated), put back for the run through the engine's own
seams. The outputs of the two runs agree within 1 count; each route's own
test file holds it within 1 count of the JAX engine.
"""

from __future__ import annotations

import contextlib
import pathlib
import shutil
import sys
from typing import List

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.infer import engine as engine_mod  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.infer.tiling import (  # noqa: E402
    bucket_size,
    pack_boxes_multi,
)
from patch_toon_tpu_torch.infer.programs import make_tile_plan  # noqa: E402
from patch_toon_tpu_torch.models.generator import GeneratorJ  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]
FRAMES = 5
WATCH = ["inference.watch.enabled=true", "inference.watch.poll_seconds=0.05",
         "inference.watch.idle_timeout_seconds=0.3"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Five 48x72 frames with masks and tracking, the same frames as two
    streams of a multi-stream layout, and a 6-channel checkpoint."""
    root = tmp_path_factory.mktemp("real_tiles")
    make_scene(str(root / "scene"), frames=FRAMES, height=48, width=72,
               seed=9)
    s = root / "scene"
    for name, frames in (("a", range(FRAMES)), ("b", range(1, 4))):
        for sub in ("input", "mask"):
            (root / "ms" / sub / name).mkdir(parents=True)
            files = sorted((s / sub).glob("*.png"))
            for j, i in enumerate(frames):
                shutil.copy(files[i], root / "ms" / sub / name /
                            f"{j + 1:03d}.png")
    torch.manual_seed(3)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               root / "gen.ckpt")
    return root


def _engine(root, out, *extra, layout="scene", precision="bf16"):
    if layout == "ms":
        inp, mask = root / "ms" / "input", root / "ms" / "mask"
        chans = ["paths.additional_channels={}",
                 "inference.temporal.enabled=true",
                 "inference.temporal.depth=3",
                 "inference.temporal.flow_source=device"]
    else:
        s = root / "scene"
        inp, mask = s / "input", s / "mask"
        chans = [f"paths.additional_channels.point_vector.path="
                 f"{s / 'tracking'}"]
    return StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=[
        f"paths.checkpoint={root / 'gen.ckpt'}", f"paths.input_dir={inp}",
        f"paths.mask_dir={mask}", f"paths.output_dir={out}",
        "inference.use_gpu=false", f"inference.precision={precision}",
        *chans, *ARCH, *extra]))


class Rows:
    """The generator's batch sizes, and the tile and frame counts of the
    groups ``_pack`` packed, during a run."""

    def __init__(self, eng):
        self.batches: List[int] = []
        self.tiles: List[int] = []
        self.frames = 0
        self.eng = eng

    @contextlib.contextmanager
    def recording(self):
        hooks = [m.register_forward_pre_hook(
            lambda _m, args: self.batches.append(int(args[0].shape[0])))
            for m in self.eng.models]
        pack = self.eng._pack

        def counted(group_boxes, h, w, device):
            self.tiles.append(sum(len(b) for b in group_boxes))
            self.frames += len(group_boxes)
            return pack(group_boxes, h, w, device)

        self.eng._pack = counted
        try:
            yield self
        finally:
            _restore(self.eng, "_pack", pack)
            for h in hooks:
                h.remove()


def _restore(eng, name, before):
    """Put back what ``eng.<name>`` was: an instance attribute, or the
    class's method (bound methods of one function and object compare
    equal)."""
    eng.__dict__.pop(name, None)
    if getattr(eng, name) != before:
        setattr(eng, name, before)


@contextlib.contextmanager
def padded_plan(eng):
    """JAX's padded plan on the engine: each group's tiles packed into
    ``bucket_size`` rows, and a multi-card group filled to D x fpd frames
    by repeating its last one."""
    def pack(group_boxes, h, w, device):
        n = sum(len(b) for b in group_boxes)
        fboxes, weights, _ = pack_boxes_multi(
            list(group_boxes), eng.patch_size, bucket_size(max(1, n)))
        return (make_tile_plan(fboxes, h, w, eng.patch_size, device),
                torch.from_numpy(weights).to(device))

    before = eng._pack
    eng._pack = pack
    if len(eng.cards) > 1:
        eng._dispatch_sharded = lambda group: _filled(eng, group)
    try:
        yield
    finally:
        _restore(eng, "_pack", before)
        eng.__dict__.pop("_dispatch_sharded", None)


def _filled(eng, group):
    """``_dispatch_sharded``'s work with JAX's filler frames: card ``k``
    runs the ``k``-th chunk of the group padded to D x fpd by repeating
    its last frame."""
    per = eng._pod_fpd or 1
    full = list(group) + [group[-1]] * (len(eng.cards) * per - len(group))
    outs = []
    for k, card in enumerate(eng.cards):
        if k * per >= len(group):
            break
        chunk = [eng._to_card(s, card) for s in full[k * per:(k + 1) * per]]
        eng._await_staged(chunk)
        frames = torch.stack([s.frame for s in chunk])
        masks = engine_mod.stack_masks(chunk)
        outs.extend(eng._run(frames, masks, [s.boxes for s in chunk],
                             k)[0].unbind(0))
    return outs[:len(group)]


def _read(d):
    return {p.relative_to(d).as_posix(): np.asarray(Image.open(p)).astype(
        int) for p in sorted(pathlib.Path(d).rglob("*.png"))}


def _serve(eng, watch):
    if watch:
        eng.watch_directory()
    else:
        eng.process_directory()


ROUTES = {
    "directory": ([], "scene", False),
    "devices_2": (["inference.devices=2"], "scene", False),
    "int8": (["inference.quantize=int8", "inference.precision=32"], "scene",
             False),
    "crop_upload": (["inference.crop_upload=on", "inference.tile_batch=40"],
                    "scene", False),
    "watch": (WATCH, "scene", True),
    "multistream": ([], "ms", False),
    "multistream_watch": (WATCH, "ms", True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_directory_routes_run_the_real_tiles(scene, tmp_path, route):
    extra, layout, watch = ROUTES[route]
    eng = _engine(scene, tmp_path / "real", *extra, layout=layout)
    with Rows(eng).recording() as rows:
        _serve(eng, watch)
    if route == "int8":  # first the calibration pass over one whole frame
        assert rows.batches.pop(0) == 1
    assert rows.batches and rows.batches == rows.tiles, route
    n_frames = FRAMES + (3 if layout == "ms" else 0)
    if layout == "ms":  # the single-stream cycles may go full-frame
        assert rows.frames <= n_frames
    else:
        assert rows.frames == n_frames
    if route == "devices_2":  # 4 frames a card: card 1 runs frame 5 alone
        assert eng._pod_fpd == 4
        assert rows.tiles == [rows.tiles[0], rows.tiles[1]]
    pad = _engine(scene, tmp_path / "padded", *extra, layout=layout)
    with padded_plan(pad), Rows(pad).recording() as prow:
        _serve(pad, watch)
    if route == "int8":
        assert prow.batches.pop(0) == 1
    assert len(prow.batches) == len(prow.tiles)
    assert all(b >= t for b, t in zip(prow.batches, prow.tiles))
    assert sum(prow.batches) > sum(rows.batches)
    got, want = _read(tmp_path / "real"), _read(tmp_path / "padded")
    assert len(got) == n_frames and got.keys() == want.keys()
    for name in got:
        assert np.abs(got[name] - want[name]).max() <= 1, name


def test_temporal_chain_runs_the_real_tiles(scene, tmp_path):
    """The tiled chain (one frame a dispatch, its previous output warped
    in as the guide) on the multi-stream layout's first stream."""
    s = scene / "ms"
    outs = {}
    for plan in ("real", "padded"):
        eng = StyleTransferInference(compose(REPO / "config", "inference",
                                             overrides=[
            f"paths.checkpoint={scene / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input' / 'a'}",
            f"paths.mask_dir={s / 'mask' / 'a'}",
            f"paths.output_dir={tmp_path / plan}",
            "paths.additional_channels={}", "inference.use_gpu=false",
            "inference.precision=bf16", "inference.temporal.enabled=true",
            "inference.temporal.depth=3",
            "inference.temporal.flow_source=device", *ARCH]))
        with (padded_plan(eng) if plan == "padded"
              else contextlib.nullcontext()), Rows(eng).recording() as rows:
            eng.process_directory()
        assert rows.frames == FRAMES and len(rows.batches) == FRAMES
        if plan == "real":
            assert rows.batches == rows.tiles
        else:
            assert all(b == bucket_size(t) for b, t in
                       zip(rows.batches, rows.tiles))
        outs[plan] = _read(tmp_path / plan)
    assert len(outs["real"]) == FRAMES
    for name, got in outs["real"].items():
        assert np.abs(got - outs["padded"][name]).max() <= 1, name


def test_single_frames_run_the_real_tiles(scene, tmp_path):
    """``process_image``, ``process_large_image`` under a mask and over the
    whole frame, and a frame with no tile at all (the generator not run,
    the frame composited as it is)."""
    s = scene / "scene"
    src = sorted((s / "input").glob("*.png"))[2]
    eng = _engine(scene, tmp_path)
    with Rows(eng).recording() as rows:
        eng.process_image(src, s / "mask" / src.name, tmp_path / "one.png")
        n_image = len(eng.patch_positions)
        frame = np.concatenate([np.asarray(Image.open(src).convert("RGB")),
                                np.asarray(Image.open(
                                    s / "tracking" / src.name).convert(
                                        "RGB"))], -1)
        mask = (np.asarray(Image.open(s / "mask" / src.name).convert("L"))
                > 127).astype(np.float32)
        masked = eng.process_large_image(frame, mask)
        n_masked = len(eng.patch_positions)
        whole = eng.process_large_image(frame)
        n_whole = len(eng.patch_positions)
        empty = eng.process_large_image(frame, np.zeros_like(mask))
    assert 0 < n_image and 0 < n_masked < n_whole
    assert rows.tiles == [n_image, n_masked, n_whole, 0]
    assert rows.batches == [n_image, n_masked, n_whole]
    np.testing.assert_array_equal(empty, frame[..., :3])
    with padded_plan(eng):
        for got, m in ((masked, mask), (whole, None)):
            want = eng.process_large_image(frame, m)
            assert np.abs(got.astype(int) - want).max() <= 1
        np.testing.assert_array_equal(
            eng.process_large_image(frame, np.zeros_like(mask)), empty)


def test_pack_cache_keys_the_real_layout(scene, tmp_path):
    """``_pack``'s cache: one entry a tile layout, holding exactly its real
    rows (weights too), reused for the same layout, at most
    ``_PACK_CACHE`` entries."""
    eng = _engine(scene, tmp_path)
    boxes = [[(0, 16, 0, 16), (8, 24, 8, 24)], [(0, 16, 40, 56)]]
    plan, weights = eng._pack(boxes, 48, 72, eng.device)
    assert plan.fboxes.shape == (3, 5) and weights.shape == (3, 16, 16)
    assert (plan.positions >= 0).all() and (weights.sum((1, 2)) > 0).all()
    assert eng._pack(boxes, 48, 72, eng.device)[0] is plan
    for i in range(engine_mod._PACK_CACHE + 2):
        eng._pack([[(0, 16, i, 16 + i)]], 48, 72, eng.device)
    assert len(eng._packs) == engine_mod._PACK_CACHE


@pytest.mark.parametrize("precision,quantize,bucket", [
    ("32", "off", True), ("32_fast", "off", False), ("bf16", "off", False),
    ("32", "int8", False)])
def test_pack_rows_follow_the_convs_precision(scene, tmp_path, precision,
                                              quantize, bucket):
    """``pack_rows``: JAX's bucket where cuDNN runs full fp32 convs, the
    real tiles at bf16, 32_fast and under int8, no row for no tile; at
    precision 32 a
    directory run's generator batches are the buckets of its groups."""
    eng = _engine(scene, tmp_path, f"inference.quantize={quantize}",
                  precision=precision)
    for n in (1, 17, 32, 33, 170, 510):
        assert eng.pack_rows(n) == (bucket_size(n) if bucket else n)
    assert eng.pack_rows(0) == 0
    if precision != "32" or quantize != "off":
        return
    with Rows(eng).recording() as rows:
        eng.process_directory()
    assert rows.frames == FRAMES
    assert rows.batches == [bucket_size(t) for t in rows.tiles]
    assert any(b > t for b, t in zip(rows.batches, rows.tiles))
