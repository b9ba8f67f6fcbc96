"""The transport knobs (crop_upload, crop_readback, mask_upload) in the port,
against the JAX engine on the CPU.

A scene where JAX's upload window really crops: 6 frames of 256x384, patch
16, a 40x56 mask drifting a few pixels a frame, a 7x7 speckle (one pixel
after the 7x7 erosion) on the first two frames that no tile covers (the
speckle rule: the window must hold the mask's support), and the last two
frames' masks at the bottom-right corner (the window slides to stay inside
the frame). With the defaults every serving mode must write JAX's files
within 1 uint8 count (fp32 roundoff, as the other engine tests) and set
``_last_crop`` to JAX's for every group, and each port run must be bitwise
its own run with every knob off (``crop_readback=off crop_upload=off
mask_upload=plane``). int8 with the defaults calibrates on the first
dispatched window, as JAX does, and matches JAX's int8 engine within 1
count. Unit tests hold ``pack_mask`` / ``unpack_mask`` to numpy at odd
sizes and the three crop rules to JAX's on random masks.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from patch_toon_tpu.infer import common as jax_common
from patch_toon_tpu.infer.tiling import tile_boxes_from_mask as jax_boxes

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer import common
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.infer.tiling import tile_boxes_from_mask
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.ops.masks import erode_full_support_np

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W, PS, N = 256, 384, 16, 6
# (y, x) of each frame's 40x56 mask; the speckle's 7x7 square on frames 0-1
BLOBS = [(100, 60), (104, 66), (108, 72), (112, 78), (212, 322), (214, 326)]
SPECKLE = (200, 300)
ARCH = ["data.patch_size=16", "model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "inference.use_gpu=false",
        "inference.precision=32", "paths.additional_channels={}"]
OFF = ["inference.crop_readback=off", "inference.crop_upload=off",
       "inference.mask_upload=plane"]
CHAIN = ["inference.temporal.enabled=true",
         "inference.temporal.flow_source=device"]


# ---------------------------------------------------------------- units

@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 9), (2, 13, 17),
                                   (5, 8), (4, 1, 11)])
def test_pack_and_unpack_match_numpy(shape):
    rng = np.random.default_rng(sum(shape))
    m = (rng.random(shape) > 0.5).astype(np.float32)
    packed = common.pack_mask(m)
    h, w = shape[-2:]
    want = np.packbits(m.astype(np.uint8).reshape(*shape[:-2], -1), axis=-1)
    np.testing.assert_array_equal(packed, want)
    got = common.unpack_mask(torch.from_numpy(packed), h, w).numpy()
    np.testing.assert_array_equal(
        got, np.unpackbits(want, axis=-1, count=h * w).reshape(shape))
    assert got.dtype == np.uint8
    like = torch.zeros(shape + (3,))
    plane = common.mask_f32(torch.from_numpy(packed), like)
    assert plane.shape == shape + (1,) and plane.dtype == torch.float32
    np.testing.assert_array_equal(plane[..., 0].numpy(), m)
    assert common.pack_mask(m * 0.5 + (m == 0) * 0.25) is None  # fractional


_masks = st.builds(
    lambda h, w, seed, n: _random_mask(h, w, seed, n),
    st.integers(8, 70), st.integers(8, 90), st.integers(0, 2 ** 16),
    st.integers(0, 4))


def _random_mask(h, w, seed, n):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.float32)
    for _ in range(n):  # a few rectangles, some a single pixel
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y:y + rng.integers(1, h), x:x + rng.integers(1, w)] = 1
    return m


@settings(max_examples=60, deadline=None, database=None)
@given(_masks, _masks, st.sampled_from([8, 16, 32]),
       st.sampled_from([16, 64, 128]))
def test_crop_rules_match_jax(m1, m2, ps, bucket):
    for m in (m1, m2):
        assert common.mask_support_bbox(m) == jax_common.mask_support_bbox(m)
    h, w = m1.shape
    m2 = np.resize(m2, (h, w))
    boxes = [common.mask_support_bbox(m) for m in (m1, m2)]
    for group in (boxes, boxes[:1], [boxes[0], None]):
        for align in (8, 64):
            assert common.compute_crop_bbox(group, h, w, align) \
                == jax_common.compute_crop_bbox(group, h, w, align)
    tiles = tile_boxes_from_mask(m1, ps)
    assert tiles == [tuple(b) for b in jax_boxes(m1, ps)]
    for sb in (None, boxes[1]):
        assert common.upload_crop_window(tiles, h, w, ps, bucket,
                                         support_bbox=sb) \
            == jax_common.upload_crop_window(tiles, h, w, ps, bucket,
                                             support_bbox=sb)


# ---------------------------------------------------------------- engines

def _mask(i: int) -> np.ndarray:
    m = np.zeros((H, W), np.uint8)
    y, x = BLOBS[i]
    m[y:y + 40, x:x + 56] = 255
    if i < 2:
        m[SPECKLE[0]:SPECKLE[0] + 7, SPECKLE[1]:SPECKLE[1] + 7] = 255
    return m


def _ckpt(path: pathlib.Path, channels: int, seed: int) -> None:
    torch.manual_seed(seed)
    model = GeneratorJ(input_channels=channels, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The frames (10x10 blocks of seeded colour, a bright block moving
    right for the device flow), their masks, a two-shot multi-stream
    layout of the same files, and checkpoints of 3 and 3 + 3 channels."""
    root = tmp_path_factory.mktemp("torch_transport")
    rng = np.random.default_rng(17)
    for sub in ("input", "mask"):
        (root / sub).mkdir()
    for i in range(N):
        base = rng.integers(0, 200, (H // 10 + 1, W // 10 + 1, 3),
                            dtype=np.uint8)
        img = np.repeat(np.repeat(base, 10, 0), 10, 1)[:H, :W]
        img[110:150, 70 + 6 * i:110 + 6 * i] = 240
        Image.fromarray(img).save(root / "input" / f"{i:03d}.png")
        Image.fromarray(_mask(i)).save(root / "mask" / f"{i:03d}.png")
    for shot, frames in (("shot_a", range(3)), ("shot_b", range(3, 6))):
        for sub in ("input", "mask"):
            (root / "streams" / sub / shot).mkdir(parents=True)
            for i in frames:
                shutil.copy(root / sub / f"{i:03d}.png",
                            root / "streams" / sub / shot / f"{i:03d}.png")
    _ckpt(root / "gen3.ckpt", 3, 5)
    _ckpt(root / "gen6.ckpt", 6, 6)
    return root


def _recording(cls):
    """``cls`` with every assignment to ``_last_crop`` recorded in
    ``crops``."""
    class Recording(cls):
        @property
        def _last_crop(self):
            return self.__dict__.get("_crop")

        @_last_crop.setter
        def _last_crop(self, v):
            self.__dict__.setdefault("crops", []).append(
                None if v is None else tuple(int(a) for a in v))
            self.__dict__["_crop"] = v

    return Recording


def _overrides(root, out, *extra, layout=""):
    d = root / layout if layout else root
    ckpt = "gen6.ckpt" if CHAIN[0] in extra else "gen3.ckpt"
    return [f"paths.checkpoint={root / ckpt}",
            f"paths.input_dir={d / 'input'}", f"paths.mask_dir={d / 'mask'}",
            f"paths.output_dir={out}", *ARCH, *extra]


def _jax(root, out, *extra, layout=""):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    eng = _recording(JaxEngine)(jax_compose(
        REPO / "config", "inference",
        overrides=_overrides(root, out, *extra, layout=layout)))
    eng.crops = []
    eng.process_directory(progress=False)
    return eng


def _port(root, out, *extra, layout=""):
    eng = _recording(StyleTransferInference)(compose(
        REPO / "config", "inference",
        overrides=_overrides(root, out, *extra, layout=layout)))
    eng.crops = []
    eng.process_directory()
    return eng


def _read(d):
    return {str(p.relative_to(d)): np.asarray(Image.open(p)).astype(np.int64)
            for p in sorted(pathlib.Path(d).rglob("*.png"))}


def _held(root, tmp_path, *extra, layout="", n=N, crops=True):
    """The port with the defaults against JAX (within 1 count, the same
    ``_last_crop`` sequence) and against its own run with every knob off
    (bitwise). -> (port engine, JAX engine, the port's files)."""
    jax_eng = _jax(root, tmp_path / "jax", *extra, layout=layout)
    eng = _port(root, tmp_path / "port", *extra, layout=layout)
    off = _port(root, tmp_path / "off", *extra, *OFF, layout=layout)
    assert eng.crop_readback and eng.crop_upload and eng.mask_packed
    assert not (off.crop_readback or off.crop_upload or off.mask_packed)
    want, got, plain = (_read(tmp_path / d) for d in ("jax", "port", "off"))
    assert got.keys() == want.keys() == plain.keys() and len(got) == n
    for name in got:
        d = np.abs(got[name] - want[name])
        assert d.max() <= 1, (name, int(d.max()))
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)
    if crops:
        assert eng.crops == jax_eng.crops and eng.crops
    return eng, jax_eng, got


def test_speckle_and_edge_windows_are_exercised(scene):
    """The scene's premises: frame 0's eroded speckle pixel lies in no
    tile, its window holds it and is smaller than the frame, and frame
    4's window sits at the frame's bottom-right corner."""
    m0 = erode_full_support_np(_mask(0) > 128)
    sy, sx = SPECKLE[0] + 3, SPECKLE[1] + 3
    assert m0[sy, sx] == 1 and m0[sy - 1:sy + 2, sx - 1:sx + 2].sum() == 1
    boxes = tile_boxes_from_mask(m0, PS)
    assert not any(b[0] <= sy < b[1] and b[2] <= sx < b[3] for b in boxes)
    win = common.upload_crop_window(boxes, H, W, PS,
                                    support_bbox=common.mask_support_bbox(m0))
    assert win[0] <= sy < win[1] and win[2] <= sx < win[3]
    assert (win[1] - win[0]) * (win[3] - win[2]) < H * W
    m4 = erode_full_support_np(_mask(4) > 128)
    win4 = common.upload_crop_window(tile_boxes_from_mask(m4, PS), H, W, PS,
                                     support_bbox=common.mask_support_bbox(
                                         m4))
    assert win4[1] == H and win4[3] == W and win4[0] > 0 and win4[2] > 0


def test_tiled_defaults_match_jax_and_the_knobs_off(scene, tmp_path):
    eng, _, got = _held(scene, tmp_path)
    # three window shapes in two groups: frames 0-1 (with the speckle),
    # then 2-5, the last two at the corner
    assert len(eng.crops) == 2 and all(c is not None for c in eng.crops)
    assert eng.crops[0][1] - eng.crops[0][0] < H
    # the speckle composites gray (the generator's zero canvas), as in the
    # whole frame
    sy, sx = SPECKLE[0] + 3, SPECKLE[1] + 3
    np.testing.assert_array_equal(got["000.png"][sy, sx], [128, 128, 128])


def test_fullframe_crop_readback_matches_jax(scene, tmp_path):
    eng, _, _ = _held(scene, tmp_path, "inference.mode=fullframe")
    assert len(eng.crops) == N and all(c is not None for c in eng.crops)


def test_device_flow_chain_with_packed_flow_masks_matches_jax(scene,
                                                              tmp_path):
    eng, _, _ = _held(scene, tmp_path, *CHAIN)
    assert len(eng.crops) == N and all(c is not None for c in eng.crops)
    # the carry stays the whole frame on the device
    assert eng._temporal_prev.shape == (H, W, 3)


def test_two_shot_multistream_matches_jax(scene, tmp_path):
    eng, _, got = _held(scene, tmp_path, *CHAIN, layout="streams",
                        crops=False)
    assert sorted({k.split("/")[0] for k in got}) == ["shot_a", "shot_b"]


def test_two_devices_match_jax(scene, tmp_path):
    eng, _, _ = _held(scene, tmp_path, "inference.devices=2")
    assert len(eng.cards) == 2 and eng.crops


def test_int8_calibrates_on_the_first_window_as_jax(scene, tmp_path):
    """JAX calibrates int8 on the frame its first dispatch sees: under
    crop_upload, frame 0's window. The port does the same, so its int8
    files match JAX's within 1 count; with the knobs off both calibrate on
    the whole frame and the run is not bitwise the default one."""
    q = "inference.quantize=int8"
    jax_eng = _jax(scene, tmp_path / "jax", q)
    seen = []
    cls = _recording(StyleTransferInference)
    ensure = cls._ensure_quant

    def noted(self, frame):
        if not self._quant_ready:
            seen.append(tuple(frame.shape))
        return ensure(self, frame)

    cls._ensure_quant = noted
    eng = cls(compose(REPO / "config", "inference",
                      overrides=_overrides(scene, tmp_path / "port", q)))
    eng.crops = []
    eng.process_directory()
    win = eng.crops[0]
    assert seen == [(win[1] - win[0], win[3] - win[2], 3)]
    assert eng.crops == jax_eng.crops
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == N
    for name in got:
        d = np.abs(got[name] - want[name])
        assert d.max() <= 1, (name, int(d.max()))


def test_watch_loops_inherit_the_knobs(scene, tmp_path, monkeypatch):
    """Watch mode serves through ``process_directory`` (the flat loop) and
    ``_watch_multistream`` (a subdirectory per video): with the defaults
    each writes its one-shot run's files bitwise, the flat loop with the
    one-shot upload windows, the multi-stream loop reading back each
    frame's own box."""
    from patch_toon_tpu_torch.infer import pipeline

    seen = []
    real = pipeline.readback_boxes

    def noted(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(pipeline, "readback_boxes", noted)
    watch = ["inference.watch.enabled=true",
             "inference.watch.poll_seconds=0.05",
             "inference.watch.idle_timeout_seconds=0.3"]
    for layout, extra in (("", ()), ("streams", CHAIN)):
        one = _port(scene, tmp_path / f"one{layout}", *extra, layout=layout)
        seen.clear()
        eng = _recording(StyleTransferInference)(compose(
            REPO / "config", "inference", overrides=_overrides(
                scene, tmp_path / f"watch{layout}", *extra, *watch,
                layout=layout)))
        eng.crops = []
        eng.watch_directory()
        want = _read(tmp_path / f"one{layout}")
        got = _read(tmp_path / f"watch{layout}")
        assert got.keys() == want.keys() and len(got) == N
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], name)
        if layout:  # each frame's own readback box
            boxes = [b for group in seen for b in group]
            assert len(boxes) == N and all(b is not None for b in boxes)
        else:
            assert eng.crops == one.crops and len(eng.crops) == 2


def test_debug_overlays_are_drawn_in_frame_coordinates(scene, tmp_path):
    """With ``debug_mode`` the overlay of an upload-cropped frame outlines
    its tiles where they lie in the whole frame: every file, overlays
    included, bitwise the knobs-off run's."""
    _port(scene, tmp_path / "on", "inference.debug_mode=true")
    _port(scene, tmp_path / "off", "inference.debug_mode=true", *OFF)
    on, off = _read(tmp_path / "on"), _read(tmp_path / "off")
    assert on.keys() == off.keys() and len(on) == 2 * N
    assert sum(k.startswith("debug_") for k in on) == N
    for name in on:
        np.testing.assert_array_equal(on[name], off[name], name)
