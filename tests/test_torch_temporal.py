"""The port's temporal guide chain, flows from files, against the JAX package
on the CPU.

The warp (``ops/flow.py``) and the chain's prologue (``_temporal_prep``)
are held to the JAX functions on the same numpy inputs: the warp within
1e-6 and the prologue within 2e-7 plus that (XLA on the CPU contracts the
interpolation into multiply-adds, and its jitted normalization may differ
from the host's IEEE values by an ulp). The chain through
``process_directory`` (5 frames of seeded smooth flows, one flow file
missing, and the broken chain without a flow_dir; tiled and fullframe;
precision 32) is held within 1 uint8 count of the JAX engine on the same
torch checkpoint, and the port's own loop bitwise to driving
``_chain_step`` directly and to a chain split over two calls. The chain
with the device flow (``flow_source: device``; partial masks in a
``mask_ignore`` directory, with a band of luma 128 that the flow mask keeps
and the composite mask drops, and one frame's mask missing) is held within
1 count of the JAX engine, tiled and fullframe, at flow_scale 1 and 2;
``flow_batch`` 3 and a chain split over two calls bitwise to one call.
"""

import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.infer.temporal import _temporal_prep as jax_prep
from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ
from patch_toon_tpu.ops.flow import warp_image as jax_warp

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.infer.temporal import _temporal_prep
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.ops.flow import warp_image
from patch_toon_tpu_torch.utils.weights import generator_state_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
N, H, W = 5, 48, 64
MISSING = 2  # the frame whose flow file is left out
NO_MASK = 3  # the frame whose mask is left out of mask_ignore


def test_warp_image_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((20, 30, 3)).astype(np.float32) * 2 - 1
    # displacements that reach past every border, and whole pixels
    flow = ((rng.random((20, 30, 2)) - 0.5) * 16).astype(np.float32)
    flow[:4] = np.round(flow[:4])
    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = warp_image(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    shift = np.zeros((20, 30, 2), np.float32)
    shift[..., 0] = 3.0  # sample 3 pixels to the right
    got = warp_image(torch.from_numpy(img), torch.from_numpy(shift)).numpy()
    np.testing.assert_array_equal(got[:, :-3], img[:, 3:])
    np.testing.assert_array_equal(got[:, -3:], img[:, -1:].repeat(3, 1))


@pytest.mark.parametrize("variant", ["warp", "bootstrap", "hold",
                                     "warp_f16", "float_frame"])
def test_temporal_prep_matches_jax(variant):
    rng = np.random.default_rng(7)
    frame = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    prev = rng.random((24, 32, 3)).astype(np.float32) * 2 - 1
    flow = ((rng.random((24, 32, 2)) - 0.5) * 6).astype(np.float32)
    if variant == "warp_f16":
        flow = flow.astype(np.float16)
    if variant == "float_frame":  # the host-normalized upload
        frame = frame.astype(np.float32) / 255 * 2 - 1
    p = None if variant == "bootstrap" else prev
    f = None if variant in ("bootstrap", "hold") else flow
    want = np.asarray(jax_prep(jnp.asarray(frame),
                               None if p is None else jnp.asarray(p),
                               None if f is None else jnp.asarray(f), 3))
    got = _temporal_prep(torch.from_numpy(frame),
                         None if p is None else torch.from_numpy(p),
                         None if f is None else torch.from_numpy(f),
                         3).numpy()
    assert got.shape == want.shape == (24, 32, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 + 1e-6)
    if variant == "hold":  # the previous output, bit for bit
        np.testing.assert_array_equal(got[..., 3:], prev)
    if variant == "bootstrap":
        np.testing.assert_array_equal(got[..., 3:], got[..., :3])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """5 frames of a block moving right over a seeded background, full
    masks, seeded smooth backward flows (one file left out) and a
    checkpoint taking 3 + 3 channels."""
    root = tmp_path_factory.mktemp("torch_temporal")
    rng = np.random.default_rng(3)
    for sub in ("input", "mask", "flow_bwd", "mask_ignore"):
        (root / sub).mkdir()
    partial = np.zeros((H, W), np.uint8)
    partial[6:42, 4:50] = 255
    partial[6:42, 50:58] = 128  # in the flow mask (> 127), not the composite
    bg = (rng.random((H, W, 3)) * 160).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(N):
        frame = bg.copy()
        x0 = 6 + 5 * i
        frame[16:32, x0:x0 + 14] = (rng.random(3) * 100 + 155).astype(
            np.uint8)
        Image.fromarray(frame).save(root / "input" / f"{i:03d}.png")
        Image.fromarray(np.full((H, W), 255, np.uint8)).save(
            root / "mask" / f"{i:03d}.png")
        if i != NO_MASK:
            Image.fromarray(partial).save(root / "mask_ignore" / f"{i:03d}.png")
        a, b = rng.random(2) * 2 * np.pi
        flow = np.stack([-5.0 + 1.5 * np.sin(yy / 9 + a),
                         0.8 * np.cos(xx / 11 + b)], -1).astype(np.float32)
        if i != MISSING:
            np.save(root / "flow_bwd" / f"{i:03d}.npy", flow)
    # the weights: a JAX generator's (numpy draws, seed 13) taking 3 RGB +
    # 3 temporal channels, carried across by utils/weights.py and saved as
    # the reference .ckpt that both engines read
    gen = JaxGeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                        use_bias=True, resnet_blocks=1)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 6)))
    draws = np.random.default_rng(13)

    def draw(path, leaf):
        a = draws.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return np.abs(a) + 0.5 if "var" in name else a * 0.2

    g_vars = jax.tree_util.tree_map_with_path(draw, shapes)
    sd = generator_state_from_jax(g_vars["params"], g_vars["batch_stats"],
                                  resnet_blocks=1)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    model.load_state_dict(sd, strict=True)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}},
               root / "gen.ckpt")
    return root


def _overrides(root, out, *extra):
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={root / 'input'}",
            f"paths.mask_dir={root / 'mask'}", f"paths.output_dir={out}",
            "paths.additional_channels={}", "data.patch_size=16",
            "inference.use_gpu=false", "inference.precision=32",
            "inference.temporal.enabled=true", "inference.temporal.depth=3",
            "model.generator.args.resnet_blocks=1",
            "model.generator.args.filters=[4,8,8,8,8,4]", *extra]


def _port(root, out, *extra):
    return StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=_overrides(root, out,
                                                               *extra)))


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_chain_matches_jax_engine(scene, mode):
    """Flows from files with one missing (tiled: flow_upload auto, so f32
    at precision 32; fullframe: f16 forced, the rounding done where JAX
    does it), then the broken chain (no flow_dir): each frame within 1
    count of the JAX engine, and the missing flow named in a warning."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    warnings = []  # the JAX engine replaces the root logger's handlers
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    port_log = logging.getLogger("patch_toon_tpu_torch.infer")
    port_log.addHandler(handler)
    flows = [f"inference.temporal.flow_dir={scene / 'flow_bwd'}"]
    if mode == "fullframe":
        flows.append("inference.temporal.flow_upload=f16")
    try:
        for chain, extra in (("flows", flows),
                             ("broken", ["inference.temporal.flow_dir=null"])):
            over = [f"inference.mode={mode}", *extra]
            jax_out = scene / f"jax_{mode}_{chain}"
            port_out = scene / f"port_{mode}_{chain}"
            JaxEngine(jax_compose(REPO / "config", "inference",
                                  overrides=_overrides(scene, jax_out, *over))
                      ).process_directory(progress=False)
            eng = _port(scene, port_out, *over)
            assert eng.temporal_flow_f16 == (mode == "fullframe"
                                             and chain == "flows")
            assert eng.process_directory() == N
            want, got = _read(jax_out), _read(port_out)
            assert len(got) == N and got.keys() == want.keys()
            for name in want:
                d = np.abs(got[name] - want[name])
                assert d.max() <= 1, (mode, chain, name, d.max())
    finally:
        port_log.removeHandler(handler)
    assert [w for w in warnings if f"No flow for frame {MISSING} " in w]


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_loop_equals_direct_chain_steps(scene, tmp_path, mode):
    """``process_directory`` writes exactly what driving ``_chain_step``
    frame by frame gives (the loader's staging, the carry), the carry
    reaches the generator (frame 1 with it differs from a restart), and a
    chain split over two calls continues as one."""
    eng = _port(scene, tmp_path / "loop", f"inference.mode={mode}",
                f"inference.temporal.flow_dir={scene / 'flow_bwd'}")
    assert eng.process_directory() == N
    files = sorted((scene / "input").glob("*.png"))
    loop = _read(tmp_path / "loop")
    direct = _port(scene, tmp_path / "direct", f"inference.mode={mode}",
                   f"inference.temporal.flow_dir={scene / 'flow_bwd'}")
    carry = (None, None)
    for i, p in enumerate(files):
        st = direct._load_for_dispatch(p, scene / "mask",
                                       direct._temporal_position(p.name))
        assert st.position == i and (st.flow is None) == (i == MISSING)
        if i == 1:
            restart = direct._chain_step(st.frame, st.mask, st.boxes,
                                         (None, None), aux=st.flow)[0]
        u8, boxes, carry = direct._chain_step(st.frame, st.mask, st.boxes,
                                              carry, aux=st.flow)
        assert (boxes == []) == (mode == "fullframe")
        np.testing.assert_array_equal(u8.numpy(), loop[p.name], p.name)
        if i == 1:
            assert not torch.equal(u8, restart)
    split = _port(scene, tmp_path / "split", f"inference.mode={mode}",
                  f"inference.temporal.flow_dir={scene / 'flow_bwd'}")
    assert split.process_directory(files=files[:3]) == 3
    assert split.process_directory(files=files[3:]) == 2
    for name, want in _read(tmp_path / "split").items():
        np.testing.assert_array_equal(want, loop[name], name)


@pytest.mark.parametrize("precision,upload,flow_upload", [
    ("bf16", "auto", "auto"), ("32", "auto", "auto"), ("bf16", "f32", "auto"),
    ("32", "u8", "auto"), ("32", "auto", "f16"), ("bf16", "auto", "f32")])
def test_flow_upload_follows_the_jax_rule(scene, tmp_path, precision, upload,
                                          flow_upload):
    """``flow_upload: auto`` rounds flows to f16 unless ``upload`` resolves
    to f32 (as it does under precision 32): the same choice as the JAX
    engine's ``temporal_flow_f16`` for the same configuration."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    over = [f"inference.precision={precision}", f"inference.upload={upload}",
            f"inference.temporal.flow_upload={flow_upload}"]
    want = JaxEngine(jax_compose(REPO / "config", "inference",
                                 overrides=_overrides(scene, tmp_path, *over))
                     ).temporal_flow_f16
    assert _port(scene, tmp_path, *over).temporal_flow_f16 == want


@pytest.mark.parametrize("override,knob", [
    ("inference.temporal.flow_upload=fast", "flow_upload"),
    ("inference.upload=f64", "upload"),
    ("inference.temporal.flow_source=disk", "flow_source"),
    ("inference.temporal.flow_scale=3", "flow_scale"),
    ("inference.temporal.flow_batch=0", "flow_batch")])
def test_temporal_knobs_are_validated(scene, tmp_path, override, knob):
    with pytest.raises(ValueError, match=knob):
        _port(scene, tmp_path, override)


def _device(root, *extra):
    return [f"paths.mask_dir={root / 'mask_ignore'}",
            "inference.temporal.flow_source=device", *extra]


@pytest.mark.parametrize("mode,scale", [("tiled", 1), ("fullframe", 1),
                                        ("fullframe", 2)])
def test_device_flow_chain_matches_jax_engine(scene, tmp_path, mode, scale):
    """``flow_source: device``: each frame within 1 count of the JAX engine
    at ``flow_source: device`` (the flow against the previous frame's
    luma, zeroed outside the raw mask; frame NO_MASK's flow unmasked)."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    over = [f"inference.mode={mode}",
            f"inference.temporal.flow_scale={scale}"]
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=[
        *_overrides(scene, tmp_path / "jax", *over), *_device(scene)])
    ).process_directory(progress=False)
    eng = _port(scene, tmp_path / "port", *over, *_device(scene))
    assert eng.temporal_flow_source == "device"
    assert eng.process_directory() == N
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert len(got) == N and got.keys() == want.keys()
    for name in want:
        d = np.abs(got[name] - want[name])
        assert d.max() <= 1, (mode, scale, name, d.max())
    assert eng._temporal_prev_gray is not None
    assert eng.flow_graphs.captures == 0  # the CPU runs the step eagerly


def test_device_flow_loop_windows_and_split_calls(scene, tmp_path):
    """The device-flow chain through ``process_directory`` writes what
    driving ``_chain_step`` over the engine's own staging gives, bitwise;
    ``flow_batch`` 3 (flows computed ahead) and the chain split over two
    calls (the carry and the luma kept on the engine) write the same
    files; a missing flow mask stages as None and serves the unmasked
    flow (the same step as an all-ones mask)."""
    files = sorted((scene / "input").glob("*.png"))
    runs = {}
    for name, extra, calls in (
            ("one", [], [files]),
            ("batch3", ["inference.temporal.flow_batch=3"], [files]),
            ("split", [], [files[:2], files[2:]])):
        eng = _port(scene, tmp_path / name, "inference.mode=fullframe",
                    *_device(scene, *extra))
        assert sum(eng.process_directory(files=c) for c in calls) == N
        runs[name] = _read(tmp_path / name)
    for name in ("batch3", "split"):
        assert runs[name].keys() == runs["one"].keys()
        for k, want in runs["one"].items():
            np.testing.assert_array_equal(runs[name][k], want, (name, k))
    direct = _port(scene, tmp_path / "direct", "inference.mode=fullframe",
                   *_device(scene))
    carry = (None, None)
    for i, p in enumerate(files):
        st = direct._load_for_dispatch(p, scene / "mask_ignore",
                                       direct._temporal_position(p.name))
        assert st.flow is None and (st.fmask is None) == (i == NO_MASK)
        if st.fmask is not None:
            luma = np.asarray(Image.open(scene / "mask_ignore" / p.name))
            np.testing.assert_array_equal(st.fmask.numpy(), luma > 127)
        if i == NO_MASK:
            ones = torch.ones((H, W), dtype=torch.uint8)
            with_ones = direct._chain_step(st.frame, st.mask, st.boxes,
                                           carry, aux=ones)[0]
        u8, _, carry = direct._chain_step(st.frame, st.mask, st.boxes,
                                          carry, aux=st.fmask)
        np.testing.assert_array_equal(u8.numpy(), runs["one"][p.name])
        if i == NO_MASK:
            assert torch.equal(u8, with_ones)
        assert carry[1].dtype == torch.uint8 and carry[1].shape == (H, W)
