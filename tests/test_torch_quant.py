"""The port's w8a8 int8 serving against the JAX package's (CPU).

``inference.quantize: int8``: JAX's ``QuantConv`` (patch_toon_tpu/models/
layers.py:165-251) against the port's ``QuantConv2d`` and the plain
versions of ``ops/quant.py``, run as ``tests/test_quant.py`` runs JAX.
Inputs and weights come from numpy seeds. Tolerances:

- one layer: ``xq``, ``wq`` and the int32 accumulator bit for bit; ``y``
  (JAX's layer applied eagerly, as JAX's tests apply it) within one ulp
  of its type (measured: bitwise; under one jit XLA fuses the epilogue's
  multiply and add into an FMA), the dynamic fallback alike;
- calibration: the calib forward bitwise the fp forward; the scales within
  rtol 1e-5 of JAX's at fp32 (convs summed in other orders);
- the generator at int8 on JAX's scales: max 2e-3, mean 3e-4 on the tanh
  output (a tenth of int8's own error against fp in tests/test_quant.py;
  measured 3.7e-5 max: the fp layers between the int8 convs differ by
  roundoff, so an activation within roundoff of a rounding boundary of
  x / s takes the neighbouring int8 code);
- the engine at precision 32: within 1 count of JAX's int8 inside the
  mask, the input bytes outside it, and above 35 dB masked PSNR against
  the port's own fp run (JAX's bar).
"""

import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu.models import GeneratorJ as JaxGeneratorJ
from patch_toon_tpu.models.layers import QuantConv

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.models.layers import QuantConv2d
from patch_toon_tpu_torch.ops import quant
from patch_toon_tpu_torch.utils.weights import (
    generator_scales_from_jax,
    generator_state_from_jax,
    load_generator_state,
    load_quant_scales,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(filters=[8, 16, 32, 32, 32, 16], use_bias=True, tanh=True,
             append_smoothers=True, resnet_blocks=2,
             norm_layer="instance_norm")
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _jax_int8(x, kernel, bias, a_scale, k, stride, dtype):
    """JAX's QuantConv at int8, applied as tests/test_quant.py applies it
    (eagerly: each step rounded on its own), and its steps (layers.py:
    233-245) under jit -> y, xq, wq and the int32 accumulator."""
    m = QuantConv(features=kernel.shape[-1], kernel_size=k, stride=stride,
                  padding=k // 2, use_bias=True, mode="int8", dtype=dtype)
    y = m.apply({"params": {"kernel": kernel, "bias": bias},
                 "quant": {"a_scale": a_scale}}, x)

    def f(x, kernel, a_scale):
        dyn = jnp.max(jnp.abs(x.astype(jnp.float32)))
        eff = jnp.where(a_scale > 0, a_scale, dyn)
        s = jnp.maximum(eff, 1e-12) / 127.0
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / s),
                      -127, 127).astype(jnp.int8)
        w_amax = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12)
        w_s = w_amax / 127.0
        wq = jnp.round(kernel / w_s).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, wq, (stride, stride), ((k // 2, k // 2),) * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        return xq, wq, acc
    return [np.asarray(y.astype(jnp.float32))] + [
        np.asarray(a) for a in jax.jit(f)(x, kernel, a_scale)]


def _ulps(got, want, dtype):
    """|got - want| in units of the last place of ``want`` in ``dtype``."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mant = 23 if dtype == torch.float32 else 7
    exp = np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
    return np.abs(g - w) / 2.0 ** (exp - mant)


def _layer_case(cin, k, stride, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (2, h, w, cin)).astype(np.float32)
    kernel = (rng.normal(0.0, 0.05, (k, k, cin, 8))).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 8).astype(np.float32)
    return x, kernel, bias


def _port_layer(kernel, bias, k, stride, a_scale, dtype):
    cin = kernel.shape[2]
    layer = QuantConv2d(cin, kernel.shape[3], k, stride=stride,
                        padding=k // 2, bias=True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))))
        layer.bias.copy_(torch.from_numpy(bias))
    layer.quantize_weights()
    layer.quant_mode = "int8"
    layer.a_scale = torch.tensor(np.float32(a_scale))
    layer.calibrated = bool(a_scale > 0)
    return layer.to(dtype)


LAYER_CASES = [(4, 3, 1, 9, 11), (6, 7, 1, 13, 9), (166, 7, 1, 11, 7),
               (32, 3, 2, 13, 15), (6, 3, 2, 10, 7)]


@pytest.mark.parametrize("dtype,case,calibrated", [
    (dtype, case, True) for dtype in (jnp.float32, jnp.bfloat16)
    for case in LAYER_CASES] + [
    (jnp.float32, LAYER_CASES[1], False),
    (jnp.bfloat16, LAYER_CASES[3], False)])
def test_quantconv_matches_jax(dtype, case, calibrated):
    """One layer: xq, wq and the accumulator bitwise, y within one ulp;
    ``calibrated`` False is the never-calibrated dynamic fallback (JAX's
    a_scale of 0, tests/test_review_fixes.py:98)."""
    cin, k, stride, h, w = case
    x, kernel, bias = _layer_case(cin, k, stride, h, w, seed=cin + k)
    a_scale = np.float32(np.abs(x).max() * 0.8) if calibrated \
        else np.float32(0.0)
    xj = jnp.asarray(x).astype(dtype)
    yj, xq_j, wq_j, acc_j = _jax_int8(xj, kernel, bias, jnp.asarray(a_scale),
                                      k, stride, dtype)

    tdt = TORCH_DT[dtype]
    layer = _port_layer(kernel, bias, k, stride, a_scale, tdt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    s = quant.activation_scale(layer.a_scale, xt, layer.calibrated)
    xq = quant.quantize_act(xt, s)
    cp = quant.padded_channels(cin)
    assert xq.shape == (2, h, w, cp) and not xq[..., cin:].any()
    np.testing.assert_array_equal(xq[..., :cin].numpy(), xq_j)
    wq = quant.unpack_weight(layer.wq, k, cp)[:, :cin]
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), wq_j)
    acc = quant.conv_s8(xq, layer.wq, s, layer.w_s, None, k, stride,
                        k // 2, torch.int32)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    with torch.no_grad():
        y = layer(xt.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    y = y.permute(0, 2, 3, 1).float().numpy()
    assert y.shape == yj.shape
    assert _ulps(y, yj, tdt).max() <= 1.0


@pytest.fixture(scope="module")
def calibrated():
    """JAX's generator at the small widths, initialised and calibrated on
    a seeded batch as in tests/test_quant.py, and the port's from the same
    weights."""
    gen = JaxGeneratorJ(input_channels=6, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 48, 48, 6)).astype(np.float32)
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    fp_vars = {"params": v["params"], "batch_stats": v["batch_stats"]}
    calib = gen.clone(quant_mode="calib")  # bitwise the fp forward there
    y_ref, mut = jax.jit(lambda a: calib.apply(
        fp_vars, a, train=False, mutable=["quant"]))(x)
    q = gen.clone(quant_mode="int8")
    y_q = jax.jit(lambda a: q.apply({**fp_vars, "quant": mut["quant"]}, a,
                                    train=False))(x)
    port = GeneratorJ(input_channels=6, **SMALL).eval()
    port.load_state_dict(generator_state_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
        resnet_blocks=2), strict=True)
    port = port.to(memory_format=torch.channels_last)
    return dict(x=x, y_ref=np.asarray(y_ref), y_q=np.asarray(y_q),
                quant=mut["quant"], port=port)


def test_calibration_matches_jax(calibrated):
    port, x = calibrated["port"], torch.from_numpy(calibrated["x"])
    with torch.no_grad():
        y_fp = port(x)
        port.quant_mode = "calib"
        y_calib = port(x)
        port.quant_mode = None
    assert torch.equal(y_calib, y_fp)  # calib is the fp forward, bitwise
    assert np.abs(y_fp.numpy() - calibrated["y_ref"]).max() < 2e-5
    want = generator_scales_from_jax(
        jax.tree_util.tree_map(np.asarray, calibrated["quant"]))
    got = {p: layer.a_scale for p, layer in port.quant_layers().items()}
    # stem, 2 downsamples, 2 x 2 residual convs, 2 upsamples, conv11 and
    # 2 smoothers, under JAX's module paths; not the 1x1 head
    assert len(got) == 12 and set(got) == set(want)
    for p in got:
        assert float(got[p]) > 0
        np.testing.assert_allclose(float(got[p]), float(want[p]), rtol=1e-5)
    for layer in port.quant_layers().values():  # back to uncalibrated
        layer.a_scale = torch.zeros(())


def test_generator_int8_on_jax_scales(calibrated):
    port, x = calibrated["port"], torch.from_numpy(calibrated["x"])
    for layer in port.quant_layers().values():
        layer.quantize_weights()
    load_quant_scales(port, generator_scales_from_jax(
        jax.tree_util.tree_map(np.asarray, calibrated["quant"])))
    port.quant_mode = "int8"
    try:
        with torch.no_grad():
            y = port(x).numpy()
    finally:
        port.quant_mode = None
    err = np.abs(y - calibrated["y_q"])
    assert err.max() < 2e-3 and err.mean() < 3e-4, (err.max(), err.mean())
    # and int8 still tracks the fp output as JAX's test asks
    d = np.abs(y - calibrated["y_ref"])
    assert d.max() < 0.02 and d.mean() < 0.003


def test_state_dict_unchanged_by_int8(tmp_path):
    torch.manual_seed(0)
    model = GeneratorJ(input_channels=6, **SMALL)
    keys = list(model.state_dict())
    for layer in model.quant_layers().values():
        layer.quantize_weights()
    model.quant_mode = "int8"
    assert list(model.state_dict()) == keys
    model.to(torch.bfloat16)
    layer = model.conv11[0]
    assert layer.a_scale.dtype == torch.float32
    assert layer.w_s.dtype == torch.float32 and layer.wq.dtype == torch.int8
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "g.ckpt")
    fresh = GeneratorJ(input_channels=6, **SMALL)
    fresh.load_state_dict(load_generator_state(tmp_path / "g.ckpt"),
                          strict=True)
    with pytest.raises(ValueError, match="quant mode"):
        fresh.quant_mode = "int4"


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_quant.py's scene (3 random 96x128 frames, one rectangle
    mask) and a torch checkpoint of a 3-channel generator."""
    root = tmp_path_factory.mktemp("torch_quant")
    rng = np.random.default_rng(5)
    for sub in ("input", "mask"):
        (root / sub).mkdir()
    h, w = 96, 128
    mask = np.zeros((h, w), np.uint8)
    mask[24:72, 32:96] = 255
    for i in range(3):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "input" / f"{i:03d}.png")
        Image.fromarray(mask).save(root / "mask" / f"{i:03d}.png")
    torch.manual_seed(5)
    model = GeneratorJ(input_channels=3, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, root / "gen.ckpt")
    return root


def _overrides(root, out, *extra):
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={root / 'input'}",
            f"paths.mask_dir={root / 'mask'}", f"paths.output_dir={out}",
            "paths.additional_channels={}", "data.patch_size=16",
            "model.generator.args.filters=[4,8,8,8,8,4]",
            "model.generator.args.resnet_blocks=1",
            "inference.use_gpu=false", "inference.precision=32", *extra]


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(np.int64)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_engine_int8_matches_jax(scene, mode):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    extra = (f"inference.mode={mode}", "inference.quantize=int8")
    jax_out, port_out = scene / f"jax_{mode}", scene / f"port_{mode}"
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_overrides(
        scene, jax_out, *extra))).process_directory(progress=False)
    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=_overrides(
                                             scene, port_out, *extra)))
    assert eng.quantize == "int8" and eng.model.quant_mode == "int8"
    log, level = _Lines(), eng.logger.level
    eng.logger.addHandler(log)
    eng.logger.setLevel(logging.INFO)
    try:
        assert eng.process_directory() == 3
    finally:
        eng.logger.removeHandler(log)
        eng.logger.setLevel(level)
    assert log.lines.count("int8 serving: calibrated 10 activation scales "
                           "on the first frame") == 1
    assert all(layer.calibrated
               for layer in eng.model.quant_layers().values())
    off_out = scene / f"off_{mode}"
    StyleTransferInference(compose(REPO / "config", "inference",
                                   overrides=_overrides(
                                       scene, off_out,
                                       f"inference.mode={mode}"))
                           ).process_directory()
    want, got, off = _read(jax_out), _read(port_out), _read(off_out)
    sel = np.asarray(Image.open(scene / "mask" / "000.png")) > 0
    assert got.keys() == want.keys() == off.keys() and len(got) == 3
    for name in got:
        inp = np.asarray(Image.open(scene / "input" / name))
        assert np.array_equal(got[name][~sel], inp[~sel]), name
        assert np.abs(got[name] - want[name]).max() <= 1, name
        mse = ((got[name] - off[name])[sel] ** 2).mean()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 35.0, name


def test_engine_int8_two_devices_bitwise(scene):
    outs, engines = {}, {}
    for d in (1, 2):
        out = scene / f"dev{d}"
        engines[d] = StyleTransferInference(compose(
            REPO / "config", "inference", overrides=_overrides(
                scene, out, "inference.quantize=w8a8",
                f"inference.devices={d}")))
        assert engines[d].process_directory() == 3
        outs[d] = _read(out)
    assert outs[1].keys() == outs[2].keys()
    for name in outs[1]:
        assert np.array_equal(outs[1][name], outs[2][name]), name
    rep = [m.quant_layers() for m in engines[2].models]
    assert len(rep) == 2
    for p, layer in rep[0].items():
        assert torch.equal(layer.a_scale, rep[1][p].a_scale)
        assert torch.equal(layer.a_scale,
                           engines[1].model.quant_layers()[p].a_scale)
        assert rep[1][p].calibrated


def test_engine_int8_single_image_and_group(scene, tmp_path):
    """The single-frame calls calibrate on their own first frame too."""
    eng = StyleTransferInference(compose(REPO / "config", "inference",
                                         overrides=_overrides(
                                             scene, tmp_path,
                                             "inference.quantize=int8")))
    assert not eng._quant_ready
    frame = eng.load_frame(scene / "input" / "001.png")
    one = eng.process_large_image(frame)
    assert eng._quant_ready and one.shape == (96, 128, 3)
    group = eng.stylize_group(frame[None], [None])
    assert np.array_equal(group[0], one)



# (Cin, Cout, k, stride, H, W) at which tests/test_torch_cuda.py holds the
# card's conv_s8 to the plain version: Cout padded to its N tile (2, 8, 40,
# 96), past one tile (192, 256), Cin 6 and 166, stride 2, odd H and W
CARD_SHAPES = [(40, 8, 3, 1, 7, 5), (32, 40, 3, 1, 9, 11),
               (6, 40, 7, 1, 13, 9), (64, 2, 3, 1, 9, 7),
               (64, 192, 3, 1, 6, 5), (32, 256, 3, 1, 5, 6),
               (192, 96, 3, 1, 7, 9), (64, 128, 3, 2, 9, 7),
               (166, 64, 7, 1, 11, 9), (32, 64, 3, 2, 15, 21)]


@pytest.mark.parametrize("cin,cout,k,stride,h,w", CARD_SHAPES)
def test_plain_accumulator_matches_jax_at_the_card_shapes(cin, cout, k,
                                                          stride, h, w):
    """The plain version that the card's kernel is held to: the packed
    weight unpacks to JAX's int8 weight with zeros past Cin and K, and the
    plain int32 accumulator over it is JAX's int8 convolution bit for
    bit."""
    rng = np.random.default_rng(cin * cout + k)
    x = rng.normal(0.0, 1.0, (2, h, w, cin)).astype(np.float32)
    kernel = rng.normal(0.0, 0.05, (k, k, cin, cout)).astype(np.float32)
    _, xq_j, wq_j, acc_j = _jax_int8(jnp.asarray(x), kernel,
                                     np.zeros(cout, np.float32),
                                     jnp.asarray(np.float32(0.0)), k,
                                     stride, jnp.float32)
    wq, _ = quant.quantize_weight(torch.from_numpy(
        np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))))
    cp = quant.padded_channels(cin)
    wp = quant.pack_weight(wq, cp)
    assert wp.shape == (cout, -(-k * k * cp // quant.KP_ALIGN)
                        * quant.KP_ALIGN)
    assert not wp[:, k * k * cp:].any()
    unpacked = quant.unpack_weight(wp, k, cp)
    assert not unpacked[:, cin:].any()
    np.testing.assert_array_equal(
        unpacked[:, :cin].permute(2, 3, 1, 0).numpy(), wq_j)
    xq = torch.zeros((2, h, w, cp), dtype=torch.int8)
    xq[..., :cin] = torch.from_numpy(xq_j)
    acc = quant.conv_s8_acc_plain(xq, wp, k, stride, k // 2)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
