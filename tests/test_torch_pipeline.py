"""The port's streaming ``process_directory`` on the CPU.

A ``tools/make_sample_scene.py`` scene (RGB frames, masks and a 3-band
tracking guide) and a small torch checkpoint, precision 32. The pipelined
run must write exactly the files of ``stylize_group`` run group by group
(bitwise), and agree with the JAX engine within 1 uint8 count (fp32
roundoff, as ``test_torch_engine.py``). The failure paths follow the JAX
engine: a shape change flushes the group, a bad file is named and skipped,
a failed dispatch drops and names its group, and an interrupt from the
loader leaves every dispatched frame on disk or in the log.
"""

import logging
import pathlib
import shutil
import sys
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.infer.common import HostSpans  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.models.generator import GeneratorJ  # noqa: E402
from patch_toon_tpu_torch.native import decode_png, encode_png  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]
N_FRAMES = 7


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    make_scene(str(root / "scene"), frames=N_FRAMES, height=48, width=72,
               seed=4)
    torch.manual_seed(6)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, root / "gen.ckpt")
    return root


def _overrides(root, out, scene_dir=None):
    s = scene_dir or root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32", *ARCH]


def _engine(root, out, *extra, scene_dir=None):
    cfg = compose(REPO / "config", "inference",
                  overrides=_overrides(root, out, scene_dir) + list(extra))
    return StyleTransferInference(cfg)


def _names(scene):
    return sorted(p.name for p in (scene / "scene" / "input").glob("*.png"))


def _read(d):
    return {p.name: decode_png(p) for p in sorted(pathlib.Path(d).glob(
        "[!d]*.png"))}


def _by_groups(eng, scene_dir, names, sizes):
    """stylize_group over consecutive groups of ``sizes`` frames."""
    out, i = {}, 0
    for n in sizes:
        chunk = names[i:i + n]
        frames = np.stack([eng.load_frame(scene_dir / "input" / c)
                           for c in chunk])
        masks = [eng.load_eroded_mask(scene_dir / "mask" / c,
                                      frames.shape[1:3]) for c in chunk]
        out.update(zip(chunk, eng.stylize_group(frames, masks)))
        i += n
    return out


def _record_groups(eng):
    """Wrap the engine's dispatch to record each group's frame names."""
    groups = []
    dispatch = eng.dispatch_staged

    def noted(group):
        groups.append([s.path.name for s in group])
        return dispatch(group)

    eng.dispatch_staged = noted
    return groups


@pytest.mark.parametrize("fpd", ["auto", 2])
def test_pipeline_equals_stylize_group_bitwise(scene, tmp_path, fpd):
    eng = _engine(scene, tmp_path / "out",
                  f"+inference.frames_per_dispatch={fpd}")
    groups = _record_groups(eng)
    assert eng.process_directory() == N_FRAMES
    sizes = [len(g) for g in groups]
    assert sum(sizes) == N_FRAMES and len(sizes) > 1
    if fpd == 2:
        assert sizes == [2, 2, 2, 1]
    got = _read(tmp_path / "out")
    want = _by_groups(eng, scene / "scene", sorted(got), sizes)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_pipeline_within_one_count_of_jax_engine(scene, tmp_path):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    over = _overrides(scene, tmp_path / "jax", None)
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=over)
              ).process_directory(progress=False)
    assert _engine(scene, tmp_path / "port").process_directory() == N_FRAMES
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == N_FRAMES
    for name in want:
        d = np.abs(got[name].astype(int) - want[name].astype(int))
        assert d.max() <= 1, name


def _two_shape_scene(scene, tmp_path):
    """Frames 0-2 of the scene at 48x72, then 3-5 cropped to 40x64."""
    src, dst = scene / "scene", tmp_path / "mixed"
    names = sorted(p.name for p in (src / "input").glob("*.png"))[:6]
    for sub in ("input", "mask", "tracking"):
        (dst / sub).mkdir(parents=True)
        for i, name in enumerate(names):
            arr = decode_png(src / sub / name)
            encode_png(dst / sub / name, arr[:40, :64] if i >= 3 else arr)
    return dst, names


def test_shape_change_flushes_the_group(scene, tmp_path):
    mixed, names = _two_shape_scene(scene, tmp_path)
    eng = _engine(scene, tmp_path / "out", scene_dir=mixed)
    groups = _record_groups(eng)
    assert eng._group_size(30) > 3  # auto would hold more than 3 frames
    assert eng.process_directory() == 6
    assert groups == [names[:3], names[3:]]
    got = _read(tmp_path / "out")
    want = _by_groups(eng, mixed, names, [3, 3])
    for name in names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got[names[3]].shape == (40, 64, 3)


def test_bad_files_are_named_and_skipped(scene, tmp_path, caplog):
    names = _names(scene)
    bad = tmp_path / "input"
    shutil.copytree(scene / "scene" / "input", bad)
    (bad / names[1]).write_bytes(b"not a png")
    data = (bad / names[4]).read_bytes()
    (bad / names[4]).write_bytes(data[: len(data) // 2])  # truncated
    eng = _engine(scene, tmp_path / "out")
    eng.cfg["paths"]["input_dir"] = str(bad)
    with caplog.at_level(logging.ERROR):
        assert eng.process_directory() == N_FRAMES - 2
    assert names[1] in caplog.text and names[4] in caplog.text
    assert sorted(_read(tmp_path / "out")) == [
        n for i, n in enumerate(names) if i not in (1, 4)]


def test_failed_dispatch_drops_and_names_its_group(scene, tmp_path, caplog):
    names = _names(scene)
    eng = _engine(scene, tmp_path / "out", "+inference.frames_per_dispatch=3")
    dispatch = eng.dispatch_staged

    def flaky(group):
        if any(s.path.name == names[4] for s in group):
            raise RuntimeError("device lost")
        return dispatch(group)

    eng.dispatch_staged = flaky
    with caplog.at_level(logging.ERROR):
        assert eng.process_directory() == N_FRAMES - 3
    dropped = [r.getMessage() for r in caplog.records
               if "Dispatch failed" in r.getMessage()]
    assert len(dropped) == 1
    for name in names[3:6]:
        assert name in dropped[0]
    assert sorted(_read(tmp_path / "out")) == names[:3] + names[6:]


@pytest.mark.parametrize("k", [1, 2])
def test_interrupt_from_the_loader_drains_every_dispatched_frame(
        scene, tmp_path, caplog, k):
    """Counterpart of tests/test_round4.py::
    test_process_directory_interrupt_flushes: the loader raises
    KeyboardInterrupt at the first frame after k groups of 2, with a
    frame of group k + 1 already taken; every frame taken before it is on
    disk, right, or named in the log."""
    eng = _engine(scene, tmp_path / "out", "+inference.frames_per_dispatch=2",
                  "inference.readback_streams=1")  # a window of 3 frames
    load = eng._load_for_dispatch
    names = _names(scene)
    stop = names[2 * k + 1]

    def interrupting(path, mask_dir):
        if path.name == stop:
            raise KeyboardInterrupt
        return load(path, mask_dir)

    eng._load_for_dispatch = interrupting
    with caplog.at_level(logging.ERROR):
        with pytest.raises(KeyboardInterrupt):
            eng.process_directory()
    got = _read(tmp_path / "out")
    assert sorted(got) == names[:2 * k]
    assert names[2 * k] in caplog.text  # taken, not dispatched
    want = _by_groups(eng, scene / "scene", sorted(got), [2] * k)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_debug_overlay_equals_jax(scene, tmp_path):
    """debug_mode writes debug_<name> with the tile boxes outlined, pixel
    for pixel as the JAX engine's overlay (PIL's rectangles) of the same
    frame and boxes."""
    from patch_toon_tpu.infer.engine import StyleTransferInference as JaxEng

    eng = _engine(scene, tmp_path / "out", "inference.debug_mode=true")
    assert eng.process_directory() == N_FRAMES
    src = scene / "scene"
    for name in (_names(scene)[0], _names(scene)[-1]):
        out = decode_png(tmp_path / "out" / name)
        frame = eng.load_frame(src / "input" / name)
        mask = eng.load_eroded_mask(src / "mask" / name, frame.shape[:2])
        fake = types.SimpleNamespace(patch_positions=eng.boxes_for(
            mask, frame.shape[:2]))
        JaxEng._save_debug_overlay(fake, out, str(tmp_path / name))
        want = np.asarray(Image.open(tmp_path / f"debug_{name}"))
        got = decode_png(tmp_path / "out" / f"debug_{name}")
        np.testing.assert_array_equal(got, want)
        assert (got != out).any()


def test_host_spans_count_every_thread():
    """HostSpans under contention: 24 threads (more than the cores) with a
    short switch interval; no call or second is lost."""
    spans = HostSpans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(300):
                with spans("host/a"):
                    pass
                with spans("host/b"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = spans.snapshot()
    assert snap["host/a"]["calls"] == snap["host/b"]["calls"] == 24 * 300
    assert snap["host/a"]["ms"] > 0
    spans.reset()
    assert spans.snapshot() == {}
