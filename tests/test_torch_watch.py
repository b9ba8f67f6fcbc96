"""Watch mode (``infer/watch.py``) on the CPU, against one-shot serving and
the JAX engine.

Mirrors the JAX package's watch tests (tests/test_inference.py:424 and
:520, tests/test_round4.py:247, tests/test_temporal.py:579) without waiting
on the clock: every file's mtime is set in the past (``os.utime``), so
nothing waits to settle; polls are 0.05 s and idle timeouts 0.3 s; frames
"arrive" from a wrapper of the engine's own ``process_directory`` (or of
``_aux_ready``) between polls, and every loop ends by its idle timeout or
an injected interrupt. Tolerances: the watched outputs bitwise equal to a
one-shot run of the same engine where the frames are served in the same
groups, else within 1 uint8 count (per-tile math does not depend on the
co-batching, but the CPU's convolutions may round another batch size
differently), and within 1 count of the JAX engine's one-shot run.
"""

import logging
import os
import pathlib
import shutil
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.models.generator import GeneratorJ

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]
WATCH = ["inference.watch.enabled=true", "inference.watch.poll_seconds=0.05",
         "inference.watch.idle_timeout_seconds=0.3"]


def _age(*paths):
    """mtime 10 s in the past: settled at once."""
    t = time.time() - 10
    for p in paths:
        for f in ([p] if pathlib.Path(p).is_file()
                  else pathlib.Path(p).rglob("*")):
            os.utime(f, (t, t))


def _ckpt(path, channels, seed):
    torch.manual_seed(seed)
    model = GeneratorJ(input_channels=channels, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}}, path)
    return path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_watch")
    make_scene(str(root / "scene"), frames=4, height=48, width=72, seed=12)
    _ckpt(root / "gen.ckpt", 6, 14)
    return root


def _flat(root, inp, out, *extra, mask=None):
    s = root / "scene"
    return compose(REPO / "config", "inference", overrides=[
        f"paths.checkpoint={root / 'gen.ckpt'}", f"paths.input_dir={inp}",
        f"paths.mask_dir={mask or s / 'mask'}", f"paths.output_dir={out}",
        f"paths.additional_channels.point_vector.path={s / 'tracking'}",
        "inference.use_gpu=false", "inference.precision=32", *ARCH, *extra])


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


def _arrivals(eng, waves):
    """Wrap ``eng.process_directory``: after its n-th call, copy wave n's
    files in (aged). -> the list of each call's file names."""
    calls, inner = [], eng.process_directory

    def wrapped(files=None):
        calls.append([p.name for p in files])
        try:
            return inner(files=files)
        finally:
            if len(calls) <= len(waves):
                for src, dst in waves[len(calls) - 1]:
                    shutil.copy(src, dst)
                    _age(dst)

    eng.process_directory = wrapped
    return calls


def test_watch_serves_new_frames(scene, tmp_path):
    """Two frames at start, two more after the first batch: each served
    once, the loop stops by its idle timeout, and the files equal a
    one-shot run of the directory (within 1 count: the batches differ)."""
    src = scene / "scene" / "input"
    names = sorted(p.name for p in src.glob("*.png"))
    inp = tmp_path / "input"
    inp.mkdir()
    for n in names[:2]:
        shutil.copy(src / n, inp / n)
    _age(inp)
    eng = StyleTransferInference(_flat(scene, inp, tmp_path / "out", *WATCH))
    calls = _arrivals(eng, [[(src / n, inp / n) for n in names[2:]]])
    t0 = time.perf_counter()
    eng.watch_directory()
    assert time.perf_counter() - t0 < 30
    assert calls == [names[:2], names[2:]]
    StyleTransferInference(_flat(scene, src, tmp_path / "once")
                           ).process_directory()
    got, want = _read(tmp_path / "out"), _read(tmp_path / "once")
    assert got.keys() == want.keys() == set(names)
    for n in names:
        assert np.abs(got[n] - want[n]).max() <= 1, n


def test_watch_gives_up_after_max_attempts(scene, tmp_path, caplog):
    """A frame that fails to decode, its mask and guide present, is tried
    ``max_attempts`` times and given up; the good frame is served; the
    loop goes idle and stops."""
    src = scene / "scene" / "input"
    good, bad = sorted(p.name for p in src.glob("*.png"))[:2]
    inp = tmp_path / "input"
    inp.mkdir()
    shutil.copy(src / good, inp / good)
    (inp / bad).write_bytes(b"not a png")
    _age(inp)
    eng = StyleTransferInference(_flat(
        scene, inp, tmp_path / "out", *WATCH,
        "+inference.watch.max_attempts=3"))
    calls = _arrivals(eng, [])
    with caplog.at_level(logging.INFO, "patch_toon_tpu_torch.infer"):
        eng.watch_directory()
    assert calls == [[good, bad], [bad], [bad]]
    assert sorted(p.name for p in (tmp_path / "out").glob("*")) == [good]
    assert f"Giving up on {bad} after 3 attempts" in caplog.text


def test_watch_waits_for_late_aux_files(scene, tmp_path, caplog):
    """A frame whose mask and guide are not there yet is not attempted
    (no attempt is counted while it waits) and is warned about once after
    ``aux_warn_seconds``; once they land it is served, and its output is
    the one-shot run's."""
    s = scene / "scene"
    first, second = sorted(p.name for p in (s / "input").glob("*.png"))[:2]
    inp, mask = tmp_path / "input", tmp_path / "mask"
    inp.mkdir()
    mask.mkdir()
    for n in (first, second):
        shutil.copy(s / "input" / n, inp / n)
    shutil.copy(s / "mask" / first, mask / first)
    _age(inp, mask)
    eng = StyleTransferInference(_flat(
        scene, inp, tmp_path / "out", *WATCH,
        "+inference.watch.aux_warn_seconds=0", mask=mask))
    calls = _arrivals(eng, [])
    checks, ready = [], eng._aux_ready

    def late_aux(p, *args):
        checks.append(p.name)
        if checks.count(second) == 4:  # the producer catches up
            shutil.copy(s / "mask" / second, mask / second)
        return ready(p, *args)

    eng._aux_ready = late_aux
    with caplog.at_level(logging.INFO, "patch_toon_tpu_torch.infer"):
        eng.watch_directory()
    assert calls == [[first], [second]]
    warned = [r for r in caplog.records if "still missing" in r.getMessage()]
    assert len(warned) == 1 and second in warned[0].getMessage()
    StyleTransferInference(_flat(scene, inp, tmp_path / "once",
                                 mask=mask)).process_directory()
    got, want = _read(tmp_path / "out"), _read(tmp_path / "once")
    assert got.keys() == want.keys() == {first, second}
    for n in got:
        np.testing.assert_array_equal(got[n], want[n], n)


N, H, W = 5, 40, 56


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A temporal scene: N frames of a moving block, full masks, seeded
    smooth backward flows, a checkpoint taking 3 + 3 channels."""
    root = tmp_path_factory.mktemp("torch_watch_chain")
    rng = np.random.default_rng(5)
    for sub in ("input", "mask", "flow_bwd"):
        (root / sub).mkdir()
    bg = (rng.random((H, W, 3)) * 160).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(N):
        frame = bg.copy()
        frame[12:28, 4 + 5 * i:18 + 5 * i] = 220
        Image.fromarray(frame).save(root / "input" / f"{i:03d}.png")
        Image.fromarray(np.full((H, W), 255, np.uint8)).save(
            root / "mask" / f"{i:03d}.png")
        np.save(root / "flow_bwd" / f"{i:03d}.npy", np.stack(
            [-5.0 + np.sin(yy / 7 + i), 0.5 * np.cos(xx / 9)], -1).astype(
                np.float32))
    _ckpt(root / "gen.ckpt", 6, 15)
    return root


def _chain_over(root, inp, mask, out, *extra):
    return [f"paths.checkpoint={root / 'gen.ckpt'}", f"paths.input_dir={inp}",
            f"paths.mask_dir={mask}", f"paths.output_dir={out}",
            "paths.additional_channels={}", "inference.use_gpu=false",
            "inference.precision=32", "inference.temporal.enabled=true",
            f"inference.temporal.flow_dir={root / 'flow_bwd'}", *ARCH,
            *extra]


def _chain_engine(root, inp, mask, out, *extra):
    return StyleTransferInference(compose(
        REPO / "config", "inference",
        overrides=_chain_over(root, inp, mask, out, *extra)))


def test_temporal_watch_chain_equals_the_one_shot_chain(chain, tmp_path):
    """The chain watched in waves, frame 2's mask late (it blocks frames 3
    and 4 behind it, as chain order asks), bitwise equal to the one-shot
    chain of the same engine and within 1 count of the JAX engine's; a
    restarted service over the half-served directory keeps the stream
    positions its outputs prove (flow files by position)."""
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    names = [f"{i:03d}.png" for i in range(N)]
    inp, mask = tmp_path / "input", tmp_path / "mask"
    inp.mkdir()
    mask.mkdir()
    for n in names[:2]:
        shutil.copy(chain / "input" / n, inp / n)
        shutil.copy(chain / "mask" / n, mask / n)
    _age(inp, mask)
    eng = _chain_engine(chain, inp, mask, tmp_path / "out", *WATCH)
    calls = _arrivals(eng, [[(chain / "input" / n, inp / n)
                             for n in names[2:]]
                            + [(chain / "mask" / n, mask / n)
                               for n in names[3:]]])
    checks, ready = [], eng._aux_ready

    def late_mask(p, *args):
        checks.append(p.name)
        if checks.count("002.png") == 3:
            shutil.copy(chain / "mask" / "002.png", mask / "002.png")
            _age(mask / "002.png")
        return ready(p, *args)

    eng._aux_ready = late_mask
    eng.watch_directory()
    assert calls == [names[:2], names[2:]]
    assert checks.count("003.png") == 1  # waited behind 002 until it came
    once = _chain_engine(chain, chain / "input", chain / "mask",
                         tmp_path / "once")
    assert once.process_directory() == N
    got, want = _read(tmp_path / "out"), _read(tmp_path / "once")
    assert got.keys() == want.keys() == set(names)
    for n in names:
        np.testing.assert_array_equal(got[n], want[n], n)
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_chain_over(
        chain, chain / "input", chain / "mask", tmp_path / "jax"))
    ).process_directory(progress=False)
    jax_out = _read(tmp_path / "jax")
    for n in names:
        assert np.abs(got[n] - jax_out[n]).max() <= 1, n
    # a restart: outputs 0-1 on disk register positions 0 and 1
    for n in names[2:]:
        (tmp_path / "out" / n).unlink()
    again = _chain_engine(chain, inp, mask, tmp_path / "out", *WATCH)
    positions = []
    load = again._load_for_dispatch

    def noted(path, mask_dir, position=None):
        positions.append((path.name, position))
        return load(path, mask_dir, position)

    again._load_for_dispatch = noted
    again.watch_directory()
    assert positions == [(n, i) for i, n in enumerate(names)][2:]
    assert sorted(_read(tmp_path / "out")) == names


def test_watch_interrupt_is_graceful(chain, tmp_path, caplog):
    """An interrupt (Ctrl-C, or SIGTERM through the CLI) while the second
    wave's frames are in flight: ``watch_directory`` returns without an
    exception, and every frame dispatched before it is on disk, equal to
    the one-shot chain's."""
    names = [f"{i:03d}.png" for i in range(N)]
    inp = tmp_path / "input"
    inp.mkdir()
    for n in names[:2]:
        shutil.copy(chain / "input" / n, inp / n)
    _age(inp)
    eng = _chain_engine(chain, inp, chain / "mask", tmp_path / "out", *WATCH)
    _arrivals(eng, [[(chain / "input" / n, inp / n) for n in names[2:]]])
    load = eng._load_for_dispatch

    def interrupting(path, mask_dir, position=None):
        if path.name == "004.png":
            raise KeyboardInterrupt
        return load(path, mask_dir, position)

    eng._load_for_dispatch = interrupting
    with caplog.at_level(logging.INFO, "patch_toon_tpu_torch.infer"):
        eng.watch_directory()  # returns: no exception
    assert "Watch interrupted" in caplog.text
    got = _read(tmp_path / "out")
    assert sorted(got) == names[:4]
    _chain_engine(chain, chain / "input", chain / "mask",
                  tmp_path / "once").process_directory()
    want = _read(tmp_path / "once")
    for n in got:
        np.testing.assert_array_equal(got[n], want[n], n)
