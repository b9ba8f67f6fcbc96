"""Multi-stream temporal serving (``infer/multistream.py``) on the CPU.

Mirrors the JAX package's tests/test_temporal.py:738-925: a subdirectory
per video under ``paths.input_dir`` (masks under ``paths.mask_dir/<stream>``,
flow files under ``temporal.flow_dir/<stream>``, outputs under
``paths.output_dir/<stream>``), each cycle co-batching every live stream's
next frame in one generator dispatch. Tolerances: each stream within 1
uint8 count of the same stream served alone as a single-stream chain (the
generator's batch differs, and the CPU's convolutions may round another
batch size differently), bitwise where the cycle is that stream's alone;
within 1 count of the JAX engine's multi-stream run; ``flow_batch`` 3 and
the watched run bitwise equal to the one-shot run. Watch runs wait on no
clock: mtimes are set in the past, polls are 0.05 s, idle timeouts 0.3 s.
"""

import os
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch
from PIL import Image

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.infer.engine import StyleTransferInference
from patch_toon_tpu_torch.models.generator import GeneratorJ

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W = 40, 56
LENGTHS = {"a": 3, "b": 3, "c": 5}  # c chains alone once a and b end
WATCH = ["inference.watch.enabled=true", "inference.watch.poll_seconds=0.05",
         "inference.watch.idle_timeout_seconds=0.3"]


def _age(root):
    t = time.time() - 10
    for f in pathlib.Path(root).rglob("*"):
        os.utime(f, (t, t))


def _stream(root, name, seed, n):
    """A moving block under root/input/<name>, masks (a box of 255, a band
    of 128 that only the flow mask keeps) under root/mask/<name>, seeded
    smooth backward flows under root/flows/<name>."""
    rng = np.random.default_rng(seed)
    for sub in ("input", "mask", "flows"):
        (root / sub / name).mkdir(parents=True, exist_ok=True)
    bg = (rng.random((H, W, 3)) * 160).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[4:36, 4:48] = 255
    mask[4:36, 48:52] = 128
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(n):
        frame = bg.copy()
        frame[10:26, 4 + 4 * i:16 + 4 * i] = (rng.random(3) * 100 + 155
                                              ).astype(np.uint8)
        Image.fromarray(frame).save(root / "input" / name / f"{i:03d}.png")
        Image.fromarray(mask).save(root / "mask" / name / f"{i:03d}.png")
        np.save(root / "flows" / name / f"{i:03d}.npy", np.stack(
            [-4.0 + np.sin(yy / 7 + seed), 0.5 * np.cos(xx / 9 + i)],
            -1).astype(np.float32))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multistream")
    for k, (name, n) in enumerate(LENGTHS.items()):
        _stream(root / "ms", name, 20 + k, n)
    torch.manual_seed(16)
    model = GeneratorJ(input_channels=6, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}},
               root / "gen.ckpt")
    return root


def _over(root, inp, mask, out, *extra):
    return [f"paths.checkpoint={root / 'gen.ckpt'}", f"paths.input_dir={inp}",
            f"paths.mask_dir={mask}", f"paths.output_dir={out}",
            "paths.additional_channels={}", "data.patch_size=16",
            "inference.use_gpu=false", "inference.precision=32",
            "inference.temporal.enabled=true", "inference.temporal.depth=3",
            "model.generator.args.resnet_blocks=1",
            "model.generator.args.filters=[4,8,8,8,8,4]", *extra]


def _port(root, inp, mask, out, *extra):
    return StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=_over(root, inp, mask,
                                                          out, *extra)))


def _jax(root, inp, mask, out, *extra):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_over(
        root, inp, mask, out, *extra))).process_directory(progress=False)


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


DEVICE = ["inference.temporal.flow_source=device"]


def test_temporal_flow_pairs_match_jax():
    """The cycle's flows of three independent pairs (smooth frames moving
    by (3, -2) px, one pair without a mask) against JAX's jitted
    ``_temporal_flow_pairs`` (a missing mask an all-ones plane there): the
    luma bitwise, each flow within the smooth-frame bar of
    tests/test_torch_flow.py (2e-5 px max); and each pair bitwise the
    single-pair flow step."""
    import jax.numpy as jnp

    from patch_toon_tpu.infer.temporal import (
        _device_gray as jax_gray,
        _temporal_flow_pairs as jax_pairs,
    )
    from patch_toon_tpu_torch.infer.temporal import (
        _temporal_device_flow,
        _temporal_flow_pairs,
    )
    from patch_toon_tpu_torch.ops.resize import resize_bilinear_np

    rng = np.random.default_rng(9)
    frames, prevs, masks = [], [], []
    for k in range(3):
        coarse = rng.random((14, 18, 3)).astype(np.float32) * 255
        big = resize_bilinear_np(coarse, (80, 112)).astype(np.uint8)
        frames.append(np.ascontiguousarray(big[4:68, 4:100]))
        prevs.append(np.array(jax_gray(jnp.asarray(big[6:70, 1:97]))))
        mask = np.zeros((64, 96), np.uint8)
        mask[8:56, 10:90] = 1
        masks.append(None if k == 1 else mask)
    ones = np.ones((64, 96), np.uint8)
    want_f, want_g = jax_pairs(
        jnp.asarray(np.stack(frames)), jnp.asarray(np.stack(prevs)),
        jnp.asarray(np.stack([ones if m is None else m for m in masks])), 1)
    t = [torch.from_numpy(a) for a in frames]
    tp = [torch.from_numpy(a) for a in prevs]
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    flows, grays = _temporal_flow_pairs(t, tp, tm, 1)
    for k in range(3):
        np.testing.assert_array_equal(grays[k].numpy(),
                                      np.asarray(want_g[k]))
        d = np.abs(flows[k].numpy() - np.asarray(want_f[k]))
        assert d.max() <= 2e-5, (k, d.max())
        one = _temporal_device_flow(t[k], tp[k], tm[k], 1)
        assert torch.equal(one[0], flows[k]) and torch.equal(one[1],
                                                             grays[k])


def test_multistream_matches_single_streams_and_jax(streams, tmp_path):
    """Device flow: each stream within 1 count of the same stream served
    alone (bitwise in the cycles it has to itself) and of the JAX engine's
    multi-stream run; ``flow_batch`` 3 (a cycle's flows first, one replay a
    stream) bitwise equal to 1."""
    ms = streams / "ms"
    eng = _port(streams, ms / "input", ms / "mask", tmp_path / "ms", *DEVICE)
    assert eng._detect_streams(ms / "input") == sorted(LENGTHS)
    assert eng.process_directory() == sum(LENGTHS.values())
    _jax(streams, ms / "input", ms / "mask", tmp_path / "jax", *DEVICE)
    _port(streams, ms / "input", ms / "mask", tmp_path / "fb3", *DEVICE,
          "inference.temporal.flow_batch=3").process_directory()
    for name, n in LENGTHS.items():
        solo = _port(streams, ms / "input" / name, ms / "mask" / name,
                     tmp_path / f"solo_{name}", *DEVICE)
        assert solo.process_directory() == n
        got = _read(tmp_path / "ms" / name)
        want, jax_out = _read(tmp_path / f"solo_{name}"), _read(
            tmp_path / "jax" / name)
        fb3 = _read(tmp_path / "fb3" / name)
        assert len(got) == n and got.keys() == want.keys() == jax_out.keys()
        for i, k in enumerate(sorted(got)):
            assert np.abs(got[k] - want[k]).max() <= 1, (name, k)
            assert np.abs(got[k] - jax_out[k]).max() <= 1, (name, k)
            np.testing.assert_array_equal(fb3[k], got[k], (name, k))
            if name == "c" and i >= LENGTHS["a"]:  # c's cycles alone
                np.testing.assert_array_equal(got[k], want[k], (name, k))


def test_multistream_files_flow_and_detection(streams, tmp_path, caplog):
    """Files-mode flows resolve per stream (``flow_dir/<stream>/``), a
    missing one holding that stream's previous output (warned by name);
    the flat layout detects no streams; each stream within 1 count of its
    single-stream chain and of the JAX engine."""
    ms = tmp_path / "ms"
    shutil.copytree(streams / "ms", ms)
    (ms / "flows" / "b" / "001.npy").unlink()
    files = ["inference.temporal.flow_upload=f32",
             f"inference.temporal.flow_dir={ms / 'flows'}"]
    eng = _port(streams, ms / "input", ms / "mask", tmp_path / "ms_out",
                *files)
    assert eng._detect_streams(ms / "input" / "a") == []
    eng.process_directory()
    assert "No flow for frame b/001.png" in caplog.text
    _jax(streams, ms / "input", ms / "mask", tmp_path / "jax", *files)
    for name in LENGTHS:
        _port(streams, ms / "input" / name, ms / "mask" / name,
              tmp_path / f"solo_{name}", "inference.temporal.flow_upload=f32",
              f"inference.temporal.flow_dir={ms / 'flows' / name}"
              ).process_directory()
        got = _read(tmp_path / "ms_out" / name)
        want = _read(tmp_path / f"solo_{name}")
        jax_out = _read(tmp_path / "jax" / name)
        assert len(got) == LENGTHS[name]
        for k in got:
            assert np.abs(got[k] - want[k]).max() <= 1, (name, k)
            assert np.abs(got[k] - jax_out[k]).max() <= 1, (name, k)


def test_mode_rule_two_streams_tiled_one_stream_fullframe(streams, tmp_path):
    """JAX's rule, kept: in fullframe mode a cycle with two or more live
    streams goes through the tiled multiframe program (``_stylize_group``),
    a cycle with one live stream through ``_stylize_device`` and so the
    full-frame program; the outputs within 1 count of the JAX engine's."""
    ms = streams / "ms"
    eng = _port(streams, ms / "input", ms / "mask", tmp_path / "ms",
                "inference.mode=fullframe", *DEVICE)
    seen, group, device = [], eng._stylize_group, eng._run

    def spy_group(frames, masks, boxes):
        seen.append(("group", frames.shape[0]))
        return group(frames, masks, boxes)

    def spy_run(frames, masks, boxes):
        if frames.shape[0] == 1:
            seen.append(("device", boxes == [[]]))
        return device(frames, masks, boxes)

    eng._stylize_group, eng._run = spy_group, spy_run
    eng.process_directory()
    assert seen == [("group", 3)] * 3 + [("device", True)] * 2
    _jax(streams, ms / "input", ms / "mask", tmp_path / "jax",
         "inference.mode=fullframe", *DEVICE)
    for name in LENGTHS:
        got, want = _read(tmp_path / "ms" / name), _read(
            tmp_path / "jax" / name)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 1, (name, k)


def test_watch_multistream_equals_the_one_shot_run(streams, tmp_path):
    """Watched multi-stream: the first two frames of each stream at start,
    the rest after the first poll's cycles; chains persist across polls,
    so the outputs equal the one-shot multi-stream run's where the cycles
    hold the same streams, and are within 1 count elsewhere."""
    ms = streams / "ms"
    win, wmask = tmp_path / "win", tmp_path / "wmask"
    for name in LENGTHS:
        (win / name).mkdir(parents=True)
        (wmask / name).mkdir(parents=True)
        for i in range(2):
            shutil.copy(ms / "input" / name / f"{i:03d}.png", win / name)
            shutil.copy(ms / "mask" / name / f"{i:03d}.png", wmask / name)
    _age(win)
    _age(wmask)
    _port(streams, ms / "input", ms / "mask", tmp_path / "once",
          *DEVICE).process_directory()
    eng = _port(streams, win, wmask, tmp_path / "wout", *DEVICE, *WATCH)
    runs, inner = [], eng._ms_run_cycles

    def wrapped(infos, *args):
        runs.append({i["name"]: [p.name for p in i["files"]] for i in infos})
        inner(infos, *args)
        if len(runs) == 1:  # the rest arrive
            for name, n in LENGTHS.items():
                for i in range(2, n):
                    for sub, d in (("input", win), ("mask", wmask)):
                        shutil.copy(ms / sub / name / f"{i:03d}.png",
                                    d / name)
            _age(win)
            _age(wmask)

    eng._ms_run_cycles = wrapped
    eng.watch_directory()
    assert len(runs) == 2 and runs[0] == {n: ["000.png", "001.png"]
                                          for n in LENGTHS}
    for name, n in LENGTHS.items():
        got, want = _read(tmp_path / "wout" / name), _read(
            tmp_path / "once" / name)
        assert sorted(got) == [f"{i:03d}.png" for i in range(n)]
        for k in got:
            assert np.abs(got[k] - want[k]).max() <= 1, (name, k)


def test_watch_multistream_blocked_stream_does_not_stall_others(streams,
                                                                 tmp_path):
    """A frame whose mask never comes blocks its own stream (chain order)
    and no other; the loop stops by its idle timeout."""
    ms = tmp_path / "ms"
    shutil.copytree(streams / "ms", ms)
    (ms / "mask" / "a" / "001.png").unlink()
    _age(ms)
    eng = _port(streams, ms / "input", ms / "mask", tmp_path / "out",
                *DEVICE, *WATCH)
    eng.watch_directory()
    out = tmp_path / "out"
    assert sorted(p.name for p in (out / "a").glob("*.png")) == ["000.png"]
    for name in ("b", "c"):
        assert len(list((out / name).glob("*.png"))) == LENGTHS[name]
