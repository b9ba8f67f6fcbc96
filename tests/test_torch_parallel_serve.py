"""Serving over several devices and processes: the port against the JAX
package and against its own one-device run, on the CPU.

A ``tools/make_sample_scene.py`` scene of 5 frames (48x72, masks, a 3-band
guide: the generator takes 6 channels) and one torch checkpoint at small
widths, precision 32 for both packages. ``inference.devices=2`` runs two
CPU replicas in the port and a 2-device mesh of the 8 virtual CPU devices
of ``tests/conftest.py`` in JAX; the last group is padded (5 frames, 4 a
device). Tolerances:

- the port at ``devices=2`` against its ``devices=1`` run: bitwise (each
  device's chunk is a one-device group at the same shapes);
- against the JAX engine at ``devices=2``: within 1 uint8 count (fp32
  roundoff, the bar of ``tests/test_torch_engine.py``);
- two ``generator_torch.py`` processes joined by ``parallel.dcn``, and two
  ``file_shard`` engines: the union of their files byte for byte the
  one-process run's.

The rank splits of multi-stream serving and of watch mode are checked with
the process group's rank and world set on ``parallel.comm`` (a group of
processes would add nothing the split reads).
"""

import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from make_sample_scene import make_scene  # noqa: E402

from patch_toon_tpu_torch.config.compose import compose  # noqa: E402
from patch_toon_tpu_torch.config.defaults import INFERENCE  # noqa: E402
from patch_toon_tpu_torch.infer.engine import (  # noqa: E402
    StyleTransferInference,
)
from patch_toon_tpu_torch.infer.tiling import bucket_size  # noqa: E402
from patch_toon_tpu_torch.models.generator import GeneratorJ  # noqa: E402
from patch_toon_tpu_torch.parallel import comm, free_port  # noqa: E402

ARCH = ["model.generator.args.filters=[4,8,8,8,8,4]",
        "model.generator.args.resnet_blocks=1", "data.patch_size=16"]
FRAMES = 5


def _checkpoint(path: pathlib.Path, channels: int, seed: int) -> None:
    torch.manual_seed(seed)
    model = GeneratorJ(input_channels=channels, filters=(4, 8, 8, 8, 8, 4),
                       use_bias=True, resnet_blocks=1)
    with torch.no_grad():  # move off the zero-bias init
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}}, path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_serve")
    make_scene(str(root / "scene"), frames=FRAMES, height=48, width=72,
               seed=7)
    _checkpoint(root / "gen.ckpt", 6, 5)
    return root


def _overrides(root, out, *extra):
    s = root / "scene"
    return [f"paths.checkpoint={root / 'gen.ckpt'}",
            f"paths.input_dir={s / 'input'}", f"paths.mask_dir={s / 'mask'}",
            f"paths.output_dir={out}",
            f"paths.additional_channels.point_vector.path={s / 'tracking'}",
            "inference.use_gpu=false", "inference.precision=32", *ARCH,
            *extra]


def _engine(root, out, *extra):
    return StyleTransferInference(compose(REPO / "config", "inference",
                                          overrides=_overrides(root, out,
                                                               *extra)))


def _read(d):
    return {p.name: np.asarray(Image.open(p)).astype(int)
            for p in sorted(pathlib.Path(d).glob("*.png"))}


def _one_device(scene, mode):
    out = scene / f"one_{mode}"
    if not out.exists():
        assert _engine(scene, out, f"inference.mode={mode}"
                       ).process_directory() == FRAMES
    return out


@pytest.mark.parametrize("mode", ["tiled", "fullframe"])
def test_frame_sharded_serving_matches_jax_and_one_device(scene, mode):
    from patch_toon_tpu.config import compose as jax_compose
    from patch_toon_tpu.infer import StyleTransferInference as JaxEngine

    jax_out, two = scene / f"jax2_{mode}", scene / f"two_{mode}"
    over = (f"inference.mode={mode}", "inference.devices=2")
    JaxEngine(jax_compose(REPO / "config", "inference", overrides=_overrides(
        scene, jax_out, *over))).process_directory(progress=False)
    eng = _engine(scene, two, *over)
    assert [d.type for d in eng.cards] == ["cpu", "cpu"]
    # one replica a device, its weights copied, not aliased
    assert eng.models[0] is not eng.models[1]
    for a, b in zip(eng.models[0].parameters(), eng.models[1].parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert eng.process_directory() == FRAMES
    if mode == "tiled":  # 4 frames a device: card 1 runs the fifth alone
        assert eng._pod_fpd == 4
    one, got, want = (_read(_one_device(scene, mode)), _read(two),
                      _read(jax_out))
    assert len(got) == FRAMES and got.keys() == one.keys() == want.keys()
    for name in got:
        assert np.array_equal(got[name], one[name]), name
        assert np.abs(got[name] - want[name]).max() <= 1, name


def test_sharded_dispatch_pads_and_reads_the_real_frames(scene, tmp_path):
    """A group of 3 staged frames over 2 devices at 2 frames a device:
    card 1 runs frame 2 alone (JAX pads its chunk by repeating frame 2;
    the port runs no repeated frame, so card 1's generator sees frame 2's
    tiles only, in the rows ``pack_rows`` gives them: JAX's bucket at this
    file's precision 32); the outputs are the 3 frames in order, each
    equal to its one-device dispatch."""
    eng = _engine(scene, tmp_path, "inference.devices=2")
    eng._pod_fpd = 2
    files = sorted((scene / "scene" / "input").glob("*.png"))[:3]
    staged = [eng._load_for_dispatch(p, scene / "scene" / "mask",
                                     card=eng.card_of(i))
              for i, p in enumerate(files)]
    rows = []
    hook = eng.models[1].register_forward_pre_hook(
        lambda _m, args: rows.append(int(args[0].shape[0])))
    outs = eng.dispatch_staged(staged)
    hook.remove()
    assert rows == [bucket_size(len(staged[2].boxes))]
    assert len(outs) == 3
    one = _engine(scene, tmp_path)
    want = [one.dispatch_staged(staged[:2]), one.dispatch_staged(staged[2:])]
    assert torch.equal(torch.stack(outs), torch.cat(want))


def test_file_shards_union_is_the_one_process_run(scene, tmp_path):
    out = tmp_path / "sharded"
    for i in range(2):
        n = _engine(scene, out, f"inference.file_shard={i}/2"
                    ).process_directory()
        assert n == len(range(i, FRAMES, 2))
    one = _one_device(scene, "tiled")
    assert sorted(os.listdir(out)) == sorted(os.listdir(one))
    for name in os.listdir(one):
        assert (out / name).read_bytes() == (one / name).read_bytes(), name
    with pytest.raises(ValueError, match="file_shard"):
        _engine(scene, tmp_path, "inference.file_shard=2/2"
                ).process_directory()


def test_two_processes_over_dcn_write_the_one_process_frames(scene,
                                                             tmp_path):
    """Two ``generator_torch.py`` processes with ``parallel.dcn.enabled``
    (gloo, explicit coordinator): each serves the frames of its rank
    (``files[rank::2]``); their union is the one-process run, byte for
    byte."""
    out, one = tmp_path / "dcn", tmp_path / "one"
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}

    def cli(out_dir, *extra):  # the reference runs as a process alike
        return subprocess.Popen(
            [sys.executable, str(REPO / "generator_torch.py"),
             *_overrides(scene, out_dir), *extra], cwd=str(tmp_path),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    procs = [cli(out, "parallel.dcn.enabled=true",
                 f"parallel.dcn.coordinator_address=localhost:{port}",
                 "parallel.dcn.num_processes=2",
                 f"parallel.dcn.process_id={i}") for i in range(2)]
    procs.append(cli(one))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        if i < 2:
            assert f"File shard {i}/2" in log
            assert f"{len(range(i, FRAMES, 2))} frames written" in log
    assert sorted(os.listdir(out)) == sorted(os.listdir(one))
    for name in os.listdir(one):
        d = np.abs(_read(out)[name] - _read(one)[name])
        assert (out / name).read_bytes() == (one / name).read_bytes(), (
            name, int(d.max()), int((d > 0).any(-1).sum()))


def _rank_of(monkeypatch, rank, world):
    monkeypatch.setattr(comm, "rank", lambda: rank)
    monkeypatch.setattr(comm, "world", lambda: world)


def test_temporal_guide_over_processes_serves_from_rank_0(scene, tmp_path,
                                                          monkeypatch):
    _checkpoint(tmp_path / "chain.ckpt", 6, 9)
    over = ("inference.temporal.enabled=true", "paths.additional_channels={}",
            f"paths.checkpoint={tmp_path / 'chain.ckpt'}")
    for rank in (1, 0):
        _rank_of(monkeypatch, rank, 2)
        eng = _engine(scene, tmp_path / "chain", *over)
        assert eng.process_directory() == (FRAMES if rank == 0 else 0)
    # an explicit shard with the temporal guide is refused, as in JAX
    eng = _engine(scene, tmp_path / "chain", *over,
                  "inference.file_shard=0/2")
    with pytest.raises(ValueError, match="temporal"):
        eng.process_directory()
    # multi-stream serving is per device
    (tmp_path / "ms" / "shot").mkdir(parents=True)
    eng = _engine(scene, tmp_path / "out", *over, "inference.devices=2")
    with pytest.raises(ValueError, match="per-device"):
        eng._process_multistream(["shot"], tmp_path / "ms", tmp_path,
                                 tmp_path / "out")


def test_multistream_streams_split_by_rank(scene, tmp_path, monkeypatch):
    """Three shots over two ranks: rank 0 serves shots 0 and 2, rank 1
    shot 1 (``streams[rank::world]``), each under its own name."""
    _checkpoint(tmp_path / "chain.ckpt", 6, 9)
    src = scene / "scene"
    names = sorted(p.name for p in (src / "input").glob("*.png"))[:2]
    for shot in ("a", "b", "c"):
        for sub in ("input", "mask"):
            (tmp_path / sub / shot).mkdir(parents=True)
            for n in names:
                (tmp_path / sub / shot / n).write_bytes(
                    (src / sub / n).read_bytes())
    served = {}
    for rank in (0, 1):
        _rank_of(monkeypatch, rank, 2)
        eng = StyleTransferInference(compose(
            REPO / "config", "inference", overrides=[
                f"paths.checkpoint={tmp_path / 'chain.ckpt'}",
                f"paths.input_dir={tmp_path / 'input'}",
                f"paths.mask_dir={tmp_path / 'mask'}",
                f"paths.output_dir={tmp_path / f'out{rank}'}",
                "paths.additional_channels={}", "inference.use_gpu=false",
                "inference.precision=32", "inference.temporal.enabled=true",
                *ARCH]))
        assert eng.process_directory() == 2 * (2 - rank)
        served[rank] = sorted(p.name for p in (tmp_path / f"out{rank}"
                                               ).iterdir())
    assert served == {0: ["a", "c"], 1: ["b"]}


def test_watch_splits_frames_by_name_crc32(scene, tmp_path, monkeypatch):
    """Flat watch over three ranks: each rank serves the frames whose
    name's CRC-32 modulo 3 is its rank; together every frame once."""
    inp = tmp_path / "input"
    inp.mkdir()
    src = scene / "scene" / "input"
    for p in sorted(src.glob("*.png")):
        (inp / p.name).write_bytes(p.read_bytes())
        os.utime(inp / p.name, (1e9, 1e9))  # settled long ago
    got = {}
    for rank in (0, 1, 2):
        _rank_of(monkeypatch, rank, 3)
        out = tmp_path / f"out{rank}"
        eng = _engine(scene, out, f"paths.input_dir={inp}",
                      "inference.watch.enabled=true",
                      "inference.watch.poll_seconds=0.05",
                      "inference.watch.idle_timeout_seconds=0.3")
        eng.watch_directory()
        got[rank] = sorted(p.name for p in out.glob("*.png"))
    names = sorted(p.name for p in src.glob("*.png"))
    for rank in (0, 1, 2):
        assert got[rank] == [n for n in names
                             if zlib.crc32(n.encode()) % 3 == rank]
    assert sorted(got[0] + got[1] + got[2]) == names
    assert got[0] and got[2]  # 002.png is rank 2's, the rest rank 0's


def test_inference_parallel_defaults_equal_the_yaml():
    """``config/defaults.py`` keeps the multi-device keys of
    ``config/inference.yaml`` and ``config/parallel/default.yaml``."""
    want = compose(REPO / "config", "inference")
    assert INFERENCE["parallel"] == want["parallel"]
    for key in ("devices", "file_shard"):
        assert INFERENCE["inference"][key] == want["inference"][key]
