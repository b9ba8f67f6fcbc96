"""The port's sample scene and demo tools against the JAX package's.

``data/sample_scene.py`` must write the pixels (and PNG modes) of
``tools/make_sample_scene.py`` for the same seed and size. The metrics of
``tools/temporal_demo_torch.py`` (flicker, warped and target PSNR through
the port's ``ops/flow.py`` warp) and of ``tools/multistyle_demo_torch.py``
(masked PSNR) must reproduce, to their printed rounding, the JAX demos'
committed figures from the committed frames and flows
(``docs/temporal/temporal_demo.json``, all six sequences;
``docs/multistyle/multistyle.json``, the 3x3 matrix). Each demo tool runs
end to end on the CPU at ``--steps 2`` on a 3-frame 48x64 scene.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import make_sample_scene  # noqa: E402
import multistyle_demo_torch  # noqa: E402
import temporal_demo_torch  # noqa: E402

from patch_toon_tpu_torch.data.sample_scene import make_scene  # noqa: E402

TEMPORAL = REPO / "docs" / "temporal"
MULTISTYLE = REPO / "docs" / "multistyle"


@pytest.mark.parametrize("frames, height, width, seed",
                         [(3, 40, 56, 17), (2, 270, 480, 0)])
def test_sample_scene_pixels_equal_the_jax_tool(tmp_path, frames, height,
                                                width, seed):
    make_scene(str(tmp_path / "port"), frames, height, width, seed)
    make_sample_scene.make_scene(str(tmp_path / "jax"), frames, height,
                                 width, seed)
    files = sorted((tmp_path / "jax").rglob("*.png"))
    assert len(files) == 4 * frames
    for f in files:
        mine = Image.open(tmp_path / "port" / f.relative_to(tmp_path / "jax"))
        theirs = Image.open(f)
        assert mine.mode == theirs.mode, f
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs),
                                      str(f))


@pytest.mark.parametrize("row", temporal_demo_torch.ROWS)
def test_temporal_metrics_reproduce_the_committed_run(row):
    scene = TEMPORAL / "scene"
    names = sorted(p.name for p in (scene / "input").glob("*.png"))
    frames = scene / "input_noisy" if row == "input_floor" \
        else TEMPORAL / f"stylized_{row}"
    want = json.loads((TEMPORAL / "temporal_demo.json").read_text())[row]
    assert temporal_demo_torch.sequence_metrics(frames, scene, names) == want


@pytest.mark.parametrize("name", multistyle_demo_torch.STYLES)
def test_multistyle_matrix_reproduces_the_committed_run(name):
    want = json.loads((MULTISTYLE / "multistyle.json").read_text())
    got = multistyle_demo_torch.psnr_row(MULTISTYLE, name,
                                         MULTISTYLE / f"scene_{name}")
    assert got == want["matrix"][name]


TINY = ["--steps", "2", "--frames", "3", "--height", "48", "--width", "64",
        "--device", "cpu"]


def test_temporal_demo_end_to_end(tmp_path, capsys):
    assert temporal_demo_torch.main([*TINY, "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "temporal_demo.json").read_text())
    for row in temporal_demo_torch.ROWS:
        assert all(np.isfinite(v) for v in got[row].values()), row
        if row != "input_floor":
            assert len(list((tmp_path / f"stylized_{row}").glob(
                "*.png"))) == 3
    assert got["steps"] == 2 and got["device"] == "cpu"
    assert got["jax_run"]["plain"]["flicker_mean_abs"] == 11.162
    report = (tmp_path / "REPORT.md").read_text()
    assert "JAX's run" in report and "s on cpu" in report
    assert "1335" not in report  # no wall time of JAX's run


def test_multistyle_demo_end_to_end(tmp_path, capsys):
    assert multistyle_demo_torch.main([*TINY, "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "multistyle.json").read_text())
    styles = multistyle_demo_torch.STYLES
    assert set(got["matrix"]) == set(styles)
    assert all(np.isfinite(got["matrix"][s][t]) for s in styles
               for t in styles)
    assert isinstance(got["own_style_wins_every_row"], bool)
    assert got["jax_run"]["own_style_wins_every_row"] is True
    assert "The port:" in (tmp_path / "REPORT.md").read_text()
