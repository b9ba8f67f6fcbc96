"""Importing the harness, its drivers, readers and references loads no JAX
and nothing of the JAX package (compared by whole top-level names)."""

import subprocess
import sys

import portbench_testing as pt

SCRIPT = f"""
import sys, glob, importlib
sys.path[:0] = [{str(pt.BENCH)!r}, {str(pt.ROOT)!r}]
from pbench import harness, plain, scene, trace, counts, pngio, weights, faults
from pbench.drivers import serve_directory, fit
for f in glob.glob({str(pt.BENCH / 'metrics' / '*.py')!r}) + \\
        glob.glob({str(pt.BENCH / 'configs' / '*.py')!r}):
    harness.load_file_module(__import__('pathlib').Path(f), 'm')
import patch_toon_tpu_torch.infer.engine, patch_toon_tpu_torch.train.loop
print(harness.forbidden_modules())
"""


def test_no_jax_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    assert "patch_toon_tpu_torch".split(".")[0] not in pt.harness.FORBIDDEN
    assert "patch_toon_tpu" in pt.harness.FORBIDDEN
