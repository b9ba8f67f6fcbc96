"""A tiny CPU rehearsal of each cell goes through set-up, the window, the
comparison and the last line, and prints no metric; the command itself
refuses to run, and prints nothing, without a card."""

import json
import os
import subprocess
import sys

import portbench_testing as pt
import pytest
from pbench import harness


@pytest.mark.parametrize("workload,trace", [(pt.SERVE, 0), (pt.CHAIN, 1),
                                            (pt.TRAIN, 1), (pt.DP4, 1)])
def test_rehearsal(workload, trace):
    line = harness.rehearse(pt.tiny(workload), seed=2**31 + 11, seconds=0.5,
                            trace=trace)
    assert line["correct"] is True
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(
        pt.resolve(workload)["limits"]["checks"])
    json.dumps(line)


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(pt.BENCH / "run.py"), "--workload", pt.CHAIN,
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=pt.ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
