"""Every cell and metric of BENCHMARK.json resolves to its files by name,
and the file keeps to the contract's forms."""

import re

import portbench_testing as pt
import pytest
from pbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    b = pt.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                            b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        for w in m.get("workloads", []):  # the cell reports what it moves
            assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("workload", [pt.SERVE, pt.CHAIN, pt.TRAIN, pt.DP4])
def test_cell_resolves(workload):
    res = pt.resolve(workload)
    assert res["reference"].exists()
    assert res["traffic"]["driver"] in ("serve_directory", "fit")
    assert res["limits"]["checks"]
    kinds = [m["name"] for m in res["metrics"]]
    # a planned cell (pt.PLANNED) has no metrics of its own yet
    listed = workload in {w["name"] for w in pt.bench()["workloads"]}
    assert "setup_s" in kinds and (len(kinds) >= 3 or not listed)
    for m in res["metrics"]:
        reader = harness.load_file_module(
            harness.BENCH_DIR / "metrics" / f"{m['name']}.py", "t_reader")
        assert callable(reader.read)


def test_chips():
    b = pt.bench()
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for w in four:  # a four-card cell runs ranks over its cards
        t = harness.resolve(b, w["name"])["traffic"]
        assert int(t["training"]["devices"]) == 4


def test_every_config_used_and_unreduced():
    b = pt.bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["reduced"] == [] and c["file"].startswith("portbench/")

