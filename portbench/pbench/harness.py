"""The harness: one run of one cell, driven by ``BENCHMARK.json`` and the
files it names.

A cell's configuration is ``configs/<file>`` (with its plain reference
module named by its ``reference`` key), its traffic mix
``traffic/<traffic>.json`` (whose ``driver`` names the module of
``pbench/drivers/`` that runs it), the limits of its compared numbers
``limits/<cell>.json``, and each metric a reader ``metrics/<name>.py``
whose ``read(run)`` returns a number or None. A run sets up, measures
for ``--seconds``, checks the outputs against the reference, reads its
metrics, and prints one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "patch_toon_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


class Run:
    """Everything one run knows: its cell, its settings, what the window
    did, the trace summary and the compared numbers."""

    def __init__(self, cell: dict, config: dict, traffic: dict,
                 limits: dict, seed: int, seconds: float, trace: bool,
                 t_start: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.t_start = t_start
        self.device: Any = None
        self.reference: Any = None
        self.scratch: Optional[Path] = None
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.counts: Dict[str, float] = {}
        self.spans: Dict[str, dict] = {}
        self.step_ms: List[float] = []
        self.summary: Optional[dict] = None
        self.checks: Dict[str, float] = {}
        self.info: Dict[str, Any] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.ok = True  # False: an answer missing or malformed
        # the forbidden modules each process the run spawned held
        self.forbidden: Dict[str, List[str]] = {}

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entries and files, found by the names in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    return {"cell": cell, "config": config,
            "reference": BENCH_DIR / "configs" / f"{config['reference']}.py",
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json"),
            "metrics": [m for m in bench["end_to_end"] + bench["per_layer"]
                        if workload in m.get("workloads", [workload])]}


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout; nothing loads JAX."""
    cache = ROOT / ".portbench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, str(cache / sub))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def forbidden_found(run: Run, here: bool) -> Dict[str, List[str]]:
    """The forbidden modules of each process of the run that held any:
    the processes it spawned and, with ``here``, this one."""
    found = dict(run.forbidden)
    if here:
        found["this process"] = forbidden_modules()
    return {k: v for k, v in found.items() if v}


def card_line(device) -> Dict[str, Any]:
    """The card's name, power limit and clocks from ``nvidia-smi``."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": out}


def launch_counts() -> Dict[str, int]:
    """The program's kernel launch counters (``.launches``)."""
    from patch_toon_tpu_torch.ops import blend, instance_norm, quant

    out = {}
    for mod in (instance_norm, blend, quant):
        for name in dir(mod):
            n = getattr(getattr(mod, name), "launches", None)
            if isinstance(n, int):
                out[name] = n
    return out


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = load_file_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                  "portbench_metric_" + m["name"].replace(
                                      ".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def evaluate(run: Run) -> bool:
    """Each compared number against its limit; missing answers fail."""
    ok = run.ok
    for name, limit in run.limits["checks"].items():
        v = run.checks.get(name)
        if v is None or not v == v or v > float(limit):
            ok = False
    return ok


def check_lines(run: Run) -> Dict[str, Dict[str, float]]:
    return {name: {"value": run.checks.get(name, float("nan")),
                   "limit": float(limit)}
            for name, limit in run.limits["checks"].items()}


def execute(res: dict, args, t_start: float, device) -> Run:
    """Set up, measure, check: the run's state, its metrics not read."""
    run = Run(res["cell"], res["config"], res["traffic"], res["limits"],
              args.seed, float(args.seconds), bool(args.trace), t_start)
    run.device = device
    run.reference = load_file_module(res["reference"], "portbench_reference")
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    run.scratch = Path(tempfile.mkdtemp(prefix="portbench_", dir=base))
    try:
        driver = importlib.import_module(
            f"pbench.drivers.{res['traffic']['driver']}")
        driver.run(run)
    finally:
        shutil.rmtree(run.scratch, ignore_errors=True)
        gc.collect()
    return run


def result_line(run: Run, metrics: Dict[str, dict],
                device: Dict[str, Any]) -> Dict[str, Any]:
    """The last line's object; ``checks`` comes last."""
    result: Dict[str, Any] = {
        "correct": evaluate(run), "attempted": run.attempted,
        "failed": run.failed, "metrics": metrics, "device": dict(device)}
    if run.trace and run.summary is not None and run.summary["device_ops"]:
        from pbench.trace import breakdown

        result["device"]["busy_s"] = run.summary["busy_s"]
        result["device"]["window_s"] = run.summary["trace_window_s"]
        result["breakdown"] = breakdown(run.summary)
    result["checks"] = check_lines(run)
    return result


def rehearse(res: dict, seed: int, seconds: float, trace: int
             ) -> Optional[Dict[str, Any]]:
    """A rehearsal on the CPU: set-up, the window, the check and the last
    line, with no metric: a CPU run measures no device. None, as a run
    prints no result, where a process the run spawned held a forbidden
    module (this process is the caller's, and not looked at)."""
    import torch

    prepare_environment()
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    run = execute(res, args, time.perf_counter(), torch.device("cpu"))
    bad = forbidden_found(run, here=False)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return None
    return result_line(run, {}, {"platform": "cpu", "kind": "cpu",
                                 "count": 0, "memory_peak_bytes": 0})


def parse(argv: List[str]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    res = resolve(bench, args.workload)
    prepare_environment()
    import torch

    chips = int(res["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # no CUDA context here before the driver's first use of the card: a
    # driver that spawns ranks leaves card 0 to its rank 0
    device = torch.device("cuda", 0)
    run = execute(res, args, t_start, device)
    wanted = [m for m in res["metrics"]
              if (m in bench["per_layer"]) == bool(args.trace)]
    metrics = read_metrics(run, wanted)
    missing = [m["name"] for m in wanted if m["name"] not in metrics
               and (not args.trace or "workloads" in m)]
    bad = forbidden_found(run, here=True)
    run.info.update(card_line(device))
    print("portbench info " + json.dumps(run.info, default=str),
          file=sys.stderr)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if missing:
        print(f"portbench: metrics not read: {missing}", file=sys.stderr)
        return 4
    result = result_line(run, metrics, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device),
        "count": chips, "memory_peak_bytes": run.memory_peak})
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
