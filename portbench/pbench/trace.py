"""A profiler trace of a steady slice of the window, reduced to what the
per-layer readers need.

The slice runs under ``torch.profiler`` (CPU and CUDA activity) inside a
``portbench/slice`` range on the main thread, whose extent in the trace
is the slice's window. Reduced:

- ``busy_s``: the union of the device's kernel, copy and memset intervals
  (a copy that overlaps a kernel counts once);
- ``by_name``: device seconds by operation name;
- ``in_ranges``: device seconds of the operations launched inside each of
  the program's ``host/*`` ranges on the main thread (a launch's runtime
  call and its device operations share a correlation id; a CUDA graph's
  kernels carry its launch's);
- ``idle``: device idle seconds by the main thread's innermost ``host/*``
  range at each gap's midpoint (``other`` outside any);
- ``trace_window_s``: the slice's length in the trace.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench/slice"


class Slice:
    """``start()`` and ``stop()`` around the slice; ``summary`` after, and
    ``seconds``, the slice's host time with the trace's export and reduction,
    which a window leaves out of its own time."""

    def __init__(self, device: torch.device, scratch: Path):
        self.device = device
        self.scratch = scratch
        self.summary: Optional[dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # the profiler's start (CUPTI's set-up: seconds the first time) is
        # the slice's, and left out of the window with it
        self.t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.rf = torch.profiler.record_function(SLICE)
        self.rf.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        path = self.scratch / f"slice_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        self.summary = reduce_events(events)
        del self.prof
        self.seconds = time.perf_counter() - self.t0


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict]) -> dict:
    """The summary (see the module's docstring) of chrome-trace events."""
    xs = [e for e in events if e.get("ph") == "X"]
    sl = [e for e in xs if e.get("name") == SLICE
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the trace holds no slice range")
    main = sl[0]
    lo, hi = float(main["ts"]), float(main["ts"]) + float(main["dur"])
    tid = main.get("tid")
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    ranges = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in xs if e.get("cat") == "user_annotation"
         and e.get("tid") == tid and str(e.get("name", "")).startswith(
             "host/")))
    starts = [r[0] for r in ranges]

    def range_at(t: float) -> str:
        # ranges nest: the latest-starting one that holds t is innermost
        for a, b, name in reversed(ranges[:bisect.bisect_right(starts, t)]):
            if t <= b:
                return name
        return "other"

    # device operations by the range their launch fell in
    corr_range: Dict[int, str] = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and e.get("tid") == tid:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                corr_range[int(c)] = range_at(float(e["ts"]))
    in_ranges: Dict[str, float] = defaultdict(float)
    for e in dev:
        c = (e.get("args") or {}).get("correlation")
        if c is not None and int(c) in corr_range:
            in_ranges[corr_range[int(c)]] += float(e["dur"]) * 1e-6
    # idle gaps inside the slice, by what the main thread was doing
    idle: Dict[str, float] = defaultdict(float)
    t = lo
    for a, b in busy + [(hi, hi)]:
        a, b = max(a, lo), min(b, hi)
        if a > t:
            idle[range_at((t + a) / 2)] += (a - t) * 1e-6
        t = max(t, b)
    busy_s = sum(min(b, hi) - max(a, lo) for a, b in busy
                 if b > lo and a < hi) * 1e-6
    return {"busy_s": busy_s, "trace_window_s": (hi - lo) * 1e-6,
            "by_name": dict(by_name),
            "in_ranges": dict(in_ranges), "idle": dict(idle),
            "device_ops": len(dev)}


def seconds_matching(summary: dict, *parts: str,
                     exclude: Tuple[str, ...] = ()) -> float:
    """Device seconds of the operations whose name holds every ``parts``
    and none of ``exclude``."""
    return sum(s for n, s in summary["by_name"].items()
               if all(p in n for p in parts)
               and not any(x in n for x in exclude))


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in gaps]}
