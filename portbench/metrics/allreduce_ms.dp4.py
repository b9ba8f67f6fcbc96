"""Device ms a step of the NCCL kernels on rank 0's card over the profiled
steps: the gradients' all-reduce (``parallel/comm.py::all_reduce_mean_``),
the metrics' and BatchNorm's statistics' reductions; time spent waiting
for the other ranks inside a collective counts."""

from pbench import trace


def read(run):
    s = run.summary
    if s is None or not run.counts.get("slice_steps"):
        return None
    sec = trace.seconds_matching(s, "nccl")
    return 1e3 * sec / run.counts["slice_steps"] if sec > 0 else None
