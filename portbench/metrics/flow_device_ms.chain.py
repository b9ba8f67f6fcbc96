"""Device ms a frame of the operations launched inside the program's
``host/flow`` ranges (the flow step's graph replay and its copies), over
the profiled call; nothing when the trace relates none to them."""


def read(run):
    s = run.summary
    if s is None or not run.counts.get("slice_frames"):
        return None
    sec = s["in_ranges"].get("host/flow", 0.0)
    return 1e3 * sec / run.counts["slice_frames"] if sec > 0 else None
