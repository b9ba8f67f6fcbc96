"""Frames written in the window over the window's seconds (host clock);
each call's ramp and drain inside the window."""


def read(run):
    if "frames" not in run.counts or not run.window_s:
        return None
    return run.counts["frames"] / run.window_s
