"""Patches of every step in the window over the window's seconds (host
clock); the logging, image-logging and checkpoint stalls count."""


def read(run):
    if "patches" not in run.counts or not run.window_s:
        return None
    return run.counts["patches"] / run.window_s
