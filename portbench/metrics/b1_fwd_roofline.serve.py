"""Kernel B1's forward (``csrc/instance_norm*.cu``): its byte bound at the
generator's 19 sites of every tile of the profiled call (each site's
input read and output written once, ``counts.b1_forward_bytes``) over
the device time of every B1 forward kernel there, in %."""

from pbench import counts, trace


def read(run):
    s = run.summary
    if s is None or not run.counts.get("slice_frames"):
        return None
    sec = trace.seconds_matching(s, "instance_norm", exclude=("bwd",))
    if sec <= 0:
        return None
    item = counts.itemsize(str(run.traffic["inference"]["precision"]))
    ps = run.counts["patch_size"]
    per_tile = counts.b1_forward_bytes(
        run.config["model"]["generator"]["args"], run.counts["channels"], ps,
        ps, item)
    tiles = run.counts["slice_frames"] * run.counts["tiles_per_frame"]
    return 100.0 * tiles * per_tile / counts.HBM_BYTES_PER_S / sec
