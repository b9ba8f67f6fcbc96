"""Kernel B2 (``csrc/blend.cu``): its byte bound over the profiled call
(``counts.b2_bytes``) over ``blend_tiles_kernel``'s device time, in %."""

from pbench import counts, trace


def read(run):
    s = run.summary
    if s is None or not run.counts.get("slice_frames"):
        return None
    sec = trace.seconds_matching(s, "blend_tiles_kernel")
    if sec <= 0:
        return None
    f = run.counts["slice_frames"]
    t = run.traffic
    b = counts.b2_bytes(f * run.counts["tiles_per_frame"],
                        run.counts["patch_size"], f, int(t["height"]),
                        int(t["width"]))
    return 100.0 * b / counts.HBM_BYTES_PER_S / sec
