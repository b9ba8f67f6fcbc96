"""Generator operations of the tiles served in the window over the window's
seconds times the peak of the serving precision (``pbench/counts.py``),
in %."""

from pbench import counts


def read(run):
    if not run.counts.get("frames") or not run.window_s:
        return None
    prec = str(run.traffic["inference"]["precision"])
    ops = counts.generator_flops(
        run.config["model"]["generator"]["args"], run.counts["channels"],
        run.counts["patch_size"], run.counts["patch_size"])
    tiles = run.counts["frames"] * run.counts["tiles_per_frame"]
    return 100.0 * tiles * ops / (run.window_s * counts.peak(prec))
