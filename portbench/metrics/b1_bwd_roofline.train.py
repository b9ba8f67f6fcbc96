"""Kernel B1's backward (``csrc/instance_norm_bwd.cu``,
``instance_norm_sample.cu``): its byte bound over the profiled steps (x and
dy read, dx written once at each site of this card's share of the batch,
``counts.b1_backward_bytes_step``) over the backward kernels' device time
on that card, in %."""

from pbench import counts, trace


def read(run):
    s = run.summary
    if s is None or not run.counts.get("slice_steps"):
        return None
    sec = trace.seconds_matching(s, "instance_norm_act_bwd")
    if sec <= 0:
        return None
    t = run.traffic["training"]
    rows = int(t["batch_size"]) // int(t.get("devices", 1))
    b = counts.b1_backward_bytes_step(
        run.config["model"], run.counts["channels"], rows,
        run.counts["patch_size"], counts.itemsize(str(t["precision"])))
    return 100.0 * run.counts["slice_steps"] * b / counts.HBM_BYTES_PER_S / sec
