"""Operations of the window's training steps (``counts.train_step_flops``)
over the window's seconds times the chips times the peak of the training
precision, in %."""

from pbench import counts


def read(run):
    if not run.counts.get("steps") or not run.window_s:
        return None
    t = run.traffic["training"]
    ops = counts.train_step_flops(run.config["model"], run.counts["channels"],
                                  int(t["batch_size"]),
                                  run.counts["patch_size"])
    chips = int(run.cell["chips"])
    return 100.0 * run.counts["steps"] * ops / (
        run.window_s * chips * counts.peak(str(t["precision"])))
