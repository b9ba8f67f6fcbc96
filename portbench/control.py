"""Readings of a cell's compared numbers for setting its limits: the
program's, and those of the control and of the planted faults that the
limits must fail. Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 4]

Serving cells: per seed, the program as the cell runs it (a window of
``--seconds`` after set-up, then the check) and the control, the program
with its int8 path on (``inference.quantize=int8``, the precision below
the configuration's bf16), served over the same shot and checked alike.
Training cells: per seed, the reference in the program's place at the
precision below the configuration's (TF32 on) against the fp32
reference, and the faults planted in the reference put in the program's
place: half of each batch left out (the mean over the rest), one leaf's
gradient doubled as the optimizer takes it; a state left unchanged reads
1 in ``change_gap`` by its definition. Each is read over the first steps
and over the window's first step, taken from the fp32 reference's state
at the window's opening (``window_``). With ``--program-fault
no_exchange`` (cells over several ranks), the program itself with the
exchange between its ranks left out, a window of ``--seconds``.

``--program-seeds``: the program alone, as the cell runs it (a window of
``--seconds``, then the check), for the lower readings. Prints one JSON
line a seed.
"""

import sys
import time

T_START = time.perf_counter()


def serve_readings(res, seed, seconds, device):
    import shutil
    import tempfile
    from pathlib import Path

    from pbench import harness
    from pbench.drivers import serve_directory as sd

    args = type("A", (), {"seed": seed, "seconds": seconds, "trace": 0})
    out = {}
    run = harness.execute(res, args, T_START, device)
    out["program"] = run.checks
    # the control: the same shot, weights and check, int8 serving
    run = harness.Run(res["cell"], res["config"], res["traffic"],
                      res["limits"], seed, seconds, False, T_START)
    run.device = device
    run.reference = harness.load_file_module(res["reference"], "pb_ref")
    run.scratch = Path(tempfile.mkdtemp(prefix="portbench_control_"))
    try:
        eng, shot_dir, w, start = sd.prepare(run, quantize="int8")
        eng.process_directory()
        del eng
        out["control_int8"] = sd.compare(run, w, shot_dir, start)
    finally:
        shutil.rmtree(run.scratch, ignore_errors=True)
    return out


def program_readings(res, seed, seconds, device, fault=None):
    """The compared numbers of the program as the cell runs it; with
    ``fault`` (``no_exchange``), of the program with its ranks' exchange
    left out."""
    from pbench import faults, harness
    from patch_toon_tpu_torch.parallel import launch

    args = type("A", (), {"seed": seed, "seconds": seconds, "trace": 0})
    spawn = launch.spawn
    if fault == "no_exchange":
        launch.spawn = lambda fn, a, devices, **k: spawn(
            faults.rank_without_exchange, a, devices, **k)
    try:
        run = harness.execute(res, args, T_START, device)
    finally:
        launch.spawn = spawn
    return {"ok": run.ok, **run.checks}


def _window_stand_in(start, out):
    """The records of one reference step from ``start`` as the program's
    hook keeps them."""
    st = out["state"]
    return {"before": start, "losses": out["losses"][0], "after": {
        "G": {k: st["G"][k] for k in st["opt"]["G"]["m"]},
        "D": {k: st["D"][k] for k in st["opt"]["D"]["m"]},
        "mG": st["opt"]["G"]["m"], "mD": st["opt"]["D"]["m"]}}


def _window_start(out):
    """A state as the program's hook copies it, from a reference run."""
    st = out["state"]
    start = {"G": st["G"], "D": st["D"]}
    for k in ("G", "D"):
        start["m" + k] = st["opt"][k]["m"]
        start["v" + k] = st["opt"][k]["v"]
        start["t" + k] = st["opt"][k]["t"]
    return start


def train_readings(res, seed, device):
    from pbench import harness, plain, seeds, weights
    from pbench.drivers import fit

    run = harness.Run(res["cell"], res["config"], res["traffic"],
                      res["limits"], seed, 0.0, False, T_START)
    run.device = device
    run.reference = harness.load_file_module(res["reference"], "pb_ref")
    kf = fit._keyframes(run)
    depth = sum(int(c["depth"]) for c in
                run.config["data"]["additional_channels"].values())
    sg, sdd, sp = fit._specs(run, 3 + depth)
    sds = (weights.draw(sg, seed, seeds.WEIGHTS_G, device),
           weights.draw(sdd, seed, seeds.WEIGHTS_D, device),
           weights.draw(sp, seed, seeds.WEIGHTS_VGG, device))
    n = int(run.traffic["check"]["steps"])
    w = int(run.traffic["warmup_steps"]) + 1
    b1 = fit.first_betas(run)
    ref = fit.reference_steps(run, kf, sds, n)
    start = _window_start(fit.reference_steps(run, kf, sds, w - 1))
    ref_w = fit.reference_steps(run, kf, sds, w, start=start, first=w)

    def readings(tf32=False):
        """The stand-in's first steps and window step against the fp32
        reference's."""
        first = fit.numbers(fit.reference_steps(run, kf, sds, n, tf32=tf32),
                            ref, *sds[:2])
        win = fit.reference_steps(run, kf, sds, w, tf32=tf32, start=start,
                                  first=w)
        return {**first, **fit.window_numbers(
            _window_stand_in(start, win), ref_w, b1)}

    out = {"control_tf32": readings(tf32=True)}
    # faults planted in the reference put in the program's place
    draw = plain.draw_batch

    def half(*a, **k):
        b = draw(*a, **k)
        return b[:b.shape[0] // 2]

    plain.draw_batch = half
    try:
        out["fault_half_batch"] = readings()
    finally:
        plain.draw_batch = draw
    step = plain.Adam.step
    first = {"done": False}

    def doubled(self, grads):
        if not first["done"]:
            k = next(iter(grads))
            grads = {**grads, k: grads[k] * 2.0}
            first["done"] = True
        return step(self, grads)

    plain.Adam.step = doubled
    try:
        first["done"] = False
        nums = fit.numbers(fit.reference_steps(run, kf, sds, n), ref,
                           *sds[:2])
        first["done"] = False
        win = fit.reference_steps(run, kf, sds, w, start=start, first=w)
        nums.update(fit.window_numbers(_window_stand_in(start, win), ref_w,
                                       b1))
        out["fault_leaf_doubled"] = nums
    finally:
        plain.Adam.step = step
    out["fault_state_unchanged"] = {"change_gap": 1.0,
                                    "window_change_gap": 1.0}
    return out


def main(argv):
    import argparse
    import json
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    from pbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--program-fault", choices=["no_exchange"])
    a = p.parse_args(argv)
    res = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                          a.workload)
    harness.prepare_environment()
    import torch

    device = torch.device("cuda", 0)
    for seed in a.program_seeds:
        t0 = time.perf_counter()
        out = {"program": program_readings(res, seed, a.seconds, device)}
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    for seed in a.seeds:
        t0 = time.perf_counter()
        if a.program_fault:
            out = {f"program_{a.program_fault}": program_readings(
                res, seed, a.seconds, device, a.program_fault)}
        elif res["traffic"]["driver"] == "fit":
            out = train_readings(res, seed, device)
        else:
            out = serve_readings(res, seed, a.seconds, device)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
