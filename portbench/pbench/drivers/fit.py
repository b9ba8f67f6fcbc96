"""Training: ``train/loop.py::fit`` on keyframes rendered from the seed,
in this process or, with ``training.devices`` N > 1, in N ranks spawned
by the program's own launcher (``parallel/launch.py``, one card a rank,
NCCL on cards, gloo on the CPU).

Set-up renders the keyframes (``pbench/scene.py``) and builds the
program's dataset and model from its own config files with the cell's
overrides; ``fit`` then builds its state, whose weights the benchmark
replaces with its own seeded ones as the state is made (the optimizers
keep the same tensors), and runs. Its ``on_step`` hook sees every step:
the first ``warmup_steps`` are set-up (the first three are the ones the
reference follows: their losses, Adam's first moment after step 1 and the
leaves after step 3 are kept); the window opens at the last of them (the
whole state, optimizers included, is copied there, and the first step of
the window, its losses, leaves and first moment are kept: device copies,
nothing synchronised, rank 0 alone over several ranks) and
closes at the first step that ends ``--seconds`` later (over several
ranks: the first logging step after that, rank 0's clock deciding for
all, so every rank leaves at the same step), where the hook stops
``fit``. Each step's time is the interval between CUDA events recorded
on the stream at consecutive hooks: the device's clock from one step's
end to the next, so a stall of the host shows in it. With ``--trace 1``
the window's steps ``trace_steps`` run under the profiler (rank 0's) and
are left out of the window's time and steps. Rank 0's records reach this
process through a file.

The check, after the window, the program's state freed: the reference
draws the same global batches from the seed and takes three steps from
the same weights on one device in fp32 (TF32 off; over ranks the
program's mean of the ranks' gradients and its global BatchNorm
statistics are the one-device step's), and four numbers are compared:
the worst relative gap of the steps' losses and of step 1's loss, of a
leaf's norm of step 1's gradient as Adam took it (its first moment over
1 - beta1), and of a leaf's norm of the change over three steps (leaves
whose reference gradient is under a thousandth of the median leaf's are
left out of the change: Adam moves them by round-off). Then the window's
first step: the reference takes one step from the program's state as the
window opened, on the seed's batch of that step, and the same three
gaps are taken (``window_``: the losses; the gradient, which is the
first moment's change over 1 - beta1; the change of the leaves).

Over several ranks each rank writes, once its window has closed, which
modules of JAX or the JAX package its process holds; the parent refuses
the run if any rank's list is not empty or missing.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from pbench import plain, scene, seeds, weights
from pbench.harness import (ROOT, Run, forbidden_modules, launch_counts,
                            load_file_module)
from pbench.overrides import flatten, model_overrides
from pbench.trace import Slice


class WindowClosed(Exception):
    """Raised by the step hook to end ``fit`` when the window closes."""


def _keyframes(run: Run):
    kf = scene.keyframes(run.traffic, run.seed, run.device)
    return {"pre": plain.signed(kf["pre"]), "post": plain.signed(kf["post"]),
            "guide": plain.signed(kf["guide"]), "mask": kf["mask"]}


def _depth(run: Run) -> int:
    return sum(int(c["depth"]) for c in
               run.config["data"]["additional_channels"].values())


def _specs(run: Run, cin: int):
    m, net = run.config["model"], run.reference
    return (net.generator_specs(m["generator"]["args"], cin),
            net.discriminator_specs(m["discriminator"]["args"]),
            net.vgg_specs(m["perception_loss"]["perception_model"]["args"][
                "feature_layers"]))


def _weights(run: Run):
    sg, sdd, sp = _specs(run, 3 + _depth(run))
    return (weights.draw(sg, run.seed, seeds.WEIGHTS_G, run.device),
            weights.draw(sdd, run.seed, seeds.WEIGHTS_D, run.device),
            weights.draw(sp, run.seed, seeds.WEIGHTS_VGG, run.device))


class Hook:
    """fit's ``on_step``: the first steps' records, the window, the
    profiled slice."""

    def __init__(self, run: Run, holder: dict, rank: int, world: int):
        t = run.traffic
        self.run, self.holder = run, holder
        self.rank, self.world = rank, world
        self.warmup = int(t["warmup_steps"])
        self.check = int(t["check"]["steps"])
        self.log_every = int(t["training"].get("log_every_n_steps", 10))
        self.trace_steps = t.get("trace_steps", [0, 0])
        self.losses: List[Dict[str, float]] = []
        self.events: list = []
        self.slice = None
        self.t0 = None
        self.first_step = 0
        self.left_out_s = 0.0

    def _event(self) -> None:
        if self.run.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())

    def _sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _closing(self, k: int) -> bool:
        due = time.perf_counter() - self.t0 - self.left_out_s \
            >= self.run.seconds and self.slice is None
        if self.world == 1:
            return due
        if k % self.log_every:
            return False
        import torch.distributed as dist

        flag = torch.tensor([1.0 if due else 0.0], device=self.run.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def _first_steps(self, step: int, metrics) -> None:
        run, st = self.run, self.holder["state"]
        self.losses.append({k: float(metrics[k]) for k in
                            ("g_total_loss", "d_total_loss")})
        if step == 1:
            b1g, b1d = st.g_opt.b1, st.d_opt.b1
            self.holder["grads1"] = {
                **{f"G.{n}": m.detach().clone() / (1 - b1g) for n, m in
                   zip(self.holder["g_names"], st.g_opt.mu)},
                **{f"D.{n}": m.detach().clone() / (1 - b1d) for n, m in
                   zip(self.holder["d_names"], st.d_opt.mu)}}
            run.info["tf32"] = {
                "cudnn": torch.backends.cudnn.allow_tf32,
                "matmul": torch.backends.cuda.matmul.allow_tf32}
        if step == self.check:
            self.holder["params"] = {
                **{f"G.{n}": p.detach().clone() for n, p in
                   st.generator.named_parameters()},
                **{f"D.{n}": p.detach().clone() for n, p in
                   st.discriminator.named_parameters()}}

    def _state(self, whole: bool) -> dict:
        """Copies of the leaves and the optimizers' first moments, and with
        ``whole`` every buffer and the optimizers' second moments and
        counts: device copies, nothing synchronised."""
        st = self.holder["state"]
        out = {}
        for key, net, opt, names in (
                ("G", st.generator, st.g_opt, self.holder["g_names"]),
                ("D", st.discriminator, st.d_opt, self.holder["d_names"])):
            weights = net.state_dict() if whole else dict(
                net.named_parameters())
            out[key] = {k: v.detach().clone() for k, v in weights.items()}
            out["m" + key] = {n: m.detach().clone()
                              for n, m in zip(names, opt.mu)}
            if whole:
                out["v" + key] = {n: v.detach().clone()
                                  for n, v in zip(names, opt.nu)}
                out["t" + key] = opt.count
        return out

    def __call__(self, step: int, metrics: Dict[str, torch.Tensor]) -> None:
        run = self.run
        if step <= self.check:
            self._first_steps(step, metrics)
        if self.rank == 0 and step == self.warmup + 1:
            self.holder["window"] = {
                "before": self.holder.pop("before"), "after": self._state(
                    False), "losses": {k: metrics[k].detach().clone() for k
                                       in ("g_total_loss", "d_total_loss")},
                "step": step}
        if step == self.warmup:
            if self.rank == 0:
                self.holder["before"] = self._state(True)
            self._sync()
            run.setup_done()
            self.before = launch_counts()
            self.first_step = step
            self.t0 = time.perf_counter()
            self._event()
            return
        if self.t0 is None:
            return
        self._event()
        k = step - self.first_step
        if run.trace and self.rank == 0 and k == self.trace_steps[0]:
            self.slice = Slice(run.device, run.scratch)
            self.slice.start()
        if self.slice is not None and k == self.trace_steps[1]:
            self.slice.stop()
            run.summary = self.slice.summary
            run.counts["slice_steps"] = k - self.trace_steps[0]
            # the profiled steps, the export and reduction are left out of
            # the window's time and steps
            self.left_out_s = self.slice.seconds
            self.slice = None
        if self._closing(k):
            self._sync()
            run.window_s = time.perf_counter() - self.t0 - self.left_out_s
            run.counts["steps"] = k - run.counts.get("slice_steps", 0)
            run.counts["window_steps"] = k
            after = launch_counts()
            run.info["launches"] = {
                n: after[n] - self.before.get(n, 0) for n in after
                if after[n] != self.before.get(n, 0)}
            raise WindowClosed


def train(run: Run, rank: int = 0, world: int = 1) -> dict:
    """The program's part on ``run.device``: set-up, the first steps'
    records, the window. -> the records the check needs."""
    from patch_toon_tpu_torch.config.compose import compose
    from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
    from patch_toon_tpu_torch.train.loop import fit
    from patch_toon_tpu_torch.train.model import StyleTransferModel

    dev, t = run.device, run.traffic
    kf = _keyframes(run)
    ps, depth = int(run.config["data"]["patch_size"]), _depth(run)
    host = {k: v.cpu().numpy() for k, v in kf.items()}
    dataset = StyleTransferDataset(
        list(host["pre"]), list(host["post"]),
        [(m > 127).astype("float32") for m in host["mask"]],
        list(host["guide"][..., :depth]), [depth], patch_size=ps,
        sampling=t["data"].get("sampling", "uniform"), device=dev)
    ov = model_overrides(run.config) + flatten(t["training"], "training")
    cfg = compose(ROOT / "config", "config", overrides=ov)
    model = StyleTransferModel(
        cfg.model.generator, cfg.model.discriminator, cfg.training,
        cfg.optimizer, cfg.data, cfg.model.perception_loss, cfg.parallel)
    run.counts.update(channels=3 + depth, patch_size=ps)
    sd_g, sd_d, sd_p = _weights(run)
    holder: dict = {}
    init_state = model.init_state

    def seeded_state(seed, device):
        st = init_state(seed, device)
        st.generator.load_state_dict(sd_g, strict=True)
        st.discriminator.load_state_dict(sd_d, strict=True)
        st.perception.features.load_state_dict(
            {k[len("features."):]: v for k, v in sd_p.items()}, strict=True)
        holder["state"] = st
        holder["g_names"] = [n for n, _ in st.generator.named_parameters()]
        holder["d_names"] = [n for n, _ in
                             st.discriminator.named_parameters()]
        return st

    model.init_state = seeded_state
    hook = Hook(run, holder, rank, world)
    try:
        fit(model, dataset, str(run.scratch / f"run{rank}"), seed=run.seed,
            max_epochs=10**9, progress=False, device=dev, on_step=hook)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("fit ended before the window closed")
    ev = hook.events
    if dev.type == "cuda":
        run.step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        run.memory_peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        run.step_ms = [1e3 * (b - a) for a, b in zip(ev, ev[1:])]
    prog = {"losses": hook.losses, "grads1": holder.pop("grads1"),
            "params": holder.pop("params")}
    if "window" in holder:
        w = holder.pop("window")
        w["losses"] = {k: float(v) for k, v in w["losses"].items()}
        prog["window"] = w
    return prog


def rank_main(device: torch.device, spec: dict) -> None:
    """One spawned rank: :func:`train` on its card; rank 0 writes what it
    recorded for the parent."""
    import torch.distributed as dist

    run = Run(spec["cell"], spec["config"], spec["traffic"], {},
              spec["seed"], spec["seconds"], spec["trace"], spec["t_start"])
    run.device, run.scratch = device, Path(spec["scratch"])
    run.reference = load_file_module(Path(spec["reference"]),
                                     "portbench_reference")
    rank, world = dist.get_rank(), dist.get_world_size()
    prog = train(run, rank, world)
    (run.scratch / f"rank{rank}.modules").write_text(
        "\n".join(forbidden_modules()))
    if rank == 0:
        torch.save({"prog": {k: _cpu(v) for k, v in prog.items()},
                    "fields": {k: getattr(run, k) for k in (
                        "setup_s", "window_s", "counts", "step_ms",
                        "summary", "info", "memory_peak")}},
                   run.scratch / "rank0.pt")
    dist.barrier()  # every rank leaves the group together


def _cpu(v):
    if isinstance(v, dict):
        return {k: _cpu(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_cpu(x) for x in v]
    return v.cpu() if isinstance(v, torch.Tensor) else v


def _on(v, dev):
    if isinstance(v, dict):
        return {k: _on(x, dev) for k, x in v.items()}
    if isinstance(v, list):
        return [_on(x, dev) for x in v]
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def _spawned(run: Run, world: int) -> dict:
    from patch_toon_tpu_torch.parallel import comm, launch

    devices = comm.local_devices(world, cpu=run.device.type == "cpu")
    spec = {"cell": run.cell, "config": run.config, "traffic": run.traffic,
            "seed": run.seed, "seconds": run.seconds, "trace": run.trace,
            "t_start": run.t_start, "scratch": str(run.scratch),
            "reference": run.reference.__file__}
    launch.spawn(rank_main, (spec,), devices)
    for r in range(world):
        f = run.scratch / f"rank{r}.modules"
        run.forbidden[f"rank {r}"] = f.read_text().split() if f.exists() \
            else ["(no list written)"]
    rec = torch.load(run.scratch / "rank0.pt", weights_only=False)
    for k, v in rec["fields"].items():
        setattr(run, k, v)
    run.counts["channels"] = 3 + _depth(run)
    return _on(rec["prog"], run.device)


def run(run: Run) -> None:
    world = int(run.traffic["training"].get("devices", 1))
    if world > 1:
        prog = _spawned(run, world)
    else:
        prog = train(run)
    batch = int(run.traffic["training"]["batch_size"])
    run.counts["patches"] = run.counts["steps"] * batch
    run.attempted = run.counts["window_steps"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    kf = _keyframes(run)
    nums = compare(run, prog, kf, _weights(run))
    run.checks.update(nums)
    run.info["check_numbers"] = nums


def batches(run: Run, kf: dict, n: int) -> List[torch.Tensor]:
    """The global batches of steps 1 to ``n``, drawn from the seed."""
    dev = run.device
    ps = int(run.config["data"]["patch_size"])
    stack = torch.cat([kf["pre"], kf["post"], kf["guide"][..., :_depth(run)]],
                      dim=-1)
    sizes = [tuple(stack.shape[1:3])] * stack.shape[0]
    centres = [torch.from_numpy(plain.valid_centres(m)) for m in kf["mask"]]
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    return [plain.draw_batch(gen, stack, sizes, centres,
                             int(run.traffic["training"]["batch_size"]), ps)
            for _ in range(n)]


def reference_steps(run: Run, kf: dict, sds, n: int, tf32: bool = False,
                    start: Optional[dict] = None, first: int = 1):
    """The reference's steps ``first`` to ``n`` on the seed's batches, from
    the weights ``sds`` or, with ``start`` (a state as :meth:`Hook._state`
    copies it), from that state and its optimizers'."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    sd_g, sd_d, opt = sds[0], sds[1], None
    if start is not None:
        sd_g, sd_d = start["G"], start["D"]
        opt = {k: {"m": start["m" + k], "v": start["v" + k],
                   "t": start["t" + k]} for k in ("G", "D")}
    try:
        return plain.train_steps(run.reference, run.config["model"], sd_g,
                                 sd_d, sds[2], batches(run, kf, n)[first - 1:],
                                 run.config["optimizer"],
                                 run.config["training"], opt_start=opt)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def numbers(prog: dict, ref: dict, sd_g: dict, sd_d: dict) -> Dict[str, float]:
    """The compared numbers of a program (or a stand-in) against the
    reference."""
    gaps = [max(plain.unit_gap(p[k], r[k]) for k in r)
            for p, r in zip(prog["losses"], ref["losses"])]
    grad, _ = plain.leaf_gap(prog["grads1"], ref["grads1"])
    start = {**{f"G.{k}": v for k, v in sd_g.items()},
             **{f"D.{k}": v for k, v in sd_d.items()}}
    keep = plain.moving_leaves(ref["grads1"])
    d_prog = {k: prog["params"][k] - start[k] for k in keep}
    d_ref = {k: ref["params"][k] - start[k] for k in keep}
    change, _ = plain.leaf_gap(d_prog, d_ref)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0], "grad_gap": grad,
            "change_gap": change}


def window_numbers(prog: dict, ref: dict, b1: Dict[str, float]
                   ) -> Dict[str, float]:
    """The gaps of one step from a state (``prog``: the program's records
    of the step as :meth:`Hook.__call__` keeps them, or a stand-in's)
    against the reference's step from the same state; ``b1``: each
    network's first beta ("G", "D")."""
    before, after = prog["before"], prog["after"]
    loss = max(plain.unit_gap(prog["losses"][k], ref["losses"][0][k])
               for k in ref["losses"][0])
    grads = {f"{k}.{n}": (after["m" + k][n] - b1[k] * before["m" + k][n])
             / (1 - b1[k]) for k in ("G", "D") for n in after["m" + k]}
    grad, _ = plain.leaf_gap(grads, ref["grads1"])
    keep = [k.split(".", 1) for k in plain.moving_leaves(ref["grads1"])]
    d_prog = {f"{k}.{n}": after[k][n] - before[k][n] for k, n in keep}
    d_ref = {f"{k}.{n}": ref["params"][f"{k}.{n}"] - before[k][n]
             for k, n in keep}
    change, _ = plain.leaf_gap(d_prog, d_ref)
    return {"window_loss_gap": loss, "window_grad_gap": grad,
            "window_change_gap": change}


def first_betas(run: Run) -> Dict[str, float]:
    opt = run.config["optimizer"]
    return {"G": float(opt["generator"]["betas"][0]),
            "D": float(opt["discriminator"]["betas"][0])}


def compare(run: Run, prog: dict, kf: dict, sds) -> Dict[str, float]:
    n = int(run.traffic["check"]["steps"])
    if len(prog["losses"]) < n or "window" not in prog:
        run.ok = False
        return {}
    out = numbers(prog, reference_steps(run, kf, sds, n), sds[0], sds[1])
    w = prog["window"]
    out.update(window_numbers(w, reference_steps(
        run, kf, sds, w["step"], start=w["before"], first=w["step"]),
        first_betas(run)))
    return out
