"""The port's tensor-parallel forward and GAN step in gloo ranks on the
CPU, for tests/test_torch_tp.py. Imports no jax.

    python tests/torch_tp_worker.py <case.pt> <out_dir> <world>:<job>,... ...

``case.pt`` holds the model's config dicts, the whole start weights of G
and D, the inputs of the eval-mode forwards (``xg``, ``xd``) and the
global batches of the step. Each argument spawns ``world`` gloo ranks on
the CPU (``parallel.spawn``) that run its jobs in order:

- ``fwd<m>``: the layout data ``world / m`` x model m; each rank builds
  both networks whole, shards them (``parallel/tp.py``), loads its rank's
  state dicts of ``fwd_g`` / ``fwd_d`` (by m) and runs the sharded
  eval-mode forward of the whole inputs (``fwd<m>_rank<r>.pt``: the
  outputs, and B1's dy copies, none in a forward);
- ``step<m>``: the same layout; the train state is built whole, cut to the
  rank's shards (``train/state.py::shard_state_``) and takes one step on
  the data index's rows of each batch; then the whole networks and Adam
  moments are gathered over the model group (``step<m>_rank<r>.pt``:
  those, the metrics, the data and model index, and B1's dy copies).
"""

import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from patch_toon_tpu_torch import parallel  # noqa: E402
from patch_toon_tpu_torch.ops.instance_norm import (  # noqa: E402
    InstanceNormAct,
)
from patch_toon_tpu_torch.parallel.tp import (  # noqa: E402
    model_shard,
    shard_module_,
)
from patch_toon_tpu_torch.train.checkpoints import whole_state  # noqa: E402
from patch_toon_tpu_torch.train.model import StyleTransferModel  # noqa: E402
from patch_toon_tpu_torch.train.state import shard_state_  # noqa: E402
from patch_toon_tpu_torch.train.step import make_train_step  # noqa: E402


def _start(case, device):
    model = StyleTransferModel(**case["configs"])
    state = model.init_state(0, device)
    state.generator.load_state_dict(case["g"])
    state.discriminator.load_state_dict(case["d"])
    return model, state


def _forward(case, out: pathlib.Path, device, m: int) -> None:
    shard = model_shard(parallel.set_layout(m))
    _, state = _start(case, device)
    InstanceNormAct.dy_copies = 0
    res = {}
    for net, key, sd in ((state.generator, "xg", case["fwd_g"][m]),
                         (state.discriminator, "xd", case["fwd_d"][m])):
        shard_module_(net, shard)
        net.load_state_dict(sd[shard.rank], strict=True)
        net.eval()
        with torch.no_grad():
            res[key] = net(case[key])
    res["dy_copies"] = InstanceNormAct.dy_copies
    torch.save(res, out / f"fwd{m}_rank{parallel.rank()}.pt")


def _step(case, out: pathlib.Path, device, m: int) -> None:
    lay = parallel.set_layout(m)
    model, state = _start(case, device)
    shard_state_(state, model_shard(lay))
    step = make_train_step(model)
    rows = parallel.shard_rows(case["batches"][0]["pre"].shape[0],
                               lay.data_index, lay.data)
    gen = torch.Generator().manual_seed(0)
    InstanceNormAct.dy_copies = 0
    metrics = []
    for batch in case["batches"]:
        met = step(state, {k: v[rows] for k, v in batch.items()}, gen)
        metrics.append({k: float(v) for k, v in met.items()})
    whole = whole_state(state)
    sd = whole["state_dict"]
    opts = whole["optimizer_states"]
    torch.save({"G": {k[len("generator."):]: v for k, v in sd.items()
                      if k.startswith("generator.")},
                "D": {k[len("discriminator."):]: v for k, v in sd.items()
                      if k.startswith("discriminator.")},
                "g_mu": opts[0]["mu"], "d_mu": opts[1]["mu"],
                "metrics": metrics, "data_index": lay.data_index,
                "model_index": lay.model_index,
                "dy_copies": InstanceNormAct.dy_copies},
               out / f"step{m}_rank{parallel.rank()}.pt")


def run(device, case_path: str, out: str, jobs: list) -> None:
    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    for job in jobs:
        kind, m = job[:-1], int(job[-1])
        {"fwd": _forward, "step": _step}[kind](case, pathlib.Path(out),
                                               device, m)


def main(case_path: str, out: str, *specs: str) -> None:
    for spec in specs:
        world, jobs = spec.split(":")
        parallel.spawn(run, (case_path, out, jobs.split(",")),
                       [torch.device("cpu")] * int(world))


if __name__ == "__main__":
    main(*sys.argv[1:])
