"""The port's data-parallel GAN step in gloo ranks on the CPU, for
tests/test_torch_parallel_train.py. Imports no jax.

    python tests/torch_dist_worker.py <case.pt> <out_dir> <world> [...]

``case.pt`` holds the model's config dicts, the start weights of G and D,
the global batches (one a micro-step) and an optional global guide-dropout
mask. For each ``world``: 0 runs the steps in this process without a
process group (``plain.pt``); N spawns N gloo ranks on the CPU
(``parallel.spawn``), each running the steps on its rows of every batch
(``w<N>_rank<r>.pt``). Each file holds the networks' state dicts, the
generator's and discriminator's Adam first moments and the metrics of each
step.
"""

import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from patch_toon_tpu_torch import parallel  # noqa: E402
from patch_toon_tpu_torch.train.model import StyleTransferModel  # noqa: E402
from patch_toon_tpu_torch.train.step import make_train_step  # noqa: E402


def _mu(opt):
    return [m.clone() for m in getattr(opt, "inner", opt).mu]


def run(device, case_path: str, out: str) -> None:
    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    model = StyleTransferModel(**case["configs"])
    state = model.init_state(0, device)
    state.generator.load_state_dict(case["g"])
    state.discriminator.load_state_dict(case["d"])
    step = make_train_step(model)
    rows = parallel.shard_rows(case["batches"][0]["pre"].shape[0],
                               parallel.rank(), parallel.world())
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for batch in case["batches"]:
        met = step(state, {k: v[rows] for k, v in batch.items()}, gen,
                   guide_drop=case.get("drop"))
        metrics.append({k: float(v) for k, v in met.items()})
    name = "plain" if not torch.distributed.is_initialized() else \
        f"w{parallel.world()}_rank{parallel.rank()}"
    torch.save({"G": state.generator.state_dict(),
                "D": state.discriminator.state_dict(),
                "g_mu": _mu(state.g_opt), "d_mu": _mu(state.d_opt),
                "metrics": metrics}, pathlib.Path(out) / f"{name}.pt")


def main(case_path: str, out: str, *worlds: str) -> None:
    for w in map(int, worlds):
        if w == 0:
            run(torch.device("cpu"), case_path, out)
        else:
            parallel.spawn(run, (case_path, out), [torch.device("cpu")] * w)


if __name__ == "__main__":
    main(*sys.argv[1:])
