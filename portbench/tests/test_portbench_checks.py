"""The check fails a broken program: each fault planted under a tiny CPU
rehearsal of a cell (the look for a card skipped, everything else of a
run driven) makes ``correct`` false. On a card, the control (serving:
the program's int8 path; training: the reference with TF32 on) fails
the cell's limits at the cell's own size."""

import portbench_testing as pt
import pytest
import torch
from pbench import harness

import patch_toon_tpu_torch.infer.programs as programs
from patch_toon_tpu_torch.data.dataset import StyleTransferDataset
from patch_toon_tpu_torch.infer.temporal import TemporalChain
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.train import optim


def _correct(workload) -> bool:
    line = harness.rehearse(pt.tiny(workload), seed=77, seconds=0.3,
                            trace=0)
    return line["correct"]


def _identity(self, x):  # the network returns its input: nothing served
    return x[..., :3]


def _half_tiles(blend):
    def run(gen, weights, *a, **k):
        w = weights.clone()
        w[w.shape[0] // 2:] = 0  # half the tiles left out of the mean
        return blend(gen, w, *a, **k)
    return run


def _altered(composite):
    def run(rgb, out, mask):
        u8, f = composite(rgb, out, mask)
        return torch.clamp(u8.to(torch.int16) + 4, 0, 255).to(u8.dtype), f
    return run


SERVE_FAULTS = {
    "unchanged": (GeneratorJ, "forward", lambda orig: _identity),
    "half_batch": (programs, "blend_tiles", _half_tiles),
    "altered": (programs, "_composite_u8", _altered),
}


@pytest.mark.parametrize("workload", [pt.SERVE, pt.CHAIN])
@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serving_fault_is_caught(workload, fault, monkeypatch):
    owner, name, make = SERVE_FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    assert _correct(workload) is False


def test_chain_without_carry_is_caught(monkeypatch):
    step = TemporalChain._chain_step

    def no_carry(self, fdev, mask, boxes, carry, *a, **k):
        u8, b, new = step(self, fdev, mask, boxes, carry, *a, **k)
        return u8, b, (None, new[1])  # every frame starts a chain

    monkeypatch.setattr(TemporalChain, "_chain_step", no_carry)
    assert _correct(pt.CHAIN) is False


def _skip_step(self, grads):
    return None


def _double_first(step):
    def run(self, grads):
        grads = list(grads)
        grads[0] = grads[0] * 2.0
        return step(self, grads)
    return run


def _half_batch(sample):
    def run(self, generator, batch_size, rows=slice(None)):
        out = sample(self, generator, batch_size, rows)
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}
    return run


TRAIN_FAULTS = {
    "unchanged": (optim.Adam, "step", lambda orig: _skip_step),
    "half_batch": (StyleTransferDataset, "sample_batch", _half_batch),
    "altered": (optim.Adam, "step", _double_first),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_fault_is_caught(fault, monkeypatch):
    owner, name, make = TRAIN_FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    assert _correct(pt.TRAIN) is False


def faulty_rank(device, spec, fault):
    """A spawned rank with ``fault`` planted in its own imports (the
    parent's patches do not reach a spawned process)."""
    from pbench import faults
    from pbench.drivers.fit import rank_main

    if fault == "no_exchange":  # each rank steps on its own gradients
        faults.rank_without_exchange(device, spec)
        return
    owner, name, make = TRAIN_FAULTS[fault]
    setattr(owner, name, make(getattr(owner, name)))
    rank_main(device, spec)


def rank_holding(device, spec, name):
    """A spawned rank whose process holds a module named ``name`` (rank 1
    alone), as a lazy import would leave it."""
    import sys
    import types

    import torch.distributed as dist
    from pbench.drivers.fit import rank_main

    if dist.get_rank() == 1:
        sys.modules[name] = types.ModuleType(name)
    rank_main(device, spec)


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS) + ["no_exchange"])
def test_four_rank_fault_is_caught(fault, monkeypatch):
    from patch_toon_tpu_torch.parallel import launch

    spawn = launch.spawn

    def planted(fn, args, devices, **k):
        return spawn(faulty_rank, tuple(args) + (fault,), devices, **k)

    monkeypatch.setattr(launch, "spawn", planted)
    assert _correct(pt.DP4) is False


@pytest.mark.parametrize("name", ["jax", "patch_toon_tpu"])
def test_a_rank_holding_jax_prints_no_result(name, monkeypatch):
    from patch_toon_tpu_torch.parallel import launch

    spawn = launch.spawn

    def planted(fn, args, devices, **k):
        return spawn(rank_holding, tuple(args) + (name,), devices, **k)

    monkeypatch.setattr(launch, "spawn", planted)
    assert harness.rehearse(pt.tiny(pt.DP4), seed=78, seconds=0.3,
                            trace=0) is None


def test_unbroken_rehearsals_are_correct():
    assert all(_correct(w) for w in (pt.SERVE, pt.CHAIN, pt.TRAIN, pt.DP4))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [pt.SERVE, pt.CHAIN, pt.TRAIN, pt.DP4])
def test_control_fails_on_a_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    import control

    res = pt.resolve(workload)
    harness.prepare_environment()
    dev = torch.device("cuda", 0)
    if res["traffic"]["driver"] == "fit":
        nums = control.train_readings(res, 1234567, dev)["control_tf32"]
    else:
        nums = control.serve_readings(res, 1234567, 2.0, dev)[
            "control_int8"]
    limits = res["limits"]["checks"]
    assert any(nums[k] > float(v) for k, v in limits.items())
