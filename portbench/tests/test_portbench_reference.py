"""The plain reference agrees with the port on the CPU at a tiny size: the
networks, the tiled serving and the chain at precision 32, the flow, and
a training step."""

import copy

import portbench_testing as pt
import torch
from pbench import harness, plain, scene, weights

from patch_toon_tpu_torch.models.discriminator import DiscriminatorN_IN
from patch_toon_tpu_torch.models.generator import GeneratorJ
from patch_toon_tpu_torch.models.perception import PerceptualVGG19
from patch_toon_tpu_torch.ops.flow import dense_flow

CPU = torch.device("cpu")


def _net():
    res = pt.tiny(pt.TRAIN)
    return res, harness.load_file_module(res["reference"], "t_ref")


def test_networks_agree():
    res, net = _net()
    model = res["config"]["model"]
    ga, da = model["generator"]["args"], model["discriminator"]["args"]
    sd = weights.draw(net.generator_specs(ga, 6), 5, 1, CPU)
    g = GeneratorJ(**{**ga, "input_channels": 6})
    g.load_state_dict(sd)
    x = torch.rand(2, 24, 32, 6) * 2 - 1
    for train in (False, True):
        g.train(train)
        want = net.generator(sd, x.permute(0, 3, 1, 2), ga, train=train)
        got = g(x).permute(0, 3, 1, 2)
        assert torch.allclose(got, want, atol=2e-5), (got - want).abs().max()
    sdd = weights.draw(net.discriminator_specs(da), 5, 2, CPU)
    d = DiscriminatorN_IN(**da)
    d.load_state_dict(sdd)
    y = x[..., :3]
    assert torch.allclose(d(y).permute(0, 3, 1, 2),
                          net.discriminator(sdd, y.permute(0, 3, 1, 2), da),
                          atol=2e-5)
    sdp = weights.draw(net.vgg_specs([0, 3, 5]), 5, 3, CPU)
    p = PerceptualVGG19([0, 3, 5], use_normalization=False)
    p.features.load_state_dict({k[9:]: v for k, v in sdp.items()})
    for a, b in zip(p(y), net.vgg_features(sdp, y.permute(0, 3, 1, 2),
                                           [0, 3, 5])):
        assert torch.allclose(a.permute(0, 3, 1, 2), b, atol=2e-5)


def test_flow_agrees():
    shot = scene.Shot({"frames": 8, "height": 64, "width": 96}, 9, CPU)
    a, _ = shot.frame(1)
    b, _ = shot.frame(0)
    want = dense_flow(plain.luma(a).float() / 255,
                      plain.luma(b).float() / 255)
    got = plain.backward_flow(plain.luma(a), plain.luma(b))
    assert (got - want).abs().max() < 1e-3


def _at_32(workload):
    res = pt.tiny(workload)
    res["traffic"] = copy.deepcopy(res["traffic"])
    res["traffic"]["inference"]["precision"] = "32"
    return res


def test_tiled_serving_agrees_at_32():
    run = harness.execute(_at_32(pt.SERVE), harness.parse(
        ["--workload", pt.SERVE, "--seed", "4", "--seconds", "0.2"]), 0.0,
        CPU)
    assert run.ok and run.checks["max_abs_bytes"] <= 1


def test_chain_agrees_at_32():
    run = harness.execute(_at_32(pt.CHAIN), harness.parse(
        ["--workload", pt.CHAIN, "--seed", "4", "--seconds", "0.2"]), 0.0,
        CPU)
    # the reference chains from the program's written bytes, the program
    # from its fp32 composite: a guide within half a byte moves a few
    # output bytes by up to 3
    assert run.ok and run.checks["mean_abs_bytes"] < 0.2
    assert run.checks["share_over_2"] < 1e-3
    # the reference's own chain, from one written frame on
    assert run.checks["chain_mean_abs_bytes"] < 0.2
    assert run.checks["chain_share_over_2"] < 1e-3


def test_training_steps_agree():
    run = harness.execute(pt.tiny(pt.TRAIN), harness.parse(
        ["--workload", pt.TRAIN, "--seed", "4", "--seconds", "0.5"]), 0.0,
        CPU)
    assert run.ok
    assert run.checks["loss_gap"] < 1e-5
    assert run.checks["grad_gap"] < 1e-4
    assert run.checks["change_gap"] < 1e-3
    # the window's first step, from the program's state as it opened
    assert run.checks["window_loss_gap"] < 1e-5
    assert run.checks["window_grad_gap"] < 1e-4
    assert run.checks["window_change_gap"] < 1e-3
