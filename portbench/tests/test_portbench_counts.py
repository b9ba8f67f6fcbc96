"""The yardstick's operation counts equal ``torch.utils.flop_counter`` on
the plain reference at a small size, and the kernels' byte counts equal
the frozen arithmetic (B1: 2 x the bytes of each site's input forward,
3 x backward; B2: each tile's 4 fp32 values, the 4-value fp32 canvas)."""

import portbench_testing as pt
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pbench import counts, plain, weights

ARGS = {"filters": [4, 8, 8, 8, 8, 6], "resnet_blocks": 2, "use_bias": True,
        "append_smoothers": True, "tanh": True}


def _ref():
    res = pt.tiny(pt.TRAIN)
    return res, pt.harness.load_file_module(res["reference"], "t_ref")


@pytest.mark.parametrize("cin,size", [(6, 16), (9, 24)])
def test_generator_flops(cin, size):
    _, net = _ref()
    sd = weights.draw(net.generator_specs(ARGS, cin), 1, 1,
                      torch.device("cpu"))
    x = torch.rand(2, cin, size, size)
    with FlopCounterMode(display=False) as fc:
        net.generator(sd, x, ARGS)
    assert fc.get_total_flops() == 2 * counts.generator_flops(ARGS, cin,
                                                               size, size)


def test_train_step_flops():
    res, net = _ref()
    model = res["config"]["model"]
    ps, batch, cin = 16, 3, 6
    dev = torch.device("cpu")
    sds = (weights.draw(net.generator_specs(model["generator"]["args"], cin),
                        1, 1, dev),
           weights.draw(net.discriminator_specs(
               model["discriminator"]["args"]), 1, 2, dev),
           weights.draw(net.vgg_specs([0, 3, 5]), 1, 3, dev))
    batches = [torch.rand(batch, ps, ps, 9) * 2 - 1]
    with FlopCounterMode(display=False) as fc:
        plain.train_steps(net, model, *sds, batches,
                          res["config"]["optimizer"], res["config"]["training"])
    assert fc.get_total_flops() == counts.train_step_flops(model, cin, batch,
                                                           ps)


def _site_inputs(net, sd, x, args):
    """Each InstanceNorm input of a reference forward."""
    seen = []
    orig = net.instance_norm

    def spy(t, eps=1e-5):
        seen.append(t)
        return orig(t, eps)

    net.instance_norm = spy
    try:
        net.generator(sd, x, args)
    finally:
        net.instance_norm = orig
    return seen


def test_b1_bytes_equal_frozen_arithmetic():
    res, net = _ref()
    model = res["config"]["model"]
    args = model["generator"]["args"]
    sd = weights.draw(net.generator_specs(args, 6), 1, 1,
                      torch.device("cpu"))
    sites = _site_inputs(net, sd, torch.rand(1, 6, 16, 16), args)
    assert len(sites) == 3 + 2 * args["resnet_blocks"] + 2
    for item in (2, 4):
        frozen = sum(2 * s.numel() * item for s in sites)
        assert counts.b1_forward_bytes(args, 6, 16, 16, item) == frozen
    d_sites = [s for s in counts._disc_sites(model["discriminator"]["args"],
                                             16, 16)]
    el = sum(s.numel() for s in sites) + 3 * sum(a * b * c
                                                 for a, b, c in d_sites)
    assert counts.b1_backward_bytes_step(model, 6, 1, 16, 4) == 3 * el * 4


def test_b2_bytes_equal_frozen_arithmetic():
    n, ps, h, w = 510, 80, 540, 960
    ch, cw = 3 * (h + ps), w + ps  # a 3-frame canvas
    assert counts.b2_bytes(n, ps, 3, h, w) == n * ps * ps * 4 * 4 \
        + ch * cw * 4 * 4


def test_peaks():
    assert counts.peak("bf16") == 989e12 and counts.peak(32) == 67e12
    with pytest.raises(ValueError):
        counts.peak("32_fast")
