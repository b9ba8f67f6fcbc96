"""``patch_toon_tpu_torch/utils/jax_random.py`` against jax.random and flax,
and the port's seed-42 VGG19 prefix against ``init_vgg_params``.

Keys, words and uniforms are bitwise JAX's by construction. The normal draw
copies the float32 code XLA's CPU backend compiles (its log1p, Giles'
erf_inv, its fused multiply-adds) and is held bitwise too: the bar a
different machine could need is 4 ulp, and this one needs none.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core.scope import _fold_in_static

from patch_toon_tpu.models.perception import init_vgg_params
from patch_toon_tpu_torch.models.perception import (
    PerceptualVGG19,
    init_vgg_state,
    load_vgg_state,
    vgg19_layer_plan,
)
from patch_toon_tpu_torch.utils import jax_random as jr

SEEDS = [0, 1, 42, -1, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5, 11), (2, 1, 9, 13)]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_and_static_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    mine = jr.prng_key(seed)
    _same_bits(key, mine)
    for data in (0, 7, 0x6D, 2**32 - 1):
        _same_bits(jax.random.fold_in(key, data), jr.fold_in(mine, data))
    for num in (2, 5):
        _same_bits(jax.random.split(key, num), jr.split(mine, num))
    for items in (["features_0", 1], ["features_34", 1], ["a", 0, "bc", 300],
                  []):
        _same_bits(_fold_in_static(key, items), jr.fold_in_static(mine, items))


def test_seed_outside_int32_is_refused():
    with pytest.raises(ValueError, match="int32"):
        jr.prng_key(2**31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_are_bitwise(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    mine = jr.fold_in(jr.prng_key(seed), 3)
    _same_bits(jax.random.bits(key, shape, jnp.uint32),
               jr.random_bits(mine, shape))
    _same_bits(jax.random.uniform(key, shape), jr.uniform(mine, shape))
    _same_bits(jax.random.uniform(key, shape, minval=-3.5, maxval=0.25),
               jr.uniform(mine, shape, -3.5, 0.25))


@pytest.mark.parametrize("seed", [0, 5, 42])
@pytest.mark.parametrize("shape", [(7,), (3, 3, 5, 11), (200_003,)])
def test_normal_is_bitwise(seed, shape):
    key = jax.random.PRNGKey(seed)
    _same_bits(jax.random.normal(key, shape), jr.normal(jr.prng_key(seed),
                                                        shape))


def test_erf_inv_over_its_branches():
    """Both log1p branches, both erf_inv branches and the ends of the
    uniform's range, against XLA's ``erf_inv``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.concatenate([
        np.linspace(-1, 1, 100_001, dtype=np.float32)[1:-1],
        np.float32([lo, -lo, 0.0, -0.0, 0.6436, -0.6436, 0.99966, -0.99966,
                    1e-20, -1e-30]),
        np.nextafter(np.float32(1), np.float32(0)) - np.float32(
            np.arange(64) * 2**-24)])
    _same_bits(jax.lax.erf_inv(jnp.asarray(u)), jr.erf_inv(u))


def _jax_state(feature_layers):
    return {f"features.{name.split('_')[1]}.{kind}": np.asarray(
        np.transpose(p["kernel"], (3, 2, 0, 1)) if kind == "weight"
        else p["bias"])
        for name, p in init_vgg_params(feature_layers)["params"].items()
        for kind in ("weight", "bias")}


@pytest.mark.parametrize("feature_layers", [[0, 3, 5], [0, 3, 5, 10], [21]])
def test_vgg_state_equals_init_vgg_params(feature_layers):
    want = _jax_state(feature_layers)
    got = load_vgg_state(None, max(feature_layers))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _same_bits(v, got[k].numpy())
    port = PerceptualVGG19(feature_layers)
    for k, v in port.features.state_dict().items():
        _same_bits(want["features." + k], v.numpy())


def test_rest_of_the_prefix_is_flax_s_draw():
    """Convs 23-34, the prefix past index 21, drawn as flax draws any conv
    (the key of ``features_<i>`` does not depend on the depth; the case
    above holds that formula to ``init_vgg_params`` up to index 21)."""
    state = init_vgg_state(36)
    key = jax.random.PRNGKey(42)
    cin, seen = 3, 0
    for idx, (op, width) in enumerate(vgg19_layer_plan(36)):
        if op != "conv":
            continue
        if idx > 21:
            want = jax.random.normal(
                _fold_in_static(key, [f"features_{idx}", 1]),
                (3, 3, cin, width)) * jnp.float32(0.02)
            _same_bits(np.transpose(np.asarray(want), (3, 2, 0, 1)),
                       state[f"features.{idx}.weight"].numpy())
            assert not state[f"features.{idx}.bias"].any()
            seen += 1
        cin = width
    assert seen == 6 and len(state) == 32
