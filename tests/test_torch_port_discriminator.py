"""Port's Discriminator and its weight bridge against the JAX package's.

Both run on the same weights (the JAX tree through
``io.jax_params.discriminator_params_from_jax``) and the same numpy
inputs. The JAX side is the XLA f32 path (``precision="highest"``,
``fused_norms=False``) and, unmasked, the Pallas swish-InstanceNorm in
interpret mode (``fused_norms=True`` on the CPU backend); the port's side
the plain versions its kernel wrappers run on the CPU. Tolerance
atol = rtol = 1e-5: f32, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.models import Discriminator as JaxDiscriminator
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    discriminator_params_from_jax,
    discriminator_params_to_jax,
)
from maskcyclegan_vc_tpu_torch.models import Discriminator

torch.set_num_threads(1)
R, M, T = 8, 16, 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_params(model, seed):
    params = fast_init(model, seed, jnp.zeros((1, M, T)))
    # fast_init leaves every norm at scale 1, bias 0; draw them instead, so
    # a misplaced affine channel shows.
    rs = np.random.RandomState(seed + 100)

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] == "scale":
            return jnp.asarray(rs.rand(*leaf.shape).astype(np.float32) + 0.5)
        if keys[-1] == "bias" and "norm" in keys:
            return jnp.asarray(rs.randn(*leaf.shape).astype(np.float32) * 0.1)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, params))


@pytest.mark.parametrize("dead", [True, False])
def test_bridge_round_trip_and_strict_load(dead):
    params = _jax_params(JaxDiscriminator(residual_channels=R, include_dead_params=dead), 0)
    assert ("downSample4_conv_kernel" in params["params"]) == dead
    sd = discriminator_params_from_jax(params)
    Discriminator(R, include_dead_params=dead).load_state_dict(sd, strict=True)
    back = discriminator_params_to_jax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    if dead:  # HWIO (1, 10, 4R, 4R) <-> OIHW
        assert sd["downSample4.0.weight"].shape == (4 * R, 4 * R, 1, 10)


def test_reference_state_dict_names():
    names = set(Discriminator(R).state_dict())
    want = {f"{m}.{k}" for m in ("convLayer1.0", "outputConvLayer.0", "downSample1.0",
                                 "downSample1.1", "downSample2.0", "downSample2.1",
                                 "downSample3.0", "downSample3.1", "downSample4.0",
                                 "downSample4.1") for k in ("weight", "bias")}
    assert names == want


def test_parameter_counts_at_defaults():
    d = Discriminator()
    assert sum(p.numel() for p in d.parameters()) == 16_691_713
    assert sum(p.numel() for p in d.live_parameters()) == 6_202_881


def _port(params):
    d = Discriminator(R)
    d.load_state_dict(discriminator_params_from_jax(params), strict=True)
    return d


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    model = JaxDiscriminator(residual_channels=R, precision="highest", fused_norms=fused)
    params = _jax_params(model, 1)
    x = np.random.RandomState(2).randn(3, M, T).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, M // 8, T // 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_masked_forward_matches_jax():
    """``lengths`` (bucketed evaluation): full, odd, short and one frame."""
    model = JaxDiscriminator(residual_channels=R, precision="highest")
    params = _jax_params(model, 3)
    rs = np.random.RandomState(4)
    x = rs.randn(4, M, T).astype(np.float32)
    lengths = np.array([T, 21, 9, 1], np.int32)
    want = np.asarray(model.apply(params, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    valid = (lengths + 7) // 8
    for b, v in enumerate(valid):
        assert not got[b, :, v:].any()


def test_gradients_match_jax():
    """d(sum(w * D(x)))/d(params and x): the K3 Function's backward inside
    the discriminator against jax.grad of the XLA model."""
    model = JaxDiscriminator(residual_channels=R, precision="highest")
    params = _jax_params(model, 5)
    rs = np.random.RandomState(6)
    x = rs.randn(2, M, T).astype(np.float32)
    w = rs.randn(2, M // 8, T // 8).astype(np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(model.apply(p, x) * w), argnums=(0, 1))(
        params, jnp.asarray(x))
    d = _port(params)
    xt = torch.from_numpy(x).requires_grad_()
    live = d.live_parameters()
    grads = torch.autograd.grad((d(xt) * torch.from_numpy(w)).sum(), [xt] + live)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), **TOL)
    names = [n for n, _ in d.named_parameters() if not n.startswith("downSample4.")]
    got = discriminator_params_to_jax(dict(zip(names, grads[1:])))
    assert_grads_close(got, gp)


def assert_grads_close(got, want, rtol=1e-5):
    """Per leaf, |got - want| <= rtol * the largest gradient of the leaf's
    layer (its kernel and bias, or its scale and bias). A conv bias ahead of
    an InstanceNorm has zero gradient in exact arithmetic, so its computed
    value is rounding noise at the scale of the layer's other gradient."""
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    for path in set(flat_want) - {p for p, _ in flat_got}:  # the dead block
        assert "downSample4" in jax.tree_util.keystr(path)
        assert not np.asarray(flat_want[path]).any()
    layer_scale = {}
    for path, leaf in flat_want.items():
        layer = path[:-1]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0), float(np.abs(leaf).max()))
    for path, leaf in flat_got:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_want[path]), rtol=0,
                                   atol=rtol * layer_scale[path[:-1]],
                                   err_msg=jax.tree_util.keystr(path))
