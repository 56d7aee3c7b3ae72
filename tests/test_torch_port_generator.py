"""Port's Generator and weight bridge against the JAX package's Generator.

Both run on the same weights (the JAX tree through
``io.jax_params.generator_params_from_jax``) and the same numpy inputs. The
JAX side is the XLA f32 path (``fused_norms=False``, ``precision="highest"``),
the port's the plain versions its kernel wrappers run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.models import Generator as JaxGenerator
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    generator_params_from_jax,
    generator_params_to_jax,
)
from maskcyclegan_vc_tpu_torch.models import Generator

torch.set_num_threads(1)
SMALL = dict(n_mels=8, residual_channels=8, num_residual_blocks=2)


def _jax_params(model, seed, T):
    x = jnp.zeros((1, model.n_mels, T))
    params = fast_init(model, seed, x, jnp.ones_like(x))
    # fast_init leaves every norm at scale 1, bias 0; draw them instead, so
    # a misplaced affine channel shows.
    rs = np.random.RandomState(seed + 100)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return jnp.asarray(rs.rand(*leaf.shape).astype(np.float32) + 0.5)
        if name == "bias" and "conv" not in [getattr(p, "key", "") for p in path]:
            return jnp.asarray(rs.randn(*leaf.shape).astype(np.float32) * 0.1)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def _port(jax_params, **kw):
    g = Generator(**kw)
    g.load_state_dict(generator_params_from_jax(jax.tree.map(np.asarray, jax_params)),
                      strict=True)
    return g.eval()


def test_bridge_round_trip_and_strict_load():
    model = JaxGenerator(**SMALL)
    params = jax.tree.map(np.asarray, _jax_params(model, 0, 16))
    sd = generator_params_from_jax(params)
    Generator(**SMALL).load_state_dict(sd, strict=True)
    back = generator_params_to_jax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_state_dict_round_trip_through_jax_layout():
    g = Generator(**SMALL, generator=torch.Generator().manual_seed(3))
    sd = generator_params_from_jax(generator_params_to_jax(g.state_dict()))
    assert sd.keys() == g.state_dict().keys()
    for k, v in g.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_parameter_count_at_defaults():
    g = Generator()
    assert sum(p.numel() for p in g.parameters()) == 24_537_729


def test_seeded_init_is_reproducible_and_distinct():
    a = Generator(**SMALL, generator=torch.Generator().manual_seed(1))
    b = Generator(**SMALL, generator=torch.Generator().manual_seed(1))
    c = Generator(**SMALL, generator=torch.Generator().manual_seed(2))
    w = "downSample1.convLayer.0.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax_small(masked):
    model = JaxGenerator(**SMALL, precision="highest")
    T = 32
    params = _jax_params(model, 1, T)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, T).astype(np.float32)
    mask = np.ones_like(x)
    mask[1, :, 5:9] = 0.0
    lengths = np.array([13, 30], np.int32) if masked else None
    want = np.asarray(model.apply(
        params, jnp.asarray(x), jnp.asarray(mask),
        lengths=None if lengths is None else jnp.asarray(lengths)))
    with torch.no_grad():
        got = _port(params, **SMALL)(
            torch.from_numpy(x), torch.from_numpy(mask),
            None if lengths is None else torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if masked:
        assert not got[0, :, 13:].any() and not got[1, :, 30:].any()


def test_forward_matches_jax_full_width():
    """R=256, 6 blocks, 80 mels, T=64. Bound on the relative mean error:
    at random init ~20 chained IN+gate layers amplify the 1e-7 rounding
    differences of two conv libraries chaotically (see
    tests/test_models.py:83-92), so the full-width bound is looser than the
    small model's exact match."""
    model = JaxGenerator(precision="highest")
    T = 64
    params = _jax_params(model, 2, T)
    rs = np.random.RandomState(6)
    x = rs.randn(1, 80, T).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: model.apply(p, x, jnp.ones_like(x)))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = _port(params)(xt, torch.ones_like(xt)).numpy()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel < 1e-4, rel
