"""Port's InstanceNorm and IN-GLU (ops/in_gate.py) against the JAX package.

The same numpy inputs go through the JAX Pallas kernels (interpret mode) or
the JAX masked InstanceNorm, and through the port's plain versions, which
the wrappers run for CPU tensors. JAX is (B, S, C) / NHWC, the port NCHW.
Tolerance: atol = rtol = 1e-5, f32 statistics in both, summed in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.ops.layers import instance_norm_apply
from maskcyclegan_vc_tpu.ops.pallas.in_gate_kernel import (
    instance_norm_fused,
    instance_norm_glu_fused,
)
from maskcyclegan_vc_tpu_torch.ops import in_gate
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm,
    instance_norm_glu,
    instance_norm_glu_plain,
    instance_norm_plain,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _vecs(rs, n, C):
    return [(rs.rand(C) + 0.5).astype(np.float32) if i % 2 == 0
            else rs.randn(C).astype(np.float32) for i in range(n)]


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("shape", [(2, 4, 6, 8), (2, 7, 16)])  # NHWC or NLC
def test_instance_norm_matches_pallas(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    s, b = _vecs(rs, 2, shape[-1])
    B, C = shape[0], shape[-1]
    want = np.asarray(instance_norm_fused(
        jnp.asarray(x.reshape(B, -1, C)), jnp.asarray(s), jnp.asarray(b), True))
    got = instance_norm(_nhwc_to_nchw(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1).reshape(B, -1, C),
                               want, **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 6, 8), (2, 7, 16)])
def test_instance_norm_glu_matches_pallas(shape):
    rs = np.random.RandomState(1)
    h = rs.randn(*shape).astype(np.float32)
    g = (rs.randn(*shape) * 3).astype(np.float32)
    sh, bh, sg, bg = _vecs(rs, 4, shape[-1])
    B, C = shape[0], shape[-1]
    want = np.asarray(instance_norm_glu_fused(
        *(jnp.asarray(v) for v in (h.reshape(B, -1, C), g.reshape(B, -1, C),
                                   sh, bh, sg, bg)), True))
    hg = torch.cat([_nhwc_to_nchw(h), _nhwc_to_nchw(g)], dim=1)
    got = instance_norm_glu(hg, *(torch.from_numpy(v) for v in (sh, bh, sg, bg)))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1).reshape(B, -1, C),
                               want, **TOL)


def _jax_time_mask(lengths, W, ndim):
    # (B, 1, W, 1) for NHWC, (B, W, 1) for NLC: 1 at valid frames.
    t = np.arange(W)[None, :] < np.asarray(lengths)[:, None]
    m = t.astype(np.float32)
    return jnp.asarray(m[:, None, :, None] if ndim == 4 else m[:, :, None])


# lengths cover a full row, a partial row, a single frame and none at all.
@pytest.mark.parametrize("shape,lengths", [((2, 4, 6, 8), [6, 3]),
                                           ((2, 7, 16), [1, 0]),
                                           ((3, 9, 5), [9, 4, 8])])
def test_masked_instance_norm_matches_jax(shape, lengths):
    rs = np.random.RandomState(2)
    x = (rs.randn(*shape) + 1.0).astype(np.float32)
    s, b = _vecs(rs, 2, shape[-1])
    W = shape[-2]
    want = np.asarray(instance_norm_apply(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
        time_mask=_jax_time_mask(lengths, W, x.ndim)))
    # JAX NHWC has time on axis 2 (W) -> the port's last axis.
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    got = instance_norm(xt, torch.from_numpy(s), torch.from_numpy(b),
                        torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **TOL)


@pytest.mark.parametrize("shape,lengths", [((2, 4, 6, 8), [5, 2]),
                                           ((2, 7, 16), [7, 0])])
def test_masked_instance_norm_glu_matches_jax(shape, lengths):
    """The masked GatedConv2d / ResidualBlock epilogue of the JAX package:
    norm_h(h, tm) * sigmoid(norm_g(g, tm))."""
    rs = np.random.RandomState(3)
    h = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    sh, bh, sg, bg = _vecs(rs, 4, shape[-1])
    tm = _jax_time_mask(lengths, shape[-2], len(shape))
    want = np.asarray(
        instance_norm_apply(jnp.asarray(h), jnp.asarray(sh), jnp.asarray(bh), tm)
        * jax.nn.sigmoid(instance_norm_apply(jnp.asarray(g), jnp.asarray(sg),
                                             jnp.asarray(bg), tm)))
    hg = torch.cat([_nhwc_to_nchw(h), _nhwc_to_nchw(g)], dim=1)
    got = instance_norm_glu(hg, *(torch.from_numpy(v) for v in (sh, bh, sg, bg)),
                            torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **TOL)


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    rs = np.random.RandomState(4)
    hg = torch.from_numpy(rs.randn(1, 8, 3, 5).astype(np.float32))
    v = torch.ones(4)
    lengths = torch.tensor([3], dtype=torch.int32)
    before = (in_gate.IN_KERNEL.launches, in_gate.IN_GLU_KERNEL.launches)
    assert torch.equal(instance_norm(hg, torch.ones(8), torch.zeros(8), lengths),
                       instance_norm_plain(hg, torch.ones(8), torch.zeros(8), lengths))
    assert torch.equal(instance_norm_glu(hg, v, v, v, v, lengths),
                       instance_norm_glu_plain(hg, v, v, v, v, lengths))
    assert (in_gate.IN_KERNEL.launches, in_gate.IN_GLU_KERNEL.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "lengths_dtype", "vec_shape",
                                 "noncontiguous", "ndim"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros(2, 4, 3, 5)
    s, b = torch.ones(4), torch.zeros(4)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    if bad == "dtype":
        x = x.double()
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "vec_shape":
        s = torch.ones(5)
    elif bad == "noncontiguous":
        x = x.transpose(2, 3)
    else:
        x = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        instance_norm(x, s, b, lengths)
