"""Port's pixel-shuffle + IN + swish (ops/ps.py) against the JAX package.

Unmasked, against the Pallas ``subpixel_in_swish`` in interpret mode, whose
input is q-major ((2i+j)*C + c, see tests/test_pallas_ps.py); masked,
against the JAX generator's XLA form ``swish(instance_norm_apply(
pixel_shuffle_nhwc(x), ..., time_mask))``. Tolerance atol = rtol = 1e-5:
the JAX kernel takes one-pass statistics (E[x^2] - E[x]^2), the port
two-pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.ops.layers import instance_norm_apply, pixel_shuffle_nhwc
from maskcyclegan_vc_tpu.ops.layers import swish as jax_swish
from maskcyclegan_vc_tpu.ops.pallas.ps_kernel import subpixel_in_swish
from maskcyclegan_vc_tpu_torch.ops import ps
from maskcyclegan_vc_tpu_torch.ops.ps import (
    pixel_shuffle_in_swish,
    pixel_shuffle_in_swish_plain,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, C, H, W):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, 4 * C, H, W) * 1.5 + 0.3).astype(np.float32)  # torch order
    scale = (rs.rand(C) + 0.5).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    return x, scale, bias


def _torch_order_nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))  # channel c*4 + q


def _q_major_nhwc(x):
    B, C4, H, W = x.shape
    t = _torch_order_nhwc(x).reshape(B, H, W, C4 // 4, 4)
    return np.ascontiguousarray(t.transpose(0, 1, 2, 4, 3).reshape(B, H, W, C4))


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_matches_pallas_subpixel_in_swish(B, C, H, W):
    x, scale, bias = _inputs(0, B, C, H, W)
    want = np.asarray(subpixel_in_swish(jnp.asarray(_q_major_nhwc(x)),
                                        jnp.asarray(scale), jnp.asarray(bias), True))
    got = pixel_shuffle_in_swish(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias))
    assert got.shape == (B, C, 2 * H, 2 * W)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


# Post-shuffle valid lengths: full, even, odd, one frame, none.
@pytest.mark.parametrize("lengths", [[12, 8], [5, 1], [0, 11]])
def test_masked_matches_jax_xla_form(lengths):
    B, C, H, W = 2, 8, 4, 6
    x, scale, bias = _inputs(1, B, C, H, W)
    tm = (np.arange(2 * W)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    y = pixel_shuffle_nhwc(jnp.asarray(_torch_order_nhwc(x)), 2)
    want = np.asarray(jax_swish(instance_norm_apply(
        y, jnp.asarray(scale), jnp.asarray(bias),
        time_mask=jnp.asarray(tm[:, None, :, None]))))
    got = pixel_shuffle_in_swish(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias),
                                 torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(2, 1, 4, 3, 5))
    lengths = torch.tensor([7], dtype=torch.int32)
    before = ps.PS_IN_SWISH_KERNEL.launches
    assert torch.equal(pixel_shuffle_in_swish(x, scale, bias, lengths),
                       pixel_shuffle_in_swish_plain(x, scale, bias, lengths))
    assert ps.PS_IN_SWISH_KERNEL.launches == before


def test_rejects_channels_not_divisible_by_four():
    with pytest.raises(ValueError):
        pixel_shuffle_in_swish(torch.zeros(1, 6, 2, 2), torch.ones(1), torch.zeros(1))
