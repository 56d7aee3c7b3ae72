"""The port's norm kernels with gradients (ops/in_gate.py, ops/ps.py) against
the JAX package.

The same numpy inputs and cotangents go through ``jax.vjp`` of the Pallas
custom_vjps (interpret mode: ``instance_norm_fused``,
``instance_norm_swish_fused``, ``instance_norm_glu_fused``,
``subpixel_in_swish``, whose backward at these sizes is the fused
``_sis_bwd_pallas``) and through the port's autograd Functions, whose
forwards run the plain versions on the CPU and whose backwards are the
same code the card runs (K5's plain version stands in for the kernel).
The Functions are also held against torch autograd through the plain
forwards, and K5's plain version against ``_sis_bwd_xla``. Past the
per-sample budget both packages take the split backward (the inverse
shuffle K6, then the gradient from one-pass statistics): the port's against
``_sis_bwd_xla`` and the dispatch against JAX's, both budgets patched low,
and the budget's byte count against JAX's at the full width. Tolerance
atol = rtol = 1e-5: f32 on both sides, the same formulas, statistics and
sums taken in another order (the JAX pixel-shuffle kernel's statistics
are one-pass, the port's two-pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.ops.layers import instance_norm_apply
from maskcyclegan_vc_tpu.ops.layers import swish as jax_swish
from maskcyclegan_vc_tpu.ops.pallas.in_gate_kernel import (
    instance_norm_fused,
    instance_norm_glu_fused,
    instance_norm_swish_fused,
)
from maskcyclegan_vc_tpu.ops.pallas import ps_kernel
from maskcyclegan_vc_tpu.ops.pallas.ps_kernel import _sis_bwd_xla, subpixel_in_swish
from maskcyclegan_vc_tpu_torch.ops import in_gate, ps
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm,
    instance_norm_glu,
    instance_norm_glu_plain,
    instance_norm_plain,
    instance_norm_swish,
    instance_norm_swish_plain,
)
from maskcyclegan_vc_tpu_torch.ops.ps import (
    pixel_shuffle_in_swish,
    pixel_shuffle_in_swish_backward,
    pixel_shuffle_in_swish_backward_bytes,
    pixel_shuffle_in_swish_backward_plain,
    pixel_shuffle_in_swish_backward_split,
    pixel_shuffle_in_swish_plain,
    pixel_shuffle_stats_plain,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _vecs(rs, n, C):
    return [(rs.rand(C) + 0.5).astype(np.float32) if i % 2 == 0
            else rs.randn(C).astype(np.float32) for i in range(n)]


def _nchw(x):
    """NHWC / NLC numpy -> NCHW / NCL torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _jvp(fn, primals, cotangent):
    _, vjp = jax.vjp(fn, *(jnp.asarray(p) for p in primals))
    return [np.asarray(g) for g in vjp(jnp.asarray(cotangent))]


def _torch_grads(fn, tensors, cotangent):
    leaves = [t.clone().requires_grad_() for t in tensors]
    out = fn(*leaves)
    return list(torch.autograd.grad(out, leaves, cotangent))


SHAPES = [(2, 4, 6, 8), (2, 7, 16)]  # NHWC and NLC


@pytest.mark.parametrize("shape", SHAPES)
def test_instance_norm_swish_matches_pallas(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    s, b = _vecs(rs, 2, shape[-1])
    B, C = shape[0], shape[-1]
    want = np.asarray(instance_norm_swish_fused(
        jnp.asarray(x.reshape(B, -1, C)), jnp.asarray(s), jnp.asarray(b), True))
    got = instance_norm_swish(_nchw(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got).reshape(B, -1, C), want, **TOL)


@pytest.mark.parametrize("shape,lengths", [((2, 4, 6, 8), [6, 3]),
                                           ((3, 9, 5), [9, 1, 0])])
def test_masked_instance_norm_swish_matches_jax(shape, lengths):
    """The discriminator's masked epilogue: swish(instance_norm_apply(..., tm))."""
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) + 1.0).astype(np.float32)
    s, b = _vecs(rs, 2, shape[-1])
    t = (np.arange(shape[-2])[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    tm = t[:, None, :, None] if len(shape) == 4 else t[:, :, None]
    want = np.asarray(jax_swish(instance_norm_apply(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), time_mask=jnp.asarray(tm))))
    got = instance_norm_swish(_nchw(x), torch.from_numpy(s), torch.from_numpy(b),
                              torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def _norm_case(kind, shape, seed):
    """Inputs, the JAX function on (B, S, C), the port's Function and its
    plain forward, and how the port's gradients map onto JAX's."""
    rs = np.random.RandomState(seed)
    B, C = shape[0], shape[-1]
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    if kind == "glu":
        g = (rs.randn(*shape) * 2.0).astype(np.float32)
        vecs = _vecs(rs, 4, C)
        jax_args = [x.reshape(B, -1, C), g.reshape(B, -1, C), *vecs]
        jax_fn = lambda h, g, a, b, c, d: instance_norm_glu_fused(h, g, a, b, c, d, True)  # noqa: E731
        torch_in = [torch.cat([_nchw(x), _nchw(g)], dim=1)] + [torch.from_numpy(v) for v in vecs]
        return rs, jax_args, jax_fn, instance_norm_glu, instance_norm_glu_plain, torch_in
    vecs = _vecs(rs, 2, C)
    jax_args = [x.reshape(B, -1, C), *vecs]
    fused = {"in": instance_norm_fused, "swish": instance_norm_swish_fused}[kind]
    jax_fn = lambda x, a, b: fused(x, a, b, True)  # noqa: E731
    fn, plain = {"in": (instance_norm, instance_norm_plain),
                 "swish": (instance_norm_swish, instance_norm_swish_plain)}[kind]
    return rs, jax_args, jax_fn, fn, plain, [_nchw(x)] + [torch.from_numpy(v) for v in vecs]


@pytest.mark.parametrize("kind", ["in", "swish", "glu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_gradients_match_jax_custom_vjp(kind, shape):
    """K1, K2, K3: dx (for K1 the (B, 2C, ...) pair), dscale and dbias."""
    rs, jax_args, jax_fn, fn, _, torch_in = _norm_case(kind, shape, 2)
    out_shape = shape
    dy = rs.randn(*out_shape).astype(np.float32)
    B, C = shape[0], shape[-1]
    want = _jvp(jax_fn, jax_args, dy.reshape(B, -1, C))
    got = _torch_grads(fn, torch_in, _nchw(dy))
    if kind == "glu":
        dh, dg = got[0].chunk(2, dim=1)
        got_x = [_nhwc(dh).reshape(B, -1, C), _nhwc(dg).reshape(B, -1, C)]
        got = got_x + [g.numpy() for g in got[1:]]
    else:
        got = [_nhwc(got[0]).reshape(B, -1, C)] + [g.numpy() for g in got[1:]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kind", ["in", "swish", "glu"])
def test_norm_functions_match_torch_autograd(kind):
    rs, _, _, fn, plain, torch_in = _norm_case(kind, (3, 5, 4, 6), 3)
    dy = torch.from_numpy(rs.randn(*fn(*torch_in).shape).astype(np.float32))
    for a, b in zip(_torch_grads(fn, torch_in, dy), _torch_grads(plain, torch_in, dy)):
        torch.testing.assert_close(a, b, **TOL)


def _ps_inputs(seed, B, C, H, W):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, 4 * C, H, W) * 1.5 + 0.3).astype(np.float32)  # torch order
    s, b = (rs.rand(C) + 0.5).astype(np.float32), rs.randn(C).astype(np.float32)
    dy = rs.randn(B, C, 2 * H, 2 * W).astype(np.float32)
    return x, s, b, dy


def _q_major_nhwc(x):
    """torch PixelShuffle order c*4+q, NCHW -> JAX's q-major (q*C + c) NHWC."""
    B, C4, H, W = x.shape
    t = x.transpose(0, 2, 3, 1).reshape(B, H, W, C4 // 4, 4)
    return np.ascontiguousarray(t.transpose(0, 1, 2, 4, 3).reshape(B, H, W, C4))


def _from_q_major_nhwc(d):
    B, H, W, C4 = d.shape
    t = d.reshape(B, H, W, 4, C4 // 4).transpose(0, 1, 2, 4, 3).reshape(B, H, W, C4)
    return np.ascontiguousarray(t.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_pixel_shuffle_in_swish_gradient_matches_pallas_fused_backward(B, C, H, W):
    """K4's Function, whose backward is K5's plain version on the CPU, against
    jax.vjp of subpixel_in_swish, whose backward at this size is the fused
    Pallas kernel _sis_bwd_pallas."""
    x, s, b, dy = _ps_inputs(0, B, C, H, W)
    want = _jvp(lambda x, s, b: subpixel_in_swish(x, s, b, True),
                [_q_major_nhwc(x), s, b], dy.transpose(0, 2, 3, 1))
    got = _torch_grads(pixel_shuffle_in_swish,
                       [torch.from_numpy(a) for a in (x, s, b)], torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), _from_q_major_nhwc(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], **TOL)


def test_pixel_shuffle_in_swish_function_matches_torch_autograd():
    x, s, b, dy = (torch.from_numpy(a) for a in _ps_inputs(1, 3, 4, 5, 3))
    got = _torch_grads(pixel_shuffle_in_swish, [x, s, b], dy)
    want = _torch_grads(pixel_shuffle_in_swish_plain, [x, s, b], dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


def test_backward_plain_matches_jax_xla_backward():
    """K5's plain version, fed the forward's statistics, against
    _sis_bwd_xla, the JAX package's unfused form of the same backward."""
    x, s, b, dy = _ps_inputs(2, 2, 8, 4, 6)
    want = _sis_bwd_xla(jnp.asarray(_q_major_nhwc(x)), jnp.asarray(dy.transpose(0, 2, 3, 1)),
                        jnp.asarray(s), jnp.asarray(b), True)
    xt = torch.from_numpy(x)
    mean, inv = pixel_shuffle_stats_plain(xt)
    got = pixel_shuffle_in_swish_backward_plain(xt, torch.from_numpy(dy), torch.from_numpy(s),
                                                torch.from_numpy(b), mean, inv)
    np.testing.assert_allclose(got[0].numpy(), _from_q_major_nhwc(np.asarray(want[0])), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)


def test_forward_statistics_match_the_shuffled_tensor():
    x, s, b, _ = (torch.from_numpy(a) for a in _ps_inputs(3, 2, 4, 3, 5))
    y, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    shuffled = torch.nn.functional.pixel_shuffle(x, 2)
    torch.testing.assert_close(mean, shuffled.mean((2, 3)), **TOL)
    torch.testing.assert_close(inv, torch.rsqrt(shuffled.var((2, 3), unbiased=False) + 1e-5),
                               **TOL)
    torch.testing.assert_close(y, pixel_shuffle_in_swish_plain(x, s, b), **TOL)


def test_backward_takes_a_noncontiguous_cotangent():
    x, s, b, dy = (torch.from_numpy(a) for a in _ps_inputs(4, 2, 4, 3, 5))
    mean, inv = pixel_shuffle_stats_plain(x)
    big = torch.cat([dy, dy]).transpose(2, 3).contiguous().transpose(2, 3)
    got = pixel_shuffle_in_swish_backward(x, big[:2], s, b, mean, inv)
    want = pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_split_backward_matches_jax_xla_backward(B, C, H, W):
    """The split route: K6 (its plain version here) on dy, then the gradient
    from statistics recomputed from x, against ``_sis_bwd_xla``."""
    x, s, b, dy = _ps_inputs(6, B, C, H, W)
    want = _sis_bwd_xla(jnp.asarray(_q_major_nhwc(x)), jnp.asarray(dy.transpose(0, 2, 3, 1)),
                        jnp.asarray(s), jnp.asarray(b), True)
    got = pixel_shuffle_in_swish_backward_split(*(torch.from_numpy(a) for a in (x, dy, s, b)))
    np.testing.assert_allclose(got[0].numpy(), _from_q_major_nhwc(np.asarray(want[0])), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)


def _routes(monkeypatch):
    """Count the port's backward routes: {"fused": n, "split": n}."""
    taken = {"fused": 0, "split": 0}
    for name, route in (("pixel_shuffle_in_swish_backward", "fused"),
                        ("pixel_shuffle_in_swish_backward_split", "split")):
        real = getattr(ps, name)

        def spy(*args, _real=real, _route=route):
            taken[_route] += 1
            return _real(*args)
        monkeypatch.setattr(ps, name, spy)
    return taken


@pytest.mark.parametrize("budget", ["patched", "default"])
def test_backward_route_follows_the_budget(monkeypatch, budget):
    """With both budgets below one sample, the port's gradient takes the
    split route and equals jax.vjp of ``subpixel_in_swish``, whose backward
    then takes ``_sis_bwd_xla``; at the default budget both take the fused
    route (K5, ``_sis_bwd_pallas``)."""
    x, s, b, dy = _ps_inputs(7, 2, 4, 3, 5)
    taken = _routes(monkeypatch)
    jax_split = []
    real_xla = ps_kernel._sis_bwd_xla
    monkeypatch.setattr(ps_kernel, "_sis_bwd_xla",
                        lambda *a: jax_split.append(1) or real_xla(*a))
    if budget == "patched":
        monkeypatch.setattr(ps, "BWD_BUDGET_BYTES", pixel_shuffle_in_swish_backward_bytes(
            torch.from_numpy(x)) - 1)
        monkeypatch.setattr(ps_kernel, "_BWD_VMEM_BUDGET", 0)
    want = _jvp(lambda x, s, b: subpixel_in_swish(x, s, b, True),
                [_q_major_nhwc(x), s, b], dy.transpose(0, 2, 3, 1))
    got = _torch_grads(pixel_shuffle_in_swish, [torch.from_numpy(a) for a in (x, s, b)],
                       torch.from_numpy(dy))
    split = budget == "patched"
    assert taken == {"fused": int(not split), "split": int(split)}
    assert len(jax_split) == int(split)
    np.testing.assert_allclose(got[0].numpy(), _from_q_major_nhwc(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], **TOL)


def _upsample_inputs(frames: int):
    """The full-width generator's two upsample conv outputs, per sample, at
    ``frames``: (4C, H, W) of upSample1 and upSample2 (80 mels, R = 256; two
    stride-2 convs take W to ceil(ceil(T / 2) / 2))."""
    w = -(-(-(-frames // 2)) // 2)
    return (1024, 20, w), (512, 40, 2 * w)


@pytest.mark.parametrize("batch,frames,split", [(1, 128, (False, False)),
                                                (32, 128, (False, False)),
                                                (1, 136, (False, False)),
                                                (1, 137, (False, True)),
                                                (1, 192, (False, True)),
                                                (1, 272, (False, True)),
                                                (1, 273, (True, True)),
                                                (2, 320, (True, True))])
def test_backward_budget_bytes_match_jax(batch, frames, split):
    """``pixel_shuffle_in_swish_backward_bytes`` against ``_sis_bwd_vmem_bytes``
    on the full-width shapes, and which of the two upsample stages pass the
    budget (upSample2 from 137 frames, upSample1 from 273, where W = 69 first
    makes 6 x 4 x 1024 x 20 x W bytes exceed 32 MiB; the 32 x 128 shape stays
    under it)."""
    for (C4, H, W), want_split in zip(_upsample_inputs(frames), split):
        x = torch.empty((batch, C4, H, W), device="meta")
        jx = jax.ShapeDtypeStruct((batch, H, W, C4), jnp.float32)
        jdy = jax.ShapeDtypeStruct((batch, 2 * H, 2 * W, C4 // 4), jnp.float32)
        got = pixel_shuffle_in_swish_backward_bytes(x)
        assert got == ps_kernel._sis_bwd_vmem_bytes(jx, jdy)
        assert ps.BWD_BUDGET_BYTES == ps_kernel._BWD_VMEM_BUDGET
        assert (got > ps.BWD_BUDGET_BYTES) == want_split, (frames, C4)


def test_cpu_gradients_launch_no_kernel():
    counters = (in_gate.IN_KERNEL, in_gate.IN_SWISH_KERNEL, in_gate.IN_GLU_KERNEL,
                *(e for k in ("in_bwd", "in_swish_bwd", "in_glu_bwd")
                  for e in in_gate.ENTRIES[k].values()),
                ps.PS_IN_SWISH_KERNEL, ps.PS_IN_SWISH_BWD_KERNEL, ps.INV_SHUFFLE_KERNEL)
    before = [c.launches for c in counters]
    x, s, b, dy = (torch.from_numpy(a) for a in _ps_inputs(5, 1, 4, 3, 5))
    _torch_grads(pixel_shuffle_in_swish, [x, s, b], dy)
    pixel_shuffle_in_swish_backward_split(x, dy, s, b)
    h = torch.randn(1, 8, 3, 5)
    for fn, vecs in ((instance_norm, 2), (instance_norm_swish, 2)):
        _torch_grads(fn, [h] + [torch.ones(8)] * vecs, torch.ones_like(h))
    _torch_grads(instance_norm_glu, [h] + [torch.ones(4)] * 4, torch.ones(1, 4, 3, 5))
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("fn,n", [(instance_norm, 2), (instance_norm_swish, 2),
                                  (instance_norm_glu, 4), (pixel_shuffle_in_swish, 2)])
def test_masked_call_with_grad_raises(fn, n):
    """No training path runs the masked functions, so they have no backward:
    a call that would need one raises instead of returning a wrong gradient."""
    x = torch.randn(2, 8, 3, 6, requires_grad=True)
    C = 2 if fn is pixel_shuffle_in_swish else (4 if n == 4 else 8)
    lengths = torch.tensor([6, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        fn(x, *[torch.ones(C)] * n, lengths)
    with torch.no_grad():
        fn(x, *[torch.ones(C)] * n, lengths)
