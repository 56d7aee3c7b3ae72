"""The port's bf16 training path against the JAX package's on the CPU.

The same numpy inputs, rounded to bf16 once, go through the JAX Pallas
kernels (interpret mode) and through the port's plain versions, which its
wrappers run for CPU tensors; the models, a 20-step trajectory and the train
CLI then run in bf16 as the JAX trainer's production path does
(``dtype=bfloat16``, ``fused_norms=True``).

Tolerances:
- bf16 outputs (y, dx), ``ONE``: one bf16 rounding apart, rtol 2**-7 and
  atol 1e-5. Both sides compute in f32 from the same bf16 inputs and round
  once; f32 values a few ulps apart can round to neighbouring bf16 values,
  one bf16 spacing (at most 2**-7 of the value) apart.
- K5's dx (``assert_k5_dx_close``): two roundings, rtol 2**-6 of the larger
  of |dx| and |a dz|. dx is computed from dz rounded to bf16 (the value K5
  and the Pallas kernel park in dx), and the two sides may round dz to
  neighbouring bf16 values; that difference reaches dx times a = scale *
  inv, whatever the size of dx itself.
- f32 outputs (mean, inv, dscale, dbias), ``F32``: atol = rtol = 1e-5.
- K6 and K7: permutations, exact.
- Models: with e(a, b) = max|a - b| / max|b|, the port's bf16 forward is
  held to e(port_bf16, jax_bf16) <= 2 e(jax_bf16, jax_f32) + 1e-3: the two
  bf16 paths round in other places (JAX's XLA convolutions and the port's
  torch CPU convolutions), so their distance is of the order of each one's
  distance from f32. Measured: generator 1.74e-2 against JAX's own
  1.32e-2 (bound 2.74e-2), discriminator 3.61e-3 against 3.77e-3.
- Trajectory: the bounds of ``tests/test_bf16_dynamics.py``, over its 20
  steps, batches and configuration (8 mels x 8 frames, R = 8; gradients
  are not compared, so the size's ill-conditioning for them does not
  matter): finite losses, both dtypes improve, g and d losses within 0.15
  relative of the port's f32 run and of JAX's bf16 run from the same
  initial weights. Measured: g 2.5e-2 and d 4.3e-6 from the port's f32
  run, g 1.6e-2 and d 3.6e-6 from JAX's bf16 run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bf16_dynamics import N_STEPS, _batches
from test_torch_port_discriminator import _jax_params as jax_discriminator_params
from test_torch_port_generator import _jax_params as jax_generator_params
from test_torch_port_train_ops import _from_q_major_nhwc, _nchw, _nhwc, _q_major_nhwc, _vecs
from test_torch_port_train_step import port_state_from_jax
from test_torch_port_trainer import _args, corpus  # noqa: F401 (a fixture)

from maskcyclegan_vc_tpu.cli.test import main as jax_convert_main
from maskcyclegan_vc_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from maskcyclegan_vc_tpu.models import Discriminator as JaxDiscriminator
from maskcyclegan_vc_tpu.models import Generator as JaxGenerator
from maskcyclegan_vc_tpu.ops.pallas import ps_kernel
from maskcyclegan_vc_tpu.ops.pallas.in_gate_kernel import (
    instance_norm_fused,
    instance_norm_glu_fused,
    instance_norm_swish_fused,
)
from maskcyclegan_vc_tpu.train.schedules import ScheduleConfig as JaxScheduleConfig
from maskcyclegan_vc_tpu.train.state import TrainConfig as JaxTrainConfig
from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
from maskcyclegan_vc_tpu.train.step import make_jit_train_step as jax_make_train_step
from maskcyclegan_vc_tpu_torch.cli.test import main as convert_main
from maskcyclegan_vc_tpu_torch.cli.train import main as train_main
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    discriminator_params_from_jax,
    generator_params_from_jax,
)
from maskcyclegan_vc_tpu_torch.models import Discriminator, Generator
from maskcyclegan_vc_tpu_torch.ops import layers, ps
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm,
    instance_norm_glu,
    instance_norm_swish,
)
from maskcyclegan_vc_tpu_torch.train import schedules
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig
from maskcyclegan_vc_tpu_torch.train.step import make_train_step
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer
from maskcyclegan_vc_tpu_torch.utils.device import allows_tf32, precision_scope

torch.set_num_threads(1)
ONE = dict(rtol=2 ** -7, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(2, 4, 6, 8), (2, 7, 16)]  # NHWC and NLC


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (round to nearest even), as f32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _jbf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a: np.ndarray) -> torch.Tensor:
    """NHWC / NLC numpy -> NCHW / NCL bf16 torch."""
    return _nchw(a).bfloat16()


def _f(t: torch.Tensor) -> np.ndarray:
    """NCHW bf16 torch -> NHWC f32 numpy."""
    return _nhwc(t.float())


# ---------- K1-K3: forwards and their backward Functions ----------

def _norm_case(kind, shape, seed):
    rs = np.random.RandomState(seed)
    B, C = shape[0], shape[-1]
    x = _bf16(rs.randn(*shape) * 1.5 + 0.3)
    dy = _bf16(rs.randn(*shape))
    if kind == "glu":
        g = _bf16(rs.randn(*shape) * 2.0)
        vecs = _vecs(rs, 4, C)
        jax_args = [_jbf(x.reshape(B, -1, C)), _jbf(g.reshape(B, -1, C))] + [jnp.asarray(v)
                                                                            for v in vecs]
        jax_fn = lambda h, g, a, b, c, d: instance_norm_glu_fused(h, g, a, b, c, d, True)  # noqa: E731
        port_in = [torch.cat([_t(x), _t(g)], dim=1)] + [torch.from_numpy(v) for v in vecs]
        return jax_args, jax_fn, instance_norm_glu, port_in, dy
    vecs = _vecs(rs, 2, C)
    jax_args = [_jbf(x.reshape(B, -1, C))] + [jnp.asarray(v) for v in vecs]
    fused = {"in": instance_norm_fused, "swish": instance_norm_swish_fused}[kind]
    jax_fn = lambda x, a, b: fused(x, a, b, True)  # noqa: E731
    fn = {"in": instance_norm, "swish": instance_norm_swish}[kind]
    return jax_args, jax_fn, fn, [_t(x)] + [torch.from_numpy(v) for v in vecs], dy


@pytest.mark.parametrize("kind", ["in", "swish", "glu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_forward_matches_pallas_in_bf16(kind, shape):
    """K2, K3, K1: bf16 in, bf16 out, one rounding from JAX's kernel."""
    jax_args, jax_fn, fn, port_in, _ = _norm_case(kind, shape, 0)
    B, C = shape[0], shape[-1]
    want = jax_fn(*jax_args)
    got = fn(*port_in)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f(got).reshape(B, -1, C), _np(want), **ONE)


@pytest.mark.parametrize("kind", ["in", "swish", "glu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_backward_matches_jax_vjp_in_bf16(kind, shape):
    """The Functions' backwards against jax.vjp of the custom_vjps: dx in
    bf16 (for K1 the (B, 2C, ...) pair), dscale and dbias in f32."""
    jax_args, jax_fn, fn, port_in, dy = _norm_case(kind, shape, 1)
    B, C = shape[0], shape[-1]
    _, vjp = jax.vjp(jax_fn, *jax_args)
    want = [_np(g) for g in vjp(_jbf(dy.reshape(B, -1, C)))]
    leaves = [t.clone().requires_grad_() for t in port_in]
    got = list(torch.autograd.grad(fn(*leaves), leaves, _t(dy)))
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    if kind == "glu":
        got = [_f(d).reshape(B, -1, C) for d in got[0].chunk(2, dim=1)] + got[1:]
    else:
        got = [_f(got[0]).reshape(B, -1, C)] + got[1:]
    n_x = 2 if kind == "glu" else 1
    for i, (a, b) in enumerate(zip(got, want)):
        if i < n_x:
            np.testing.assert_allclose(a, b, **ONE)
        else:
            np.testing.assert_allclose(a.numpy(), b, **F32)


def test_masked_instance_norm_in_bf16_matches_jax_xla_form():
    """The masked norm (bucketed conversion's) in bf16 against JAX's
    ``instance_norm_apply``: f32 statistics, one rounding, zeros past the
    lengths."""
    from maskcyclegan_vc_tpu.ops.layers import instance_norm_apply

    rs = np.random.RandomState(2)
    x = _bf16(rs.randn(3, 4, 9, 5) + 1.0)
    s, b = _vecs(rs, 2, 5)
    lengths = [9, 4, 1]
    tm = (np.arange(9)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    want = instance_norm_apply(_jbf(x), jnp.asarray(s), jnp.asarray(b),
                               time_mask=jnp.asarray(tm[:, None, :, None]))
    got = instance_norm(_t(x), torch.from_numpy(s), torch.from_numpy(b),
                        torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(_f(got), _np(want), **ONE)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_wrappers_reject_other_dtypes(dtype):
    x = torch.zeros(2, 8, 3, 5, dtype=dtype)
    with pytest.raises(ValueError):
        instance_norm(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError):
        ps.pixel_shuffle_in_swish(x, torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError):  # bf16 x with bf16 vectors: the vectors are f32
        instance_norm(x.bfloat16(), torch.ones(8).bfloat16(), torch.zeros(8).bfloat16())


# ---------- K4-K7 ----------

def _ps_case(seed, B, C, H, W):
    rs = np.random.RandomState(seed)
    x = _bf16(rs.randn(B, 4 * C, H, W) * 1.5 + 0.3)  # torch order, NCHW
    s, b = (rs.rand(C) + 0.5).astype(np.float32), rs.randn(C).astype(np.float32)
    dy = _bf16(rs.randn(B, C, 2 * H, 2 * W))
    return x, s, b, dy


def _tb(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def assert_k5_dx_close(got, want, a_dz):
    """K5's dx within 1e-5 + 2**-6 max(|dx|, |a dz|) (module docstring)."""
    bound = 1e-5 + 2 ** -6 * np.maximum(np.abs(want), np.abs(a_dz))
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), f"worst excess {excess.max():.3g} at {np.argmax(excess)}"


def _a_dz(x, dy, s, b, mean, inv):
    """a * dz of each element, in x's layout (B, 4C, H, W), f32."""
    B, C4, H, W = x.shape
    xs = torch.from_numpy(x).reshape(B, C4 // 4, -1)
    a = torch.from_numpy(s)[None, :, None] * torch.from_numpy(inv)[..., None]
    z = xs * a + (torch.from_numpy(b)[None, :, None] - torch.from_numpy(mean)[..., None] * a)
    sg = torch.sigmoid(z)
    dys = torch.nn.functional.pixel_unshuffle(torch.from_numpy(dy), 2).reshape(xs.shape)
    return (a * dys * (sg + z * sg * (1 - sg))).reshape(x.shape).numpy()


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_pixel_shuffle_in_swish_forward_and_backward_match_pallas_in_bf16(B, C, H, W):
    """K4 (y, and its f32 statistics) against ``_sis_fwd_impl``; K5's plain
    version against ``_sis_bwd_pallas`` from the same bf16 x and dy and
    JAX's own statistics."""
    x, s, b, dy = _ps_case(0, B, C, H, W)
    xq = _jbf(_q_major_nhwc(x))
    y, mean, inv = ps_kernel._sis_fwd_impl(xq, jnp.asarray(s), jnp.asarray(b), True)
    got_y, got_mean, got_inv = ps.pixel_shuffle_in_swish_with_stats(
        _tb(x), torch.from_numpy(s), torch.from_numpy(b))
    assert got_y.dtype == torch.bfloat16 and got_mean.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy().transpose(0, 2, 3, 1), _np(y), **ONE)
    mean, inv = np.asarray(mean)[:, 0], np.asarray(inv)[:, 0]
    np.testing.assert_allclose(got_mean.numpy(), mean, **F32)
    np.testing.assert_allclose(got_inv.numpy(), inv, **F32)

    dx, dsc, dbi = ps_kernel._sis_bwd_pallas(
        xq, _jbf(dy.transpose(0, 2, 3, 1)), jnp.asarray(s), jnp.asarray(b),
        jnp.asarray(mean[:, None]), jnp.asarray(inv[:, None]), True)
    assert dx.dtype == jnp.bfloat16
    got = ps.pixel_shuffle_in_swish_backward(_tb(x), _tb(dy), torch.from_numpy(s),
                                             torch.from_numpy(b), torch.from_numpy(mean),
                                             torch.from_numpy(inv))
    assert got[0].dtype == torch.bfloat16
    assert_k5_dx_close(got[0].float().numpy(), _from_q_major_nhwc(_np(dx)),
                       _a_dz(x, dy, s, b, mean, inv))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dsc), **F32)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dbi), **F32)


def test_k5_plain_rounds_the_parked_dz():
    """In bf16 the plain backward takes dx from dz rounded to bf16, as K5
    and the Pallas kernel do; in f32 nothing is rounded. Its dx is the f32
    formula's within the second rounding's bound, and not always equal to
    it rounded once."""
    x, s, b, dy = _ps_case(5, 2, 8, 4, 6)
    mean, inv = (t.numpy() for t in ps.pixel_shuffle_stats_plain(torch.from_numpy(x)))
    args = [torch.from_numpy(a) for a in (s, b, mean, inv)]
    got = ps.pixel_shuffle_in_swish_backward_plain(_tb(x), _tb(dy), *args)[0].float().numpy()
    f32 = ps.pixel_shuffle_in_swish_backward_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                                   *args)[0]
    assert_k5_dx_close(got, f32.numpy(), _a_dz(x, dy, s, b, mean, inv))
    assert not np.array_equal(got, f32.bfloat16().float().numpy())


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_split_backward_matches_jax_xla_in_bf16(B, C, H, W):
    """The split route (K6, then f32 from one-pass statistics) against
    ``_sis_bwd_xla`` on bf16 x and dy: dx bf16, one rounding."""
    x, s, b, dy = _ps_case(1, B, C, H, W)
    want = ps_kernel._sis_bwd_xla(_jbf(_q_major_nhwc(x)), _jbf(dy.transpose(0, 2, 3, 1)),
                                  jnp.asarray(s), jnp.asarray(b), True)
    got = ps.pixel_shuffle_in_swish_backward_split(_tb(x), _tb(dy), torch.from_numpy(s),
                                                   torch.from_numpy(b))
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(), _from_q_major_nhwc(_np(want[0])), **ONE)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **F32)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **F32)


@pytest.mark.parametrize("B,C,H,W", [(2, 8, 4, 6), (1, 4, 3, 7)])
def test_shuffles_equal_pallas_kernels_in_bf16(B, C, H, W):
    """K7 against ``pixel_shuffle_q_major`` and K6 against
    ``inverse_pixel_shuffle_q_major`` on bf16, exactly, dtype kept."""
    x, _, _, dy = _ps_case(2, B, C, H, W)
    want = ps_kernel.pixel_shuffle_q_major(_jbf(_q_major_nhwc(x)), True)
    y = ps.pixel_shuffle(_tb(x))
    assert y.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(y.float().numpy().transpose(0, 2, 3, 1), _np(want))
    want = ps_kernel.inverse_pixel_shuffle_q_major(_jbf(dy.transpose(0, 2, 3, 1)), True)
    got = ps.inverse_pixel_shuffle(_tb(dy))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_q_major_nhwc(got.float().numpy()), _np(want))


# upSample2 and upSample1 of the full-width generator: x is (B, 512, 40, 2 W2)
# and (B, 1024, 20, W2), W2 = ceil(ceil(T/2)/2).
@pytest.mark.parametrize("stage,first_split", [("up2", 273), ("up1", 545)])
def test_bf16_budget_halves_the_bytes(stage, first_split):
    """The byte count against JAX's ``_sis_bwd_vmem_bytes`` on bf16 x, and the
    first crop length at which each stage leaves K5 in bf16."""
    def x_at(T, dtype):
        W2 = -(-(-(-T // 2)) // 2)
        shape = (1, 512, 40, 2 * W2) if stage == "up2" else (1, 1024, 20, W2)
        return torch.empty(shape, dtype=dtype, device="meta")

    for T in (128, 272, 273, 320, 544, 545, 600):
        x = x_at(T, torch.bfloat16)
        want = ps_kernel._sis_bwd_vmem_bytes(
            jax.ShapeDtypeStruct(tuple(x.shape[i] for i in (0, 2, 3, 1)), jnp.bfloat16), None)
        assert ps.pixel_shuffle_in_swish_backward_bytes(x) == want
        assert 2 * ps.pixel_shuffle_in_swish_backward_bytes(x) == \
            ps.pixel_shuffle_in_swish_backward_bytes(x_at(T, torch.float32))
    split = [T for T in range(128, 700)
             if ps.pixel_shuffle_in_swish_backward_bytes(x_at(T, torch.bfloat16))
             > ps.BWD_BUDGET_BYTES]
    assert split[0] == first_split


# ---------- the models ----------

def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_generator_forward_in_bf16_tracks_jax():
    """JAX's bf16 + fused-norms generator (Pallas kernels interpreted) and
    the port's bf16 generator on the same weights and inputs."""
    kw = dict(n_mels=16, residual_channels=8, num_residual_blocks=2)
    B, T = 2, 32
    params = jax_generator_params(JaxGenerator(**kw), 0, T)
    rs = np.random.RandomState(3)
    x = rs.randn(B, 16, T).astype(np.float32)
    mask = np.ones_like(x)
    mask[0, :, 5:12] = 0.0
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    f32 = np.asarray(JaxGenerator(**kw, precision="highest").apply(params, jx, jm))
    bf16 = np.asarray(JaxGenerator(**kw, dtype=jnp.bfloat16, fused_norms=True)
                      .apply(params, jx, jm))
    port = Generator(16, 8, 2, dtype=torch.bfloat16)
    port.load_state_dict(generator_params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and bf16.dtype == np.float32
    e_jax, e_port = _rel(bf16, f32), _rel(got.numpy(), bf16)
    assert 1e-4 < e_jax < 5e-2  # bf16 really ran on the JAX side
    print(f"generator: e(port, jax bf16) {e_port:.3g}, e(jax bf16, jax f32) {e_jax:.3g}")
    assert e_port <= 2 * e_jax + 1e-3, (e_port, e_jax)


def test_discriminator_forward_in_bf16_tracks_jax():
    params = jax_discriminator_params(JaxDiscriminator(residual_channels=8), 0)
    x = np.random.RandomState(4).randn(2, 16, 32).astype(np.float32)
    jx = jnp.asarray(x)
    f32 = np.asarray(JaxDiscriminator(residual_channels=8, precision="highest")
                     .apply(params, jx))
    bf16 = np.asarray(JaxDiscriminator(residual_channels=8, dtype=jnp.bfloat16,
                                       fused_norms=True).apply(params, jx))
    port = Discriminator(8, dtype=torch.bfloat16)
    port.load_state_dict(discriminator_params_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    e_jax, e_port = _rel(bf16, f32), _rel(got.numpy(), bf16)
    assert 1e-4 < e_jax < 5e-2
    print(f"discriminator: e(port, jax bf16) {e_port:.3g}, e(jax bf16, jax f32) {e_jax:.3g}")
    assert e_port <= 2 * e_jax + 1e-3, (e_port, e_jax)


@pytest.mark.parametrize("fused", [True, False])
def test_fused_norms_chooses_kernels_or_plain_versions(monkeypatch, fused):
    """Every norm of both models goes through the kernels' wrappers with
    fused norms, and through none of them without: IN-GLU 2 + blocks, IN
    2 + blocks, pixel-shuffle+IN+swish 2, IN+swish 3. The outputs agree."""
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, counted)

    from maskcyclegan_vc_tpu_torch.models import generator

    for module, name in ((layers, "instance_norm"), (layers, "instance_norm_glu"),
                         (layers, "instance_norm_swish"),
                         (generator, "pixel_shuffle_in_swish")):
        spy(module, name)
    g = Generator(16, 8, 2, dtype=torch.bfloat16, fused_norms=fused)
    d = Discriminator(8, dtype=torch.bfloat16, fused_norms=fused)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0))
    y, p = g(x, torch.ones_like(x)), d(x)
    want = {"instance_norm": 4, "instance_norm_glu": 4, "instance_norm_swish": 3,
            "pixel_shuffle_in_swish": 2} if fused else {}
    assert calls == want
    g_ref = Generator(16, 8, 2, dtype=torch.bfloat16, fused_norms=not fused)
    d_ref = Discriminator(8, dtype=torch.bfloat16, fused_norms=not fused)
    torch.testing.assert_close(y, g_ref(x, torch.ones_like(x)), rtol=0, atol=0)
    torch.testing.assert_close(p, d_ref(x), rtol=0, atol=0)


def test_generator_with_dtype_shares_the_parameters():
    g = Generator(16, 8, 2, dtype=torch.bfloat16)
    view = g.with_dtype(None)
    assert view.dtype is None and g.dtype == torch.bfloat16
    assert all(a is b for a, b in zip(view.parameters(), g.parameters()))
    x = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(1))
    ref = Generator(16, 8, 2)
    ref.load_state_dict(g.state_dict())
    torch.testing.assert_close(view(x, torch.ones_like(x)), ref(x, torch.ones_like(x)),
                               rtol=0, atol=0)


# ---------- the slice as a whole: 20 steps ----------

def _jax_cfg(dtype, fused):
    """``tests/test_bf16_dynamics.py``'s configuration."""
    return JaxTrainConfig(
        schedule=JaxScheduleConfig(num_epochs=50, n_samples=16, batch_size=2,
                                   decay_after=10 ** 6, stop_identity_after=10 ** 6),
        n_mels=8, num_frames=8, residual_channels=8, dtype=dtype, fused_norms=fused)


def _port_cfg(cfg, dtype):
    return TrainConfig(schedule=schedules.ScheduleConfig(**dataclasses.asdict(cfg.schedule)),
                       n_mels=cfg.n_mels, num_frames=cfg.num_frames,
                       residual_channels=cfg.residual_channels, dtype=dtype)


def _losses(step, state, batches, to_input):
    g, d = [], []
    for b in batches:
        state, m = step(state, to_input(b))
        g.append(float(m["g_loss"]))
        d.append(float(m["d_loss"]))
    return np.array(g), np.array(d)


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """g and d losses over 20 steps: the port in f32 and in bf16, and JAX in
    bf16 with fused norms, all three from JAX's initial state (seed 0)."""
    jax_cfg = _jax_cfg(jnp.bfloat16, True)
    state = jax_create_train_state(jax_cfg, seed=0)
    batches = _batches()
    path = tmp_path_factory.mktemp("bf16_traj") / "init.npz"
    out = {}
    for name, dtype in (("port_f32", None), ("port_bf16", torch.bfloat16)):
        cfg = _port_cfg(jax_cfg, dtype)
        port = port_state_from_jax(state, cfg, path)  # before JAX's step donates it
        out[name] = _losses(make_train_step(cfg), port, batches,
                            lambda b: {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    out["jax_bf16"] = _losses(jax_make_train_step(jax_cfg), state, batches, lambda b: b)
    return out


def test_trajectory_is_finite_and_improves(trajectories):
    for name in ("port_f32", "port_bf16", "jax_bf16"):
        g, d = trajectories[name]
        assert len(g) == N_STEPS and np.isfinite(g).all() and np.isfinite(d).all(), name
    for name in ("port_f32", "port_bf16"):
        g = trajectories[name][0]
        assert g[-5:].mean() < g[:5].mean(), name


@pytest.mark.parametrize("reference", ["port_f32", "jax_bf16"])
def test_bf16_trajectory_tracks(trajectories, reference):
    """The port's bf16 losses within 0.15 relative of the reference's at
    every step, as ``test_bf16_dynamics`` holds JAX's bf16 run to its f32."""
    for i, what in enumerate(("g_loss", "d_loss")):
        got, want = trajectories["port_bf16"][i], trajectories[reference][i]
        rel = np.abs(got - want) / np.abs(want)
        print(f"{what} against {reference}: max rel gap {rel.max():.4g}")
        assert rel.max() < 0.15, f"{what}: max rel gap {rel.max():.3f} against {reference}"


# ---------- the trainer and its flags ----------

@pytest.mark.parametrize("flags,dtype,precision,fused", [
    ([], None, None, True),
    (["--dtype", "bfloat16"], torch.bfloat16, None, True),
    (["--dtype", "auto", "--fused_norms", "1", "--precision", "highest"], None, "highest", True),
    (["--dtype", "float32", "--precision", "tensorfloat32", "--fused_norms", "0"],
     None, "tensorfloat32", False),
])
def test_train_flags_reach_the_config_and_models(corpus, monkeypatch, flags, dtype,  # noqa: F811
                                                 precision, fused):
    seen = []
    monkeypatch.setattr(Trainer, "train", lambda self: seen.append(self))
    train_main(_args(corpus, "flags_cfg", "--num_epochs", "1") + flags)
    cfg, state = seen[0].cfg, seen[0].state
    assert (cfg.dtype, cfg.precision, cfg.fused_norms) == (dtype, precision, fused)
    for model in (*state.g.values(), *state.d.values()):
        assert model.dtype == dtype
        norms = [m for m in model.modules() if isinstance(m, layers.InstanceNorm)]
        assert norms and all(n.fused == fused for n in norms)
        assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bad_precision_raises(corpus):  # noqa: F811
    with pytest.raises(ValueError, match="precision"):
        train_main(_args(corpus, "flags_bad", "--num_epochs", "1", "--precision", "fastest"))


@pytest.mark.parametrize("precision,tf32", [(None, False), ("highest", False),
                                            ("float32", False), ("high", True),
                                            ("tensorfloat32", True), ("default", True)])
def test_precision_scope_sets_and_restores_tf32(precision, tf32):
    assert allows_tf32(precision) is tf32
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with precision_scope(precision):
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


@pytest.fixture(scope="module")
def bf16_runs(corpus):  # noqa: F811
    """The train CLI in bf16: 2 epochs as scan epochs, and the same 2 epochs
    a step at a time."""
    runs = {}
    for scan in (1, 0):
        name = f"bf16_scan{scan}"
        train_main(_args(corpus, name, "--num_epochs", "2", "--dtype", "bfloat16",
                         "--scan_epochs", str(scan), "--epochs_per_plot", "2",
                         "--plot_audio", "off"))
        runs[scan] = corpus / "results" / name
    return runs


def _logged(run):
    return [line.rsplit(" (", 1)[0] for line in open(run / f"{run.name}.log")
            if line.startswith("[epoch")]


def test_bf16_scan_epochs_match_step_at_a_time(bf16_runs):
    a, b = _logged(bf16_runs[1]), _logged(bf16_runs[0])
    assert len(a) == 8 and a == b
    for epoch in (1, 2):
        with np.load(bf16_runs[1] / "ckpts" / f"{epoch:05d}_state.npz") as za, \
                np.load(bf16_runs[0] / "ckpts" / f"{epoch:05d}_state.npz") as zb:
            assert za.files == zb.files
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_bf16_checkpoint_is_f32_and_both_packages_read_it(bf16_runs, corpus):  # noqa: F811
    run = bf16_runs[1]
    path = str(run / "ckpts" / "00002_state.npz")
    with np.load(path) as z:
        floats = {k: z[k] for k in z.files if z[k].dtype.kind == "f"}
    assert floats and all(v.dtype == np.float32 for v in floats.values())
    cfg = JaxTrainConfig(schedule=JaxScheduleConfig(), n_mels=16, num_frames=16,
                         residual_channels=8)
    state = jax_load_checkpoint(path, jax_create_train_state(cfg, seed=1))
    np.testing.assert_array_equal(
        np.asarray(state.g_params["A2B"]["params"]["conv1"]["conv"]["kernel"]),
        floats[".g_params/A2B/params/conv1/conv/kernel"])
    common = ["--save_dir", str(corpus / "results"), "--preprocessed_data_dir",
              str(corpus / "pre"), "--ckpt_dir", str(run / "ckpts"), "--load_epoch", "2",
              "--n_mels", "16", "--residual_channels", "8"]
    jax_convert_main(["--name", "bf16_jax_conv"] + common)
    convert_main(["--name", "bf16_port_conv", "--device", "cpu"] + common)
    stem = "0-converted_VCC2SF3_to_VCC2TF1.npy"
    want = np.load(corpus / "results" / "bf16_jax_conv" / "converted_audio_2" / stem)
    got = np.load(corpus / "results" / "bf16_port_conv" / "converted_audio_2" / stem)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
