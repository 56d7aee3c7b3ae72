"""The train step with its in-loop bf16 vocoder decode (the benchmark's
config 5, ``bench.py:81-107``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed. The JAX side runs its Pallas
kernels in interpret mode; the port's wrappers run their plain versions for
CPU tensors.

Tolerances, each with the gap measured on this CPU:
- K9's bf16 form (``assert_bf16_stage_close``): every element within two
  bf16 ulps of JAX's, or within 2**-7 of the output's largest magnitude,
  and at most 2 % of the elements beyond two ulps. Both sides compute in
  f32 from the same bf16 values and round at the same six points, so most
  elements are bit-equal; where a sum lands within f32 rounding of a bf16
  tie the two round it one ulp apart, and a later block spreads that ulp to
  the elements it feeds, which can be small ones. Measured: 0 to 64 of
  4096-8192 elements differ (at most 0.8 %), by at most 2.7e-3 of the
  scale. The f32 version of the stage on the same bf16-rounded inputs
  misses the bound: 7.6-23 % of its elements lie beyond two ulps.
- The bf16 MelGAN against JAX's bf16 MelGAN (``fused_stages=True``):
  exact, which the test can tell from f32: the port's f32 MelGAN differs
  from JAX's bf16 one by 2.1e-3 at a scale of 0.26 (one bf16 ulp there;
  775 of 3072 samples differ). Measured: 0 samples differ.
- ``fake_B_eval`` against the ``generated_B`` the port's D update consumed:
  the same tensor, bit for bit. Against JAX's ``fake_B_eval`` from the same
  state and batch: rtol 1e-3 with atol 1e-3 of its largest magnitude, the
  bound ``test_torch_port_train_step.py`` holds outputs computed after one
  update to (the two packages' updated params may differ by 2 lr where a
  near-zero gradient's sign flips). Measured: 5.7e-6 of the scale.
- The whole slice, the step then the bf16 decode of the first
  utterance's ``fake_B_eval`` (no denormalization, as in ``bench.py``):
  within two bf16 ulps of the waveform's largest magnitude (2**-6 of it) of
  JAX's. The two conversions differ by the param differences above, and
  the vocoder's first cast to bf16 can round them one ulp apart. Measured:
  57 of 8192 samples one ulp (1.95e-3) apart at a scale of 0.32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_melgan import _to_port, small_vocoder  # noqa: F401 (a fixture)
from test_torch_port_train_step import batch, jax_cfg, port_cfg, port_state_from_jax, torch_batch

from maskcyclegan_vc_tpu.models.melgan import MelGANGenerator as JaxMelGAN
from maskcyclegan_vc_tpu.ops.pallas.melgan_stack_kernel import melgan_resstack as jax_resstack
from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
from maskcyclegan_vc_tpu.train.step import make_train_step as jax_make_train_step
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.io.jax_params import melgan_params_from_jax
from maskcyclegan_vc_tpu_torch.models.melgan import HOP, MelGANGenerator
from maskcyclegan_vc_tpu_torch.ops import melgan_stack
from maskcyclegan_vc_tpu_torch.train import step as step_module
from maskcyclegan_vc_tpu_torch.train.state import create_train_state
from maskcyclegan_vc_tpu_torch.train.step import LOGGED_METRICS, make_train_step, make_update

torch.set_num_threads(1)
BF16 = torch.bfloat16


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def stage_gap(got: np.ndarray, want: np.ndarray):
    """(share of elements beyond two bf16 ulps of want, largest error over
    the output's scale, whether every element is within two ulps or 2**-7
    of the scale)."""
    scale = float(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want)
    beyond = err > 2 * bf16_ulp(want)
    within = np.all(~beyond | (err <= 2 ** -7 * scale))
    return float(beyond.mean()), float(err.max() / scale), bool(within)


def assert_bf16_stage_close(got: np.ndarray, want: np.ndarray) -> None:
    share, rel, within = stage_gap(got, want)
    assert within and share <= 0.02, (share, rel)


def _normalized_stage_inputs(rs, B, W, C):
    """x ~ N(0, 1) and weights of scale fan_in**-0.5, so activations stay
    O(1) through the three blocks."""
    x = rs.randn(B, W, C).astype(np.float32)
    blocks = [{k: (rs.randn(*shape) * s).astype(np.float32) for k, shape, s in (
        ("conv1_kernel", (3, C, C), (3 * C) ** -0.5), ("conv1_bias", (C,), 0.1),
        ("conv2_kernel", (1, C, C), C ** -0.5), ("conv2_bias", (C,), 0.1),
        ("shortcut_kernel", (1, C, C), C ** -0.5), ("shortcut_bias", (C,), 0.1))}
        for _ in range(3)]
    k7 = (rs.randn(7, C, 1) * (7 * C) ** -0.5).astype(np.float32)
    b7 = (rs.randn(1) * 0.1).astype(np.float32)
    return x, blocks, (k7, b7)


# C = 128 is one channel group a row in the Pallas kernel (p = 1); C = 32
# packs p = 4 positions a row.
@pytest.mark.parametrize("shape", [(1, 32, 128), (2, 128, 32)])
@pytest.mark.parametrize("mode", ["plain", "emit_lrelu", "tail"])
def test_bf16_stage_matches_jax_kernel(shape, mode):
    """The port's bf16 K9 (plain version) against JAX's bf16
    ``melgan_resstack`` in interpret mode, with the bf16 params JAX's
    ``conv_param`` passes it; the f32 version misses the bound."""
    B, W, C = shape
    x, blocks, (k7, b7) = _normalized_stage_inputs(np.random.RandomState(W + C), B, W, C)
    emit = mode == "emit_lrelu"
    jtail = ((jnp.asarray(k7, jnp.bfloat16), jnp.asarray(b7, jnp.bfloat16))
             if mode == "tail" else None)
    want = jax_resstack(jnp.asarray(x, jnp.bfloat16),
                        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), blocks),
                        interpret=True, emit_lrelu=emit, tail_params=jtail)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(BF16)
    pblocks = _to_port(blocks)
    tail = None
    if mode == "tail":
        tail = (torch.from_numpy(np.ascontiguousarray(k7.transpose(2, 1, 0))),
                torch.from_numpy(b7))
    launches = {d: k.launches for d, k in melgan_stack.ENTRIES.items()}
    got = melgan_stack.melgan_resstack(xt, pblocks, emit_lrelu=emit, tail=tail)
    assert {d: k.launches for d, k in melgan_stack.ENTRIES.items()} == launches
    assert got.dtype == BF16
    # The weights as the model passes them (cast to bf16) give the same.
    same = melgan_stack.melgan_resstack(
        xt, [{k: v.to(BF16) for k, v in b.items()} for b in pblocks], emit_lrelu=emit,
        tail=None if tail is None else tuple(t.to(BF16) for t in tail))
    assert torch.equal(same, got)

    # The f32 chain on the same bf16-rounded x and params.
    f32 = melgan_stack.melgan_resstack_plain(
        xt.float(), [{k: v.to(BF16).float() for k, v in b.items()} for b in pblocks],
        emit_lrelu=emit, tail=None if tail is None else tuple(t.to(BF16).float() for t in tail))

    def layout(t):
        t = t.float().numpy()
        return t if mode == "tail" else t.transpose(0, 2, 1)

    got, f32 = layout(got), layout(f32)
    assert got.shape == want.shape
    assert_bf16_stage_close(got, want)
    share, _, within = stage_gap(f32, want)
    assert not (within and share <= 0.02), share


def test_stage_refuses_mixed_and_other_dtypes():
    x, blocks, tail = (torch.randn(1, 8, 16), [{k: torch.randn(s) for k, s in (
        ("conv1.weight", (8, 8, 3)), ("conv1.bias", (8,)), ("conv2.weight", (8, 8, 1)),
        ("conv2.bias", (8,)), ("shortcut.weight", (8, 8, 1)), ("shortcut.bias", (8,)))}
        for _ in range(3)], (torch.randn(1, 8, 7), torch.randn(1)))
    mixed = [dict(b) for b in blocks]
    mixed[1]["conv2.weight"] = mixed[1]["conv2.weight"].to(BF16)
    all_bf16 = [{k: v.to(BF16) for k, v in b.items()} for b in blocks]
    with pytest.raises(ValueError, match="weights"):
        melgan_stack.melgan_resstack(x.to(BF16), mixed)
    with pytest.raises(ValueError, match="weights"):  # f32 x, bf16 weights
        melgan_stack.melgan_resstack(x, all_bf16)
    with pytest.raises(ValueError, match="weights"):  # the tail counts too
        melgan_stack.melgan_resstack(x.to(BF16), all_bf16, tail=tail)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        melgan_stack.melgan_resstack(x.half(), blocks)
    wav = melgan_stack.melgan_resstack(x.to(BF16), all_bf16, tail=tuple(t.to(BF16) for t in tail))
    assert wav.dtype == BF16 and wav.shape == (1, 16)


def test_pack_weights_rounds_as_jax_casts():
    """The kernel's packed bf16 operands: weights in bf16, b1 and b7 the
    bf16-rounded biases widened, bm summed in bf16."""
    g = torch.Generator().manual_seed(0)
    blocks = [{k: torch.randn(s, generator=g) for k, s in (
        ("conv1.weight", (4, 4, 3)), ("conv1.bias", (4,)), ("conv2.weight", (4, 4, 1)),
        ("conv2.bias", (4,)), ("shortcut.weight", (4, 4, 1)), ("shortcut.bias", (4,)))}
        for _ in range(3)]
    tail = (torch.randn(1, 4, 7, generator=g), torch.randn(1, generator=g))
    w1, b1, wm, bm, k7, b7 = melgan_stack.pack_weights(blocks, tail, BF16)
    assert [t.dtype for t in (w1, b1, wm, bm, k7, b7)] == [BF16, torch.float32] * 3
    bp = blocks[2]
    assert torch.equal(w1[2, 1], bp["conv1.weight"][:, :, 1].t().to(BF16))
    assert torch.equal(b1[2], bp["conv1.bias"].to(BF16).float())
    assert torch.equal(bm[2], (bp["shortcut.bias"].to(BF16) + bp["conv2.bias"].to(BF16)).float())
    assert torch.equal(b7, tail[1].to(BF16).float())
    f32 = melgan_stack.pack_weights(blocks, tail)
    assert all(t.dtype == torch.float32 for t in f32)
    assert torch.equal(f32[3][0], blocks[0]["shortcut.bias"] + blocks[0]["conv2.bias"])


def test_bf16_vocoder_matches_jax(small_vocoder):
    mel = np.random.RandomState(1).randn(2, 8, 6).astype(np.float32)
    want = JaxMelGAN(n_mels=8, ngf=4, dtype=jnp.bfloat16, fused_stages=True).apply(
        jax.tree.map(jnp.asarray, small_vocoder), jnp.asarray(mel))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    sd = melgan_params_from_jax(small_vocoder)
    model, model_f32 = MelGANGenerator(8, 4, dtype=BF16), MelGANGenerator(8, 4)
    model.load_state_dict(sd, strict=True)
    model_f32.load_state_dict(sd, strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    before = {d: k.launches for d, k in melgan_stack.ENTRIES.items()}
    with torch.inference_mode():
        got = model(torch.from_numpy(mel))
        f32 = model_f32(torch.from_numpy(mel)).numpy()
    assert {d: k.launches for d, k in melgan_stack.ENTRIES.items()} == before
    assert got.dtype == BF16 and got.shape == want.shape == (2, 6 * HOP)
    gap_f32 = float(np.abs(f32 - want).max())
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert gap_f32 > 2 ** -9 * np.abs(want).max()  # the test can tell bf16 from f32


@pytest.fixture(scope="module")
def eval_step(tmp_path_factory):
    """One f32 step with ``with_eval_fake`` from one state and batch in each
    package (JAX's XLA path, ``fused_norms=False``), the port's fakes as its
    D update consumed them, and each package's bf16 decode of its first
    utterance's ``fake_B_eval`` by the same small vocoder (16 mels, ngf 4).
    The JAX step's compile takes most of this file's time."""
    cfg = jax_cfg(fused_norms=False)
    js = jax_create_train_state(cfg, seed=0)
    pcfg = port_cfg(cfg)
    ps = port_state_from_jax(js, pcfg, tmp_path_factory.mktemp("eval") / "s.npz")
    b = batch(5)
    js, jm = jax.jit(jax_make_train_step(cfg, with_identity=True, with_eval_fake=True))(
        jax.device_get(js), b)

    consumed = []

    def make_fakes(*args):
        fakes = real_make_fakes(*args)
        consumed.append(fakes)
        return fakes

    real_make_fakes = step_module.make_fakes
    step_module.make_fakes = make_fakes
    try:
        lam = step_module.identity_lambda(pcfg.schedule, ps.step)
        pm = make_update(pcfg, True, with_eval_fake=True)(ps, torch_batch(b), lam)
    finally:
        step_module.make_fakes = real_make_fakes

    voc = fast_init(JaxMelGAN(n_mels=16, ngf=4), 0, jnp.zeros((1, 16, 4)))
    rs = np.random.RandomState(4)
    voc = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape))
                       .astype(np.float32), voc)
    jwav = JaxMelGAN(n_mels=16, ngf=4, dtype=jnp.bfloat16, fused_stages=True).apply(
        jax.tree.map(jnp.asarray, voc), jm["fake_B_eval"][:1])
    vocoder = MelGANGenerator(16, 4, dtype=BF16)
    vocoder.load_state_dict(melgan_params_from_jax(voc), strict=True)
    with torch.inference_mode():
        pwav = vocoder(pm["fake_B_eval"][:1])
    return jax.device_get(jm), pm, consumed, np.asarray(jwav.astype(jnp.float32)), pwav


def test_eval_fake_is_the_d_updates_generated_b(eval_step):
    _, pm, consumed, _, _ = eval_step
    assert len(consumed) == 1
    fake = pm["fake_B_eval"]
    assert fake.dtype == torch.float32 and not fake.requires_grad
    assert fake.shape == consumed[0]["generated_B"].shape == (2, 16, 32)
    assert torch.equal(fake, consumed[0]["generated_B"])
    assert set(pm) == set(LOGGED_METRICS) | {"identity_lambda", "fake_B_eval"}
    assert "fake_B_eval" not in LOGGED_METRICS


def test_eval_fake_matches_jax(eval_step):
    jm, pm, _, _, _ = eval_step
    want = np.asarray(jm["fake_B_eval"])
    got = pm["fake_B_eval"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-3, err_msg=k)


def test_step_then_bf16_decode_matches_jax(eval_step):
    """The slice as a whole: the step's conversion decoded by the bf16
    vocoder, against JAX's step and bf16 decode in one executable's order."""
    _, _, _, jwav, pwav = eval_step
    assert pwav.dtype == BF16 and pwav.shape == jwav.shape == (1, 32 * HOP)
    got = pwav.float().numpy()
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, jwav, rtol=0, atol=2 ** -6 * np.abs(jwav).max())


def test_train_step_passes_with_eval_fake():
    """``make_train_step(..., with_eval_fake=True)`` returns the conversion
    among its metrics and still advances the step; without it, no tensor
    beyond the scalars."""
    cfg = port_cfg(jax_cfg())
    state = create_train_state(cfg, seed=1)
    state, m = make_train_step(cfg, with_eval_fake=True)(state, torch_batch(batch(6)))
    assert state.step == 1 and m["fake_B_eval"].shape == (2, 16, 32)
    _, m = make_train_step(cfg)(state, torch_batch(batch(6)))
    assert "fake_B_eval" not in m
