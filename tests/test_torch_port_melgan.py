"""The port's MelGAN vocoder and its stage (K9's plain version) against the
JAX package's, on the CPU.

Tolerances are the JAX package's own: 2e-4 (atol and rtol) for a stage
with weights of scale 0.2, whose activations grow to ~100 at C = 64
(``tests/test_melgan_stack.py``); 2e-5 for the whole generator
(``tests/test_melgan.py``). Inputs are made with numpy from a seed.

``build_neurips_melgan`` is the melgan-neurips generator's module graph
(one ``nn.Sequential`` of weight-normed convs, as its torch.hub checkpoint
holds it); the port's other tests load random checkpoints from
``neurips_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
from torch.nn.utils import weight_norm

from maskcyclegan_vc_tpu.models.melgan import MelGANGenerator as JaxMelGAN
from maskcyclegan_vc_tpu.models.melgan import melgan_params_from_torch
from maskcyclegan_vc_tpu.ops.pallas.melgan_stack_kernel import (
    melgan_resstack as jax_resstack,
)
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    melgan_params_from_jax,
    melgan_params_to_jax,
)
from maskcyclegan_vc_tpu_torch.models.melgan import (
    HOP,
    MelGANGenerator,
    decode_mel,
    load_melgan_state_dict,
)
from maskcyclegan_vc_tpu_torch.ops.melgan_stack import (
    MELGAN_STACK_KERNEL,
    melgan_resstack,
    melgan_resstack_plain,
    reflect_pad,
)

torch.set_num_threads(1)
STAGE_TOL = dict(atol=2e-4, rtol=2e-4)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)


class NeuripsResnetBlock(tnn.Module):
    def __init__(self, dim, dilation):
        super().__init__()
        self.block = tnn.Sequential(
            tnn.LeakyReLU(0.2), tnn.ReflectionPad1d(dilation),
            weight_norm(tnn.Conv1d(dim, dim, 3, dilation=dilation)),
            tnn.LeakyReLU(0.2), weight_norm(tnn.Conv1d(dim, dim, 1)))
        self.shortcut = weight_norm(tnn.Conv1d(dim, dim, 1))

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


def build_neurips_melgan(n_mels=80, ngf=32, n_res=3, ratios=(8, 8, 2, 2)):
    """The generator with torch's default init."""
    mult = 2 ** len(ratios)
    model = [tnn.ReflectionPad1d(3), weight_norm(tnn.Conv1d(n_mels, mult * ngf, 7))]
    for r in ratios:
        model += [tnn.LeakyReLU(0.2),
                  weight_norm(tnn.ConvTranspose1d(mult * ngf, mult * ngf // 2, 2 * r,
                                                  stride=r, padding=r // 2 + r % 2,
                                                  output_padding=r % 2))]
        model += [NeuripsResnetBlock(mult * ngf // 2, 3 ** j) for j in range(n_res)]
        mult //= 2
    model += [tnn.LeakyReLU(0.2), tnn.ReflectionPad1d(3),
              weight_norm(tnn.Conv1d(ngf, 1, 7)), tnn.Tanh()]
    return tnn.Sequential(*model)


def neurips_state_dict(seed: int, n_mels=80, ngf=32, gain=1.5):
    """A random checkpoint's state_dict: torch's default init from ``seed``
    with every weight_g scaled by ``gain`` (at 1.5 a full-width decode of
    random mels neither fades to a constant nor saturates the tanh)."""
    torch.manual_seed(seed)
    model = build_neurips_melgan(n_mels, ngf)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(gain)
    return {f"model.{k}": v for k, v in model.state_dict().items()}


def _stage_inputs(rs, B, W, C, x_scale):
    x = (rs.randn(B, W, C) * x_scale).astype(np.float32)
    blocks = []
    for _ in range(3):
        blocks.append({k: (rs.randn(*shape) * s).astype(np.float32) for k, shape, s in (
            ("conv1_kernel", (3, C, C), 0.2), ("conv1_bias", (C,), 0.1),
            ("conv2_kernel", (1, C, C), 0.2), ("conv2_bias", (C,), 0.1),
            ("shortcut_kernel", (1, C, C), 0.2), ("shortcut_bias", (C,), 0.1))})
    k7 = (rs.randn(7, C, 1) * 0.05).astype(np.float32)
    b7 = (rs.randn(1) * 0.1).astype(np.float32)
    return x, blocks, (k7, b7)


def _to_port(blocks):
    """JAX's (K, I, O) block leaves -> the port's (O, I, K) module names."""
    return [{f"{c}.{leaf}": torch.from_numpy(np.ascontiguousarray(
                b[f"{c}_kernel"].transpose(2, 1, 0)) if leaf == "weight" else b[f"{c}_bias"])
             for c in ("conv1", "conv2", "shortcut") for leaf in ("weight", "bias")}
            for b in blocks]


@pytest.mark.parametrize("shape", [(2, 64, 8), (1, 96, 16), (1, 64, 32), (2, 62, 64),
                                   (2, 8, 32), (1, 4, 64)])
@pytest.mark.parametrize("mode", ["plain", "emit_lrelu", "tail"])
def test_stage_matches_jax_kernel(shape, mode):
    B, W, C = shape
    rs = np.random.RandomState(W + C)
    x, blocks, (k7, b7) = _stage_inputs(rs, B, W, C, 1.0 if C <= 16 else 0.5)
    jtail = (jnp.asarray(k7), jnp.asarray(b7)) if mode == "tail" else None
    want = np.asarray(jax_resstack(jnp.asarray(x), jax.tree.map(jnp.asarray, blocks),
                                   interpret=True, emit_lrelu=mode == "emit_lrelu",
                                   tail_params=jtail))
    tail = None
    if mode == "tail":
        tail = (torch.from_numpy(np.ascontiguousarray(k7.transpose(2, 1, 0))),
                torch.from_numpy(b7))
    before = MELGAN_STACK_KERNEL.launches
    got = melgan_resstack(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))),
                          _to_port(blocks), emit_lrelu=mode == "emit_lrelu", tail=tail)
    assert MELGAN_STACK_KERNEL.launches == before  # the CPU runs the plain version
    got = got.numpy() if mode == "tail" else got.numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **STAGE_TOL)


@pytest.fixture(scope="module")
def small_vocoder():
    """JAX's small MelGAN params (n_mels 8, ngf 4), biases made nonzero."""
    p = fast_init(JaxMelGAN(n_mels=8, ngf=4), 0, jnp.zeros((1, 8, 4)))
    rs = np.random.RandomState(3)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape))
                        .astype(np.float32), p)


@pytest.mark.parametrize("fused", [False, True])
def test_generator_matches_jax(small_vocoder, fused):
    mel = np.random.RandomState(1).randn(2, 8, 6).astype(np.float32)
    want = np.asarray(JaxMelGAN(n_mels=8, ngf=4, fused_stages=fused, precision="highest")
                      .apply(jax.tree.map(jnp.asarray, small_vocoder), jnp.asarray(mel)))
    model = MelGANGenerator(8, 4)
    model.load_state_dict(melgan_params_from_jax(small_vocoder), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 6 * HOP)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_params_round_trip(small_vocoder):
    back = melgan_params_to_jax(melgan_params_from_jax(small_vocoder))
    assert back["params"].keys() == small_vocoder["params"].keys()
    for k, v in small_vocoder["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)


def test_neurips_state_dict_loads_as_jax_loads_it():
    """A melgan-neurips state_dict with weight_g / weight_v pairs: the port's
    fold equals JAX's ``melgan_params_from_torch`` exactly, and the port's
    decode matches the torch module itself."""
    torch.manual_seed(1)
    ref = build_neurips_melgan(n_mels=8, ngf=4).eval()
    with torch.no_grad():
        for name, p in ref.named_parameters():  # weight_g away from its init
            if name.endswith("weight_g") or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape))
    sd = {f"model.{k}": v for k, v in ref.state_dict().items()}
    assert any(k.endswith("weight_v") for k in sd)
    port_sd = load_melgan_state_dict(sd)
    want = melgan_params_from_jax(melgan_params_from_torch(sd))
    assert port_sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(port_sd[k], v), k
    model = MelGANGenerator(8, 4)
    model.load_state_dict(port_sd, strict=True)
    mel = np.random.RandomState(0).randn(2, 8, 17).astype(np.float32)
    mean = np.random.RandomState(1).randn(8, 1).astype(np.float32)
    std = (np.random.RandomState(2).rand(8, 1) + 0.5).astype(np.float32)
    with torch.no_grad():
        want_wav = ref(torch.from_numpy(mel * std + mean))[:, 0].numpy()
    got = decode_mel(model, mel, mean, std).numpy()
    assert got.shape == (2, 17 * HOP)
    np.testing.assert_allclose(got, want_wav, **MODEL_TOL)


def test_published_size_and_output_length():
    """melgan-neurips at its defaults: 4,260,257 parameters once the weight
    norm is folded; T frames decode to T * 256 samples."""
    model = MelGANGenerator()
    assert sum(p.numel() for p in model.parameters()) == 4_260_257
    with torch.inference_mode():
        assert model(torch.zeros(1, 80, 10)).shape == (1, 10 * HOP)
    small = MelGANGenerator(8, 4)
    with torch.inference_mode():
        assert small(torch.zeros(3, 8, 7)).shape == (3, 7 * HOP)


def test_stage_refuses_what_it_cannot_run():
    rs = np.random.RandomState(0)
    x, blocks, _ = _stage_inputs(rs, 1, 16, 4, 1.0)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    port = _to_port(blocks)
    with pytest.raises(NotImplementedError):
        melgan_resstack(xt.clone().requires_grad_(), port)
    with pytest.raises(ValueError):  # an empty sequence has nothing to mirror
        melgan_resstack(xt[..., :0].contiguous(), port)
    with pytest.raises(ValueError):
        melgan_resstack(xt, port[:2])
    torch.testing.assert_close(melgan_resstack(xt, port), melgan_resstack_plain(xt, port))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("p", [1, 3, 9])
def test_reflect_pad_matches_numpy(W, p):
    """``jnp.pad``'s reflection, which ``np.pad`` shares: for p >= W the
    mirror repeats (a constant at W = 1), where ``F.pad`` refuses."""
    x = np.random.RandomState(W * 10 + p).randn(2, 3, W).astype(np.float32)
    got = reflect_pad(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (0, 0), (p, p)), mode="reflect"))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_short_mels_match_jax(small_vocoder, T, fused):
    """Mels of 1-4 frames, which JAX decodes, its fused form through its
    Pallas kernel: conv_in's pad of 3 and the blocks' pads of up to 9
    reflect past the edge (at T = 1 the first stage is W = 8 wide)."""
    mel = np.random.RandomState(T).randn(2, 8, T).astype(np.float32)
    want = np.asarray(JaxMelGAN(n_mels=8, ngf=4, fused_stages=fused, precision="highest")
                      .apply(jax.tree.map(jnp.asarray, small_vocoder), jnp.asarray(mel)))
    model = MelGANGenerator(8, 4)
    model.load_state_dict(melgan_params_from_jax(small_vocoder), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, T * HOP)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
