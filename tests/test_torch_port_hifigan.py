"""The port's HiFi-GAN (``models/hifigan.py``) on the CPU, against the
benchmark's plain reference (``portbench/reference/hifigan.py``).

The module at the published rates, kernels and dilations with narrow
channels, on seeded weights, at three mel lengths (one shorter than a
conversion bucket of 64 frames), to 1e-5 of the waveform's peak: both run
the same f32 convolutions on the CPU, so only the order of the bias add and
of the MRF sum differs; the port takes log10 mels, the published network
(and the reference) natural-log ones. The published-width parameter count
on meta tensors. A checkpoint in jik876/hifi-gan's layout (``{"generator":
state_dict}`` of ``weight_g`` / ``weight_v`` pairs) read by
``models/vocoder.load_vocoder``, which still reads a melgan-neurips one as
MelGAN. The
counter and the spans of one decode. ``cli/test.py --vocoder_ckpt`` with
such a checkpoint, end to end.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.nn.utils import weight_norm
from test_torch_port_melgan import neurips_state_dict

from maskcyclegan_vc_tpu_torch.cli.test import main
from maskcyclegan_vc_tpu_torch.data.audio_io import read_wav
from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker
from maskcyclegan_vc_tpu_torch.io.checkpoint import save_checkpoint
from maskcyclegan_vc_tpu_torch.io.jax_params import generator_params_to_jax
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.models import hifigan
from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator, decode_mel
from maskcyclegan_vc_tpu_torch.models.vocoder import load_vocoder
from maskcyclegan_vc_tpu_torch.obs import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import traffic  # noqa: E402
from portbench.reference.hifigan import HiFiGAN  # noqa: E402

NARROW = {**hifigan.V1, "upsample_initial_channel": 32}
N_PARAMS_V1 = 13_926_017


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _seeded_reference(widths, seed: int) -> HiFiGAN:
    """The reference with the benchmark's seeded weights at its gain of 1.5
    (``traffic.uniform_init``): a decode between linear and saturated."""
    ref = HiFiGAN(80, widths)
    ref.load_state_dict(traffic.uniform_init(ref, "", torch.Generator().manual_seed(seed), "cpu",
                                             weight_gain=1.5))
    return ref.eval()


@pytest.mark.parametrize("frames", [5, 37, 70])
def test_generator_matches_the_reference(frames):
    ref = _seeded_reference(NARROW, frames)
    port = hifigan.HiFiGANGenerator(80, NARROW)
    port.load_state_dict(ref.state_dict(), strict=True)
    rand = torch.randn(2, 80, frames, generator=torch.Generator().manual_seed(1))
    mel = (-6.0 + 2.0 * rand) / hifigan.LN10  # log10
    with torch.no_grad():
        got, want = port(mel), ref(mel * hifigan.LN10)
    assert got.shape == want.shape == (2, frames * 256)
    assert 0.05 < float(want.abs().max()) < 0.99
    assert _rel_gap(got, want) <= 1e-5


def test_published_widths_have_the_published_parameter_count():
    with torch.device("meta"):
        ref = HiFiGAN(80, hifigan.V1)
    port = hifigan.HiFiGANGenerator(80, hifigan.V1, device="meta")
    count = [sum(p.numel() for p in m.parameters()) for m in (ref, port)]
    assert count == [N_PARAMS_V1, N_PARAMS_V1]
    assert [n for n, _ in ref.named_parameters()] == [n for n, _ in port.named_parameters()]


def _weight_normed(ref: HiFiGAN):
    """``ref`` with every conv weight-normed, as jik876's training module
    holds them (g = ||v||, so the folded weight is ``ref``'s own)."""
    for m in ref.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            weight_norm(m)
    return ref


def _hifigan_checkpoint(path, widths, seed: int):
    ref = _seeded_reference(widths, seed)
    folded = {k: v.clone() for k, v in ref.state_dict().items()}
    torch.save({"generator": _weight_normed(ref).state_dict()}, path)
    return folded


def test_a_published_layout_checkpoint_loads_and_decodes_as_the_reference(tmp_path):
    folded = _hifigan_checkpoint(tmp_path / "g_02500000", NARROW, 3)
    sd = torch.load(tmp_path / "g_02500000")["generator"]
    assert "conv_pre.weight_g" in sd and "resblocks.8.convs2.2.weight_v" in sd
    vocoder = load_vocoder(str(tmp_path / "g_02500000"), "cpu")
    assert isinstance(vocoder, hifigan.HiFiGANGenerator)
    ref = HiFiGAN(80, NARROW)
    ref.load_state_dict(folded)
    rs = np.random.RandomState(4)
    mel = rs.randn(1, 80, 23).astype(np.float32)
    mean = (rs.randn(80, 1) * 0.5 - 2.5).astype(np.float32)
    std = (rs.rand(80, 1) * 0.5 + 0.5).astype(np.float32)
    got = decode_mel(vocoder, mel, mean, std)
    with torch.no_grad():
        want = ref((torch.from_numpy(mel) * torch.from_numpy(std) + torch.from_numpy(mean))
                   * np.log(10.0))
    assert got.shape == want.shape == (1, 23 * 256)
    assert _rel_gap(got, want) <= 1e-5


def test_the_loader_reads_the_widths_from_the_shapes_and_refuses_other_layouts(tmp_path):
    widths = {**NARROW, "upsample_rates": [8, 4, 4], "upsample_kernel_sizes": [16, 8, 8],
              "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 5],
              "resblock_dilation_sizes": [[1, 3, 5]] * 2}
    _hifigan_checkpoint(tmp_path / "v3", widths, 5)
    got = load_vocoder(str(tmp_path / "v3"), "cpu")
    assert len(got.ups) == 3 and [u.stride[0] for u in got.ups] == [8, 4, 4]
    assert got.conv_pre.weight.shape == (64, 80, 7) and len(got.resblocks) == 6
    sd = HiFiGAN(80, NARROW).state_dict()
    bad = {k: v for k, v in sd.items() if not k.startswith("resblocks.0.convs1.2")}
    with pytest.raises(ValueError, match="3 dilated convs"):
        hifigan.load_hifigan_state_dict(bad)
    with pytest.raises(ValueError, match="not a HiFi-GAN"):
        hifigan.load_hifigan_state_dict({k: v for k, v in sd.items()
                                         if not k.startswith("ups.")})
    with pytest.raises(ValueError, match="ResBlock1"):
        hifigan.HiFiGANGenerator(80, {**NARROW, "resblock": "2"})


def test_a_melgan_checkpoint_still_loads_as_melgan(tmp_path):
    torch.save(neurips_state_dict(0), tmp_path / "melgan.pt")
    vocoder = load_vocoder(str(tmp_path / "melgan.pt"), "cpu")
    assert isinstance(vocoder, MelGANGenerator)


def test_one_decode_counts_its_convs_and_records_a_span_a_stage():
    vocoder = hifigan.HiFiGANGenerator(80, NARROW).eval()
    before = dict(hifigan.CONVS)
    t0 = profiler.spans()[-1].end_ns if profiler.spans() else 0
    decode_mel(vocoder, np.zeros((1, 80, 3), np.float32), np.zeros((80, 1)), np.ones((80, 1)))
    made = {k: hifigan.CONVS[k] - before[k] for k in hifigan.CONV_KINDS}
    assert made == {"pre": 1, "up": 4, "mrf": 72, "post": 1}
    got = [sp for sp in profiler.spans() if sp.start_ns > t0]
    by = {sp.id: sp for sp in got}
    stages = [sp for sp in got if sp.name == "hifigan.stage"]
    assert [sp.request for sp in stages] == [0, 1, 2, 3]
    assert all(by[sp.cause].name == "decode.vocoder" for sp in stages)
    assert [sp.name for sp in got][-3:] == ["hifigan.stage", "decode.vocoder", "decode"]


def test_the_conversion_cli_decodes_with_a_hifigan_checkpoint(tmp_path):
    rs = np.random.RandomState(0)
    lengths = (40, 70)
    for sid in ("VCC2SF3", "VCC2TF1"):
        save_speaker(str(tmp_path / "pre"), sid, [rs.randn(80, t).astype(np.float32)
                                                  for t in lengths],
                     (rs.randn(80, 1) * 0.5 - 2.5).astype(np.float32),
                     (rs.rand(80, 1) * 0.5 + 0.5).astype(np.float32))
    gen = Generator(n_mels=80, residual_channels=8, device="cpu")
    save_checkpoint(str(tmp_path / "ckpts" / "00001_state.npz"),
                    {"g_params": {"A2B": generator_params_to_jax(gen.state_dict())}})
    _hifigan_checkpoint(tmp_path / "g_hifigan", NARROW, 7)
    before = hifigan.CONVS["mrf"]
    main(["--name", "hifigan", "--save_dir", str(tmp_path / "results"),
          "--preprocessed_data_dir", str(tmp_path / "pre"), "--ckpt_dir",
          str(tmp_path / "ckpts"), "--load_epoch", "1", "--residual_channels", "8",
          "--vocoder_ckpt", str(tmp_path / "g_hifigan"), "--device", "cpu"])
    assert hifigan.CONVS["mrf"] - before == 72 * 2 * len(lengths)
    out = tmp_path / "results" / "hifigan" / "converted_audio_1"
    for i, t in enumerate(lengths):
        for kind in ("converted", "original"):
            wav, sr = read_wav(str(out / f"{i}-{kind}_VCC2SF3_to_VCC2TF1.wav"))
            assert sr == 22050 and wav.shape == (t * 256,) and np.isfinite(wav).all()
            assert np.ptp(wav) > 1e-3
