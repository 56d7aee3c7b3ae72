"""The port's decoding and scoring against the JAX package's, on the CPU.

Griffin-Lim, the warped-cepstral waveform MCD and F0 are numpy in both
packages (copies): they must agree to rounding. The log-mel-DCT cepstra are
``jnp`` in JAX and numpy here: MCD and MSD agree to 1e-5 relative.

The conversion CLIs run end to end on one corpus: a small-width generator
(80 mels, the vocoder's input, R = 8) written as a JAX checkpoint, and a
full-width melgan-neurips vocoder with random weights saved as a
``state_dict`` with ``torch.save``. Both CLIs run with ``--vocoder_ckpt``
and ``--compute_mcd``, and with ``--griffin_lim --griffin_lim_iters 4
--compute_mcd``. The written wavs agree within 3 PCM16 steps (the
conversions agree to ~1e-4, as ``test_torch_port_convert.py`` holds them,
before quantization), and the printed MCD, MSD and F0 figures within one
unit of their last printed digit.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_melgan import neurips_state_dict

from maskcyclegan_vc_tpu.cli.test import main as jax_main
from maskcyclegan_vc_tpu.data import griffin_lim as jax_gl
from maskcyclegan_vc_tpu.data.audio_io import read_wav as jax_read_wav
from maskcyclegan_vc_tpu.data.dataset import save_speaker as jax_save_speaker
from maskcyclegan_vc_tpu.eval import f0 as jax_f0
from maskcyclegan_vc_tpu.eval import mcep as jax_mcep
from maskcyclegan_vc_tpu.eval import metrics as jax_metrics
from maskcyclegan_vc_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from maskcyclegan_vc_tpu.models import Generator as JaxGenerator
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.cli.test import main
from maskcyclegan_vc_tpu_torch.data import griffin_lim
from maskcyclegan_vc_tpu_torch.data.audio_io import read_wav
from maskcyclegan_vc_tpu_torch.eval import f0, mcep, metrics

torch.set_num_threads(1)
R = 8
LENGTHS = (64, 100)  # frames per utterance, both speakers (buckets 64, 128)
PCM_STEP = 1.0 / 32767.0


def _mels(seed, n_mels=80, lengths=(70, 90)):
    rs = np.random.RandomState(seed)
    return [rs.randn(n_mels, t).astype(np.float32) for t in lengths]


def _stats(seed, n_mels=80):
    rs = np.random.RandomState(seed)
    return ((rs.randn(n_mels, 1) * 0.5 - 2.0).astype(np.float32),
            (rs.rand(n_mels, 1) * 0.5 + 0.5).astype(np.float32))


def test_griffin_lim_matches_jax():
    mel = _mels(0)[0]
    mean, std = _stats(1)
    want = jax_gl.decode_mel_griffin_lim(mel, mean, std, n_iter=4)
    got = griffin_lim.decode_mel_griffin_lim(mel, mean, std, n_iter=4)
    assert got.shape == want.shape == (70 * 256,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mel_metrics_match_jax():
    (a, b), (mean, std) = _mels(2), _stats(3)
    a, b = a * std + mean, b * std + mean
    np.testing.assert_allclose(metrics.log_mel_cepstra(a), np.asarray(
        jax_metrics.log_mel_cepstra(a)), rtol=1e-5, atol=1e-5)
    m, path = metrics.mcd_dtw(a, b)
    jm, jpath = jax_metrics.mcd_dtw(a, b)
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(m, jm, rtol=1e-5)
    np.testing.assert_allclose(metrics.mel_spectral_distance(a, b, path),
                               jax_metrics.mel_spectral_distance(a, b, jpath), rtol=1e-6)
    np.testing.assert_allclose(metrics.mcd(metrics.log_mel_cepstra(a[:, :50]),
                                           metrics.log_mel_cepstra(b[:, :50])),
                               np.asarray(jax_metrics.mcd(jax_metrics.log_mel_cepstra(a[:, :50]),
                                                          jax_metrics.log_mel_cepstra(b[:, :50]))),
                               rtol=1e-5)


def test_waveform_mcd_and_f0_match_jax():
    rs = np.random.RandomState(4)
    t = np.arange(12000) / 22050
    wa = (0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rs.randn(t.size)).astype(np.float32)
    wb = (0.3 * np.sin(2 * np.pi * 260 * t[:11000]) + 0.05 * rs.randn(11000)).astype(np.float32)
    got, path = mcep.mcd_dtw_wav(wa, wb)
    want, jpath = jax_mcep.mcd_dtw_wav(wa, wb)
    np.testing.assert_array_equal(path, jpath)
    assert got == want
    mel = _mels(5)[1]
    mean, std = _stats(6)
    assert f0.utterance_f0(mel, mean, std) == jax_f0.utterance_f0(mel, mean, std)
    np.testing.assert_array_equal(f0.f0_from_waveform(wa)[0], jax_f0.f0_from_waveform(wa)[0])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_decode")
    for k, sid in enumerate(("VCC2SF3", "VCC2TF1")):
        mean, std = _stats(10 + k)
        jax_save_speaker(str(root / "pre"), sid, _mels(20 + k, lengths=LENGTHS), mean, std)
    model = JaxGenerator(n_mels=80, residual_channels=R)
    x = jnp.zeros((1, 80, 64))
    g = {"A2B": jax.tree.map(np.asarray, fast_init(model, 1, x, jnp.ones_like(x)))}
    jax_save_checkpoint(str(root / "ckpts" / "00002_state.npz"), {"g_params": g})
    torch.save(neurips_state_dict(0), root / "vocoder.pt")
    return root


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


@pytest.fixture(scope="module", params=["vocoder", "griffin_lim"])
def runs(request, corpus):
    """Both CLIs on the corpus with one decoder and --compute_mcd: their
    output directories and printed lines."""
    decoder = (["--vocoder_ckpt", str(corpus / "vocoder.pt")] if request.param == "vocoder"
               else ["--griffin_lim", "--griffin_lim_iters", "4"])
    out = {}
    for pkg, fn, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        name = f"{pkg}_{request.param}"
        text = _run(fn, ["--name", name, "--save_dir", str(corpus / "results"),
                         "--preprocessed_data_dir", str(corpus / "pre"),
                         "--ckpt_dir", str(corpus / "ckpts"), "--load_epoch", "2",
                         "--residual_channels", str(R), "--compute_mcd", *decoder, *extra])
        out[pkg] = (corpus / "results" / name / "converted_audio_2", text)
    return request.param, out


def test_cli_wavs_match_jax(runs):
    _, out = runs
    for i, t in enumerate(LENGTHS):
        for kind in ("converted", "original"):
            stem = f"{i}-{kind}_VCC2SF3_to_VCC2TF1.wav"
            want, sr = jax_read_wav(str(out["jax"][0] / stem))
            got, sr_got = read_wav(str(out["port"][0] / stem))
            assert sr == sr_got == 22050 and got.shape == want.shape == (t * 256,)
            assert np.ptp(want) > 30 * PCM_STEP  # not silence or a constant
            np.testing.assert_allclose(got, want, atol=3 * PCM_STEP, rtol=0)
    assert not list(out["port"][0].glob("*.npy"))


def _figures(text: str, prefix: str):
    line = next(l for l in text.splitlines() if l.startswith(prefix))
    return line, [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


@pytest.mark.parametrize("prefix", ["MCD(log-mel-DCT)", "MCD(warped-cepstral, wav)",
                                    "F0 median:"])
def test_cli_scores_match_jax(runs, prefix):
    _, out = runs
    want_line, want = _figures(out["jax"][1], prefix)
    got_line, got = _figures(out["port"][1], prefix)
    assert "(n=2)" in got_line or prefix == "F0 median:"
    # one unit of the last printed digit: 0.001 dB for MCD/MSD, 0.1 Hz for F0
    unit = 0.1 if prefix == "F0 median:" else 0.001
    assert len(got) == len(want) and np.allclose(got, want, atol=unit + 1e-9, rtol=0), (
        got_line, want_line)
