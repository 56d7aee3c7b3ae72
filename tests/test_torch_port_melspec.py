"""The port's mel frontend (K8's plain version and the bucketed preprocess
path) against the JAX package's, on the CPU.

The same seeded audio goes through both. Tolerance atol 1e-5 in log10
units, the JAX package's own for its two frontends
(``tests/test_pallas_melspec.py``): f32 products in another summation
order. The filterbank, window and DFT bases are built by the same float64
numpy code and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.cli.preprocess import make_mel_fn as jax_make_mel_fn
from maskcyclegan_vc_tpu.data import melspec as jax_melspec
from maskcyclegan_vc_tpu.ops.pallas.melspec_kernel import (
    _windowed_bases,
    log_mel_spectrogram_pallas,
)
from maskcyclegan_vc_tpu_torch.cli.preprocess import make_mel_fn
from maskcyclegan_vc_tpu_torch.data import melspec
from maskcyclegan_vc_tpu_torch.ops.melspec import (
    LOG_MEL_KERNEL,
    kernel_constants,
    log_mel_spectrogram_fused,
    log_mel_spectrogram_plain,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=0)


def test_constants_equal_jax():
    np.testing.assert_array_equal(melspec.mel_filterbank(), jax_melspec.mel_filterbank())
    np.testing.assert_array_equal(melspec.mel_filterbank(n_mels=16),
                                  jax_melspec.mel_filterbank(n_mels=16))
    np.testing.assert_array_equal(melspec.hann_window_periodic(),
                                  jax_melspec.hann_window_periodic())
    for a, b in zip(melspec._dft_bases(1024), jax_melspec._dft_bases(1024)):
        np.testing.assert_array_equal(a, b)
    wc, ws, melT = kernel_constants("cpu")
    jwc, jws = _windowed_bases()
    assert wc.shape == ws.shape == (8, 1024, 68, 2) and melT.shape == (544, 80)
    for pairs, want in ((wc, jwc), (ws, jws)):
        # bin 68 r + i of sample n at [r, n, i], as TF32 (hi, lo) with
        # hi + lo the JAX kernel's value to 2^-21
        pairs = pairs.permute(1, 0, 2, 3).reshape(1024, 544, 2).numpy()
        assert not (pairs.view(np.uint32) & 0x1FFF).any()
        bits = want.reshape(1024, 513).view(np.uint32)
        hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
        np.testing.assert_array_equal(pairs[:, :513, 0], hi)  # rounded to nearest, ties away
        np.testing.assert_allclose(pairs[:, :513].astype(np.float64).sum(-1),
                                   want.reshape(1024, 513), rtol=2.0 ** -21, atol=1e-30)
        assert not pairs[:, 513:].any()
    np.testing.assert_array_equal(melT.numpy()[:513], jax_melspec.mel_filterbank().T)
    assert not melT[513:].any()


@pytest.mark.parametrize("seconds", [1, 2])  # 2 s: more than one 128-frame tile
def test_log_mel_matches_both_jax_versions(seconds):
    rs = np.random.RandomState(seconds)
    x = (rs.randn(2, 22050 * seconds) * 0.3).astype(np.float32)
    want_xla = np.asarray(jax_melspec.log_mel_spectrogram(jnp.asarray(x)))
    want_pallas = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(x), interpret=True))
    before = LOG_MEL_KERNEL.launches
    got = log_mel_spectrogram_fused(torch.from_numpy(x)).numpy()
    assert LOG_MEL_KERNEL.launches == before  # the CPU runs the plain version
    assert got.shape == want_xla.shape == (2, 80, melspec.num_frames(22050 * seconds))
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(melspec.log_mel_spectrogram(torch.from_numpy(x), use_fft=True),
                               want_xla, **TOL)


def test_pad_false_takes_prepadded_audio():
    rs = np.random.RandomState(3)
    audio = (rs.randn(1, 22050) * 0.3).astype(np.float32)
    pre = np.pad(audio, ((0, 0), (melspec.PAD, melspec.PAD)), mode="reflect")
    want = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(pre), interpret=True, pad=False))
    got = log_mel_spectrogram_plain(torch.from_numpy(pre), pad=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, log_mel_spectrogram_fused(torch.from_numpy(audio)).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [22050, 22050 + 777])  # off-bucket lengths
def test_make_mel_fn_matches_jax(n):
    audio = (np.random.RandomState(n).randn(n) * 0.3).astype(np.float32)
    want = jax_make_mel_fn(use_pallas=False)(audio)
    got = make_mel_fn("cpu")(audio)
    assert got.shape == want.shape == (80, melspec.num_frames(n))
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_refuses_what_it_cannot_run():
    x = torch.zeros(1, 4096, requires_grad=True)
    with pytest.raises(NotImplementedError):
        log_mel_spectrogram_fused(x)
    with pytest.raises(ValueError):
        log_mel_spectrogram_fused(torch.zeros(4096))
    with pytest.raises(ValueError):
        log_mel_spectrogram_fused(torch.zeros(1, 4096, dtype=torch.float64))
