"""Vocoder-free mel -> waveform decode (Griffin-Lim), on the host in numpy.

A copy of ``maskcyclegan_vc_tpu/data/griffin_lim.py``, on the port's
frontend constants: least-squares inversion of the Slaney mel filterbank
back to a linear magnitude spectrogram, then accelerated Griffin-Lim phase
retrieval against the analysis STFT of ``data/melspec.py`` (n_fft 1024,
hop 256, periodic Hann), from the same seeded random phase with the same
momentum. Numpy by design, as in the JAX package: it runs at evaluation
cadence, where numpy FFTs suffice.
"""

from __future__ import annotations

import functools

import numpy as np

from maskcyclegan_vc_tpu_torch.data.melspec import (
    HOP_LENGTH,
    N_FFT,
    hann_window_periodic,
    mel_filterbank,
)


@functools.lru_cache(maxsize=2)
def _fb_and_pinv(n_mels: int):
    fb = mel_filterbank(n_mels=n_mels).astype(np.float64)  # (M, F)
    gram = fb @ fb.T
    gram += 1e-8 * np.trace(gram) / gram.shape[0] * np.eye(gram.shape[0])
    pinv = fb.T @ np.linalg.inv(gram)  # (F, M)
    return fb.astype(np.float32), pinv.astype(np.float32)


def mel_to_linear(log10_mel) -> np.ndarray:
    """(M, T) log10-mel -> (F, T) linear magnitude (clamped >= 0)."""
    m = np.power(10.0, np.asarray(log10_mel, np.float64))
    _, pinv = _fb_and_pinv(m.shape[0])
    return np.maximum(pinv.astype(np.float64) @ m, 0.0).astype(np.float32)


def _stft(x: np.ndarray, win: np.ndarray) -> np.ndarray:
    """(L,) -> (T, F) complex, center=False frames."""
    n_frames = 1 + (x.shape[-1] - N_FFT) // HOP_LENGTH
    idx = (np.arange(n_frames)[:, None] * HOP_LENGTH
           + np.arange(N_FFT)[None, :])
    return np.fft.rfft(x[idx] * win, axis=-1)


def _istft(frames: np.ndarray, win: np.ndarray, length: int) -> np.ndarray:
    """(T, F) -> (length,) via windowed overlap-add + win^2 normalization."""
    x = np.fft.irfft(frames, n=N_FFT, axis=-1) * win  # (T, N)
    T = x.shape[0]
    out_len = (T - 1) * HOP_LENGTH + N_FFT
    acc = np.zeros(out_len, np.float64)
    norm = np.zeros(out_len, np.float64)
    w2 = np.square(win)
    for i in range(T):
        s = i * HOP_LENGTH
        acc[s:s + N_FFT] += x[i]
        norm[s:s + N_FFT] += w2
    return (acc / np.maximum(norm, 1e-8))[:length]


def griffin_lim(magnitude, n_iter: int = 60, length: int = None,
                seed: int = 0, momentum: float = 0.99) -> np.ndarray:
    """Phase retrieval: (F, T) magnitudes -> (L,) waveform.

    Uses the accelerated ("fast") Griffin-Lim update (Perraudin et al.
    2013): the projection input is extrapolated with a momentum term,
    converging to a noticeably cleaner phase estimate at the same
    iteration count than the classic alternation (``momentum=0``
    recovers classic GL). ``length`` defaults to the frame-aligned
    (T-1)*hop + n_fft samples.
    """
    mag = np.asarray(magnitude, np.float64).T  # (T, F)
    T = mag.shape[0]
    out_len = (T - 1) * HOP_LENGTH + N_FFT
    if length is None:
        length = out_len
    win = hann_window_periodic().astype(np.float64)

    rs = np.random.RandomState(seed)
    phase = rs.uniform(-np.pi, np.pi, size=mag.shape)
    frames = mag * np.exp(1j * phase)
    prev = np.zeros_like(frames)
    for _ in range(n_iter):
        x = _istft(frames + momentum * (frames - prev), win, out_len)
        rebuilt = _stft(x, win)
        prev = frames
        # Keep the target magnitude, adopt the projected phase.
        ang = rebuilt / np.maximum(np.abs(rebuilt), 1e-16)
        frames = mag * ang
    y = _istft(frames, win, out_len)
    peak = np.max(np.abs(y))
    y = y / max(peak, 1e-8) * 0.85
    return y[:length].astype(np.float32)


def decode_mel_griffin_lim(log10_mel, mean=None, std=None,
                           n_iter: int = 60) -> np.ndarray:
    """One (M, T) (optionally normalized) mel -> float32 waveform in [-1, 1].

    Mirrors ``models/melgan.decode_mel``'s contract: when ``mean``/``std``
    are given the input is denormalized first (the test CLI passes the
    TARGET speaker's stats, reference test.py:94-98). The analysis
    reflect-padding (p = (n_fft-hop)/2 per side) added 1.5 frames of
    context at each edge; trim p samples at the head so the audio aligns
    with the original utterance timing, and cut to T*hop samples.
    """
    m = np.asarray(log10_mel, np.float64)
    if mean is not None and std is not None:
        m = m * np.asarray(std) + np.asarray(mean)
    spec = mel_to_linear(m)
    wav = griffin_lim(spec, n_iter=n_iter)
    p = (N_FFT - HOP_LENGTH) // 2
    return wav[p:p + m.shape[-1] * HOP_LENGTH]
