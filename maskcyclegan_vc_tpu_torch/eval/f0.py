"""Autocorrelation F0 tracking, from waveforms or directly from log-mels.

A copy of ``maskcyclegan_vc_tpu/eval/f0.py`` on the port's frontend
(``data/melspec.py``). The reference evaluates conversions only by
listening (TensorBoard audio); the one objective
property a CycleGAN-VC conversion must exhibit is that the converted
utterance's fundamental frequency distribution moves from the source
speaker's range into the target's. This module measures that without a
vocoder or a listening test:

  * :func:`f0_from_waveform` — classic frame-wise autocorrelation pitch
    tracker (FFT-based autocorrelation via Wiener-Khinchin, peak pick in
    the pitch-lag band, parabolic interpolation, energy+periodicity
    voicing gate).
  * :func:`f0_from_log_mel` — the same autocorrelation analysis driven
    from a log10-mel spectrogram (the representation this framework
    trains on): the mel magnitudes are least-squares projected back to
    the linear-frequency grid through the same Slaney filterbank the
    frontend applied (data/melspec.py), the per-frame power spectrum is
    inverse-FFT'd into an autocorrelation, and the peak lag is read out
    exactly as in the waveform tracker. No vocoder needed, so converted
    mels can be scored directly.

Host-side numpy by design: F0 scoring runs at eval/checkpoint cadence,
never in the jitted hot loop.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from maskcyclegan_vc_tpu_torch.data.melspec import (
    HOP_LENGTH,
    N_FFT,
    SAMPLE_RATE,
    mel_filterbank,
)


def _pick_peaks(r: np.ndarray, lag_min: int, lag_max: int,
                voicing_threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Peak lag (parabolic-refined) + voicing decision per frame.

    r: (T, L) autocorrelation rows, r[:, 0] = frame energy.
    Returns (lags float (T,), voiced bool (T,)).
    """
    band = r[:, lag_min:lag_max + 1]
    k = np.argmax(band, axis=1) + lag_min  # (T,)
    t = np.arange(r.shape[0])
    r0 = np.maximum(r[:, 0], 1e-12)
    periodicity = r[t, k] / r0

    # Parabolic interpolation around the integer peak for sub-lag accuracy.
    km = np.clip(k - 1, 0, r.shape[1] - 1)
    kp = np.clip(k + 1, 0, r.shape[1] - 1)
    denom = r[t, km] - 2.0 * r[t, k] + r[t, kp]
    delta = np.where(np.abs(denom) > 1e-12,
                     0.5 * (r[t, km] - r[t, kp]) / np.where(denom == 0, 1, denom),
                     0.0)
    delta = np.clip(delta, -0.5, 0.5)

    energy = r[:, 0]
    voiced = (periodicity > voicing_threshold) & (
        energy > 0.05 * np.max(energy) if energy.size else False)
    return k + delta, voiced


def f0_from_waveform(
    wav: np.ndarray,
    sr: int = SAMPLE_RATE,
    frame_length: int = N_FFT,
    hop: int = HOP_LENGTH,
    fmin: float = 60.0,
    fmax: float = 500.0,
    voicing_threshold: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-wise autocorrelation F0 track of a waveform.

    Returns ``(f0, voiced)``: per-frame F0 in Hz (0 where unvoiced) and
    the boolean voicing mask.
    """
    wav = np.asarray(wav, np.float64).reshape(-1)
    n_frames = max(0, 1 + (wav.shape[0] - frame_length) // hop)
    if n_frames == 0:
        return np.zeros(0), np.zeros(0, bool)
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(frame_length)[None, :])
    frames = wav[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    # Autocorrelation via Wiener-Khinchin with zero padding (linear, not
    # circular, correlation).
    nfft = 2 * frame_length
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    r = np.fft.irfft(np.abs(spec) ** 2, n=nfft, axis=1)[:, :frame_length]

    lag_min = max(1, int(np.floor(sr / fmax)))
    lag_max = min(frame_length - 2, int(np.ceil(sr / fmin)))
    lags, voiced = _pick_peaks(r, lag_min, lag_max, voicing_threshold)
    f0 = np.where(voiced, sr / np.maximum(lags, 1e-6), 0.0)
    return f0, voiced


@functools.lru_cache(maxsize=2)
def _mel_pinv(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Least-norm right-inverse of the Slaney filterbank: (n_fft//2+1, n_mels).

    S ≈ pinv @ mel recovers a linear-frequency magnitude spectrum whose
    harmonic peak structure is preserved well enough for lag analysis
    (exact inversion is impossible — the filterbank is 80x513).
    """
    fb = mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels).astype(np.float64)
    gram = fb @ fb.T
    gram += 1e-8 * np.trace(gram) / gram.shape[0] * np.eye(gram.shape[0])
    return (fb.T @ np.linalg.inv(gram))


def f0_from_log_mel(
    log10_mel: np.ndarray,
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    fmin: float = 60.0,
    fmax: float = 500.0,
    voicing_threshold: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-wise F0 track read directly from a log10-mel spectrogram.

    Args:
      log10_mel: (n_mels, T) DENORMALIZED log10-mel (i.e. ``mel*std+mean``
        — the scale the vocoder consumes; normalized model outputs must be
        denormalized with the appropriate speaker stats first).

    Returns ``(f0, voiced)`` as in :func:`f0_from_waveform`.
    """
    mel = np.power(10.0, np.asarray(log10_mel, np.float64))  # magnitudes
    spec = _mel_pinv(sr, n_fft, mel.shape[0]) @ mel  # (n_fft//2+1, T)
    spec = np.maximum(spec, 0.0)
    # Power spectrum -> autocorrelation (Wiener-Khinchin). The frame was
    # Hann-windowed at analysis time; the window's own autocorrelation
    # decays smoothly and does not move the pitch peak.
    r = np.fft.irfft(spec.T ** 2, n=n_fft, axis=1)[:, : n_fft // 2]

    lag_min = max(1, int(np.floor(sr / fmax)))
    lag_max = min(n_fft // 2 - 2, int(np.ceil(sr / fmin)))
    lags, voiced = _pick_peaks(r, lag_min, lag_max, voicing_threshold)
    f0 = np.where(voiced, sr / np.maximum(lags, 1e-6), 0.0)
    return f0, voiced


def median_f0(f0: np.ndarray, voiced: np.ndarray) -> float:
    """Median F0 over voiced frames (0.0 if nothing is voiced)."""
    v = f0[np.asarray(voiced, bool)]
    return float(np.median(v)) if v.size else 0.0


def utterance_f0(log10_mel: np.ndarray, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, **kwargs) -> float:
    """Median F0 of one (optionally normalized) mel utterance.

    When ``mean``/``std`` are given the input is treated as a normalized
    mel (the training representation) and denormalized first.
    """
    m = np.asarray(log10_mel, np.float64)
    if mean is not None and std is not None:
        m = m * np.asarray(std) + np.asarray(mean)
    return median_f0(*f0_from_log_mel(m, **kwargs))
