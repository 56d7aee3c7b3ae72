"""The mel frontend (22.05 kHz, 80 bins) in plain PyTorch.

Counterpart of ``maskcyclegan_vc_tpu/data/melspec.py``: the melgan-neurips
``Audio2Mel`` contract,

    p      = (n_fft - hop) // 2 = 384
    audio  = reflect_pad(audio, p)
    frames = stft(audio, n_fft=1024, hop=256, win=hann_periodic(1024),
                  center=False, onesided)
    mel    = mel_basis @ |frames|           # Slaney mel scale and norm
    logmel = log10(clamp(mel, 1e-5))

The filterbank and the DFT bases are built in float64 with numpy and
stored as float32, exactly as the JAX package builds them. The rDFT is two
real matrix products against those bases (``use_fft=True`` takes
``torch.fft.rfft`` instead). This is the plain version of the fused mel
kernel (``ops/melspec.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

SAMPLE_RATE = 22050
N_FFT = 1024
HOP_LENGTH = 256
WIN_LENGTH = 1024
N_MELS = 80
PAD = (N_FFT - HOP_LENGTH) // 2
MEL_FLOOR = 1e-5


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular filterbank, (n_mels,
    n_fft//2+1) float32: ``librosa.filters.mel``'s defaults."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def hann_window_periodic(n: int = WIN_LENGTH) -> np.ndarray:
    """``torch.hann_window``'s default (periodic), built in float64."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int):
    """Real and imaginary DFT bases, (n_fft, n_fft//2+1) float32 each."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def frame_signal(audio: torch.Tensor, n_fft: int = N_FFT,
                 hop: int = HOP_LENGTH) -> torch.Tensor:
    """(..., L) -> (..., n_frames, n_fft) frames, center=False."""
    return audio.unfold(-1, n_fft, hop)


def num_frames(length: int, pad: bool = True) -> int:
    """Frames of ``length`` samples: padded by 2p first unless ``pad`` is False."""
    return (length + (2 * PAD if pad else 0) - N_FFT) // HOP_LENGTH + 1


@functools.lru_cache(maxsize=None)
def _frontend_constants(device: str):
    """(window, cos basis, sin basis, filterbank) on ``device``, made once,
    so a call copies nothing from the host (CUDA graphs capture it)."""
    consts = (hann_window_periodic(), *_dft_bases(N_FFT), mel_filterbank())
    return tuple(torch.from_numpy(c).to(device) for c in consts)


def log_mel_spectrogram(audio: torch.Tensor, *, use_fft: bool = False,
                        pad: bool = True) -> torch.Tensor:
    """(..., L) float audio in [-1, 1] -> (..., n_mels, T) log10-mel.

    ``pad=False``: the caller has reflect-padded the audio already (the
    bucketed preprocess path). Products in f32; on the card only with TF32
    off, as ``utils.device.resolve_device`` leaves it.
    """
    audio = torch.as_tensor(audio, dtype=torch.float32)
    win, cos_b, sin_b, fb = _frontend_constants(str(audio.device))
    if pad:
        lead = audio.shape[:-1]
        audio = torch.nn.functional.pad(audio.reshape(-1, 1, audio.shape[-1]),
                                        (PAD, PAD), mode="reflect")
        audio = audio.reshape(*lead, audio.shape[-1])
    frames = frame_signal(audio) * win
    if use_fft:
        mag = torch.fft.rfft(frames, dim=-1).abs().to(torch.float32)
    else:
        re = frames @ cos_b
        im = frames @ sin_b
        mag = torch.sqrt(re * re + im * im + 1e-24)
    mel = (mag @ fb.T).transpose(-1, -2)
    return torch.log10(torch.clamp(mel, min=MEL_FLOOR))
