"""The fused mel frontend (K8): padded audio -> log10-mel in one kernel.

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/melspec_kernel.py``
(``log_mel_spectrogram_pallas``). ``log_mel_spectrogram_fused`` launches
``csrc/melspec.cu`` for audio on the card and runs
``log_mel_spectrogram_plain`` (``data/melspec.log_mel_spectrogram``) for
audio on the CPU; anything else raises. One call is one launch. Inference
only, as in JAX: a call that would need a gradient raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.data.melspec import (
    N_FFT,
    N_MELS,
    PAD,
    _dft_bases,
    hann_window_periodic,
    log_mel_spectrogram,
    mel_filterbank,
    num_frames,
)
from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel
from maskcyclegan_vc_tpu_torch.utils import debug

LOG_MEL_KERNEL = CudaKernel("melspec", "log_mel_forward",
                            [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, PTR])


# The kernel's bins, padded to its 8 blocks of 68 (csrc/melspec.cu, kCluster
# and kSliceBins).
BLOCKS, SLICE_BINS = 8, 68
BINS_PAD = BLOCKS * SLICE_BINS


def _to_tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (ties away), as the kernel's ``to_tf32``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_pairs(x: np.ndarray) -> np.ndarray:
    """Finite f32 x -> (..., 2) pairs (hi, lo) of TF32 values, x = hi + lo
    to ~2^-22 of x: the split the kernel's ``split`` makes of the audio."""
    hi = _to_tf32(x)
    return np.stack([hi, _to_tf32(np.float32(x) - hi)], -1)


def blocked(bases: np.ndarray) -> np.ndarray:
    """(1024, 513) -> (8, 1024, 68, 2): bins padded with zeros to 544, block
    r's 68 bins of every sample contiguous (the kernel copies a block's
    rows of a chunk as one run), each value as its TF32 (hi, lo) pair."""
    padded = np.pad(bases, ((0, 0), (0, BINS_PAD - bases.shape[1])))
    return tf32_pairs(padded.reshape(bases.shape[0], BLOCKS, SLICE_BINS).transpose(1, 0, 2))


@functools.lru_cache(maxsize=None)
def kernel_constants(device: str):
    """(win*cos, win*sin, mel filterbank^T) on ``device``: (8, 1024, 68, 2),
    (8, 1024, 68, 2), (544, 80) float32. Bins 0..512 hold the values the JAX
    kernel's ``_windowed_bases`` builds (float32 window times float32
    bases), split into TF32 (hi, lo) pairs, and the filterbank's; the 31
    bins past them are zeros. Bin 68 r + i of sample n is at [r, n, i] of
    the bases (``blocked``)."""
    cos_b, sin_b = _dft_bases(N_FFT)
    win = hann_window_periodic()[:, None]
    consts = (blocked(win * cos_b), blocked(win * sin_b),
              np.pad(mel_filterbank().T, ((0, BINS_PAD - cos_b.shape[1]), (0, 0))))
    return tuple(torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(device)
                 for c in consts)


def log_mel_spectrogram_plain(audio: torch.Tensor, pad: bool = True) -> torch.Tensor:
    """(B, L) audio -> (B, 80, T) in plain PyTorch (matrix-product DFT)."""
    return log_mel_spectrogram(audio, pad=pad)


def log_mel_spectrogram_fused(audio: torch.Tensor, pad: bool = True) -> torch.Tensor:
    """(B, L) f32 audio -> (B, 80, T) log10-mel. ``pad=False``: the audio
    is already reflect-padded by 384 samples a side (the bucketed
    preprocess path)."""
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError(f"expected (B, L) float32 audio, got {tuple(audio.shape)} "
                         f"{audio.dtype}")
    if torch.is_grad_enabled() and audio.requires_grad:
        raise NotImplementedError("the mel frontend has no backward")
    if audio.device.type == "cpu":
        return log_mel_spectrogram_plain(audio, pad)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    if pad:
        audio = F.pad(audio[:, None], (PAD, PAD), mode="reflect")[:, 0]
    audio = audio.contiguous()
    B, L = audio.shape
    T = num_frames(L, pad=False)
    if T < 1:
        raise ValueError(f"{L} padded samples hold no {N_FFT}-sample frame")
    wc, ws, melT = kernel_constants(str(audio.device))
    out = torch.empty((B, N_MELS, T), device=audio.device, dtype=torch.float32)
    with torch.cuda.device(audio.device):
        LOG_MEL_KERNEL(audio.data_ptr(), wc.data_ptr(), ws.data_ptr(), melT.data_ptr(),
                       out.data_ptr(), B, L, T, torch.cuda.current_stream().cuda_stream)
    debug.check_kernel_outputs(LOG_MEL_KERNEL.symbol, out)
    return out
