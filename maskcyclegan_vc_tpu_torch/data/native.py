"""ctypes binding of the native wav decoder and resampler (``native/wavio.cpp``).

Counterpart of ``maskcyclegan_vc_tpu/data/native.py``. The C++ source stays
where it is, read-only: ``g++`` builds it at first use into
``build/native/wavio-<digest>.so`` beside the package (the digest covers
the source and the flags, as ``ops/cuda_lib.py`` names its kernels), never
into ``native/``. Every entry point mirrors ``data/audio_io``'s numpy
version; ``available()`` says whether the toolchain built it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from math import gcd
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "wavio.cpp"
BUILD_DIR = _REPO / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"wavio-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.wav_decode.restype = ctypes.c_longlong
    lib.wav_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, _F32P, ctypes.c_longlong,
                               ctypes.POINTER(ctypes.c_int)]
    lib.resample_poly.restype = ctypes.c_longlong
    lib.resample_poly.argtypes = [_F32P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  _F32P, ctypes.c_longlong]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built or builds here (``g++`` present)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(float32 mono audio in [-1, 1], sample rate), as ``audio_io.read_wav``."""
    lib = _load()
    with open(path, "rb") as f:
        data = f.read()
    sr = ctypes.c_int(0)
    n = lib.wav_decode(data, len(data), None, 0, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: wav_decode error {n}")
    out = np.empty(n, np.float32)
    got = lib.wav_decode(data, len(data), out.ctypes.data_as(_F32P), n, ctypes.byref(sr))
    if got < 0:
        raise ValueError(f"{path}: wav_decode error {got}")
    return out[:got], sr.value


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling by sr_out / sr_in, as ``audio_io.resample``."""
    if sr_in == sr_out:
        return np.asarray(audio, np.float32)
    lib = _load()
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    x = np.ascontiguousarray(audio, np.float32)
    n_out = lib.resample_poly(x.ctypes.data_as(_F32P), x.size, up, down, None, 0)
    out = np.empty(n_out, np.float32)
    got = lib.resample_poly(x.ctypes.data_as(_F32P), x.size, up, down,
                            out.ctypes.data_as(_F32P), n_out)
    return out[:got]


def load_audio(path: str, target_sr: int = 22050) -> np.ndarray:
    x, sr = read_wav(path)
    return resample(x, sr, target_sr)
