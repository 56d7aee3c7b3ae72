"""WAV read/write + resampling without external audio deps.

A copy of ``maskcyclegan_vc_tpu/data/audio_io.py`` (numpy and scipy): the
reference leans on librosa (decode/resample to 22050 Hz mono) and
torchaudio (save); this module parses RIFF/WAVE PCM 8/16/24/32 and IEEE
float in numpy and resamples polyphase with scipy.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono audio in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(raw) > 0:
        # WAVE_FORMAT_EXTENSIBLE: true format in the fmt extension GUID;
        # first two bytes of the GUID are the format code.
        audio_format = 1 if bits in (16, 24, 32) else 3

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format code {audio_format}")

    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x, sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float audio in [-1, 1] as PCM16 WAV."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample (scipy), matching librosa-quality band limiting."""
    if sr_in == sr_out:
        return audio.astype(np.float32)
    from math import gcd

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(path: str, target_sr: int = 22050) -> np.ndarray:
    """Read + mono + resample, the ``librosa.load(sr=22050, mono=True)``
    equivalent used at preprocess_vcc2018.py:33."""
    x, sr = read_wav(path)
    return resample(x, sr, target_sr)
