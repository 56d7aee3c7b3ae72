"""Procedural vowel-like speech corpus for tests and convergence runs.

A numpy copy of ``maskcyclegan_vc_tpu/data/synth.py``: the same speakers,
content draws and rendering, so a seed gives the JAX package's wavs bit for
bit. The reference trains on VCC2018, which is not in the repository; this
stand-in corpus has speakers that differ in the two properties a
voice-conversion model must learn to move: fundamental frequency (F0
register and contour) and spectral envelope (formant positions). Each
utterance is a glottal-like harmonic source (1/k harmonic rolloff) with
vibrato and a slow F0 drift, filtered through 2nd-order resonators at
speaker-specific formants, with a syllable amplitude envelope, a brief
unvoiced noise segment and a low noise floor.

"Content" (prosody: duration, F0 contour shape, syllable envelope, unvoiced
position) is drawn apart from speaker identity, so a *parallel* corpus (the
same content uttered by every speaker, like VCC2018's evaluation sentences)
can be generated for objective conversion scoring (DTW-MCD against the
parallel target utterance), while training corpora use independent content
per speaker (non-parallel, like VCC2018 training).

Deterministic: everything derives from ``numpy.random.RandomState``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav
from maskcyclegan_vc_tpu_torch.data.melspec import SAMPLE_RATE


@dataclasses.dataclass(frozen=True)
class SpeakerSpec:
    """Acoustic identity of one synthetic speaker."""

    f0_base: float  # Hz, center of the speaker's register
    f0_spread: float  # Hz, utterance-to-utterance register variation
    formants: Tuple[float, ...]  # resonance centers, Hz
    bandwidths: Tuple[float, ...]  # resonance bandwidths, Hz


# Default speakers separated in both register and envelope — named after
# the reference's demo pair (audio_samples/); VCC2SM3 is a
# third, lower register for multi-pair (launch_pairwise) runs.
DEFAULT_SPEAKERS: Dict[str, SpeakerSpec] = {
    "VCC2SF3": SpeakerSpec(205.0, 12.0, (650.0, 1080.0, 2650.0),
                           (80.0, 110.0, 160.0)),
    "VCC2TF1": SpeakerSpec(325.0, 15.0, (450.0, 2300.0, 3010.0),
                           (70.0, 120.0, 170.0)),
    "VCC2SM3": SpeakerSpec(125.0, 8.0, (730.0, 1380.0, 2400.0),
                           (90.0, 130.0, 180.0)),
}


@dataclasses.dataclass(frozen=True)
class Content:
    """Speaker-independent prosody of one utterance."""

    duration_s: float
    f0_frac: float  # register offset as a fraction of the speaker spread
    drift_frac: float  # slow F0 drift over the utterance, fraction of F0
    vib_rate: float  # vibrato Hz
    vib_phase: float
    syllables: Tuple[Tuple[float, float], ...]  # (start, end) fractions
    unvoiced_at: float  # start of the noise burst, fraction of duration
    harm_phase_seed: int  # seed for per-harmonic phase draws


def make_content(rs: np.random.RandomState,
                 duration_s: float = 1.6) -> Content:
    dur = duration_s * rs.uniform(0.85, 1.25)
    n_syll = rs.randint(2, 5)
    edges = np.sort(rs.uniform(0.05, 0.95, size=n_syll * 2))
    syl = tuple((edges[2 * i], max(edges[2 * i + 1], edges[2 * i] + 0.15 / dur))
                for i in range(n_syll))
    return Content(
        duration_s=dur,
        f0_frac=rs.uniform(-1.0, 1.0),
        drift_frac=rs.uniform(-0.06, 0.06),
        vib_rate=rs.uniform(4.5, 6.5),
        vib_phase=rs.uniform(0, 2 * np.pi),
        syllables=syl,
        unvoiced_at=rs.uniform(0.08, 0.8),
        harm_phase_seed=int(rs.randint(0, 2**31 - 1)),
    )


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """2nd-order all-pole resonance (digital formant filter)."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a1, a2 = 2.0 * r * np.cos(theta), -r * r
    from scipy.signal import lfilter

    return lfilter([1.0 - r], [1.0, -a1, -a2], x)


def synth_utterance(spec: SpeakerSpec, content: Content,
                    sr: int = SAMPLE_RATE,
                    noise_seed: int = 0) -> np.ndarray:
    """Render ``content`` in ``spec``'s voice; float32 in [-1, 1]."""
    dur = content.duration_s
    n = int(dur * sr)
    t = np.arange(n) / sr

    # F0 contour: register draw + slow drift + vibrato.
    f0_utt = spec.f0_base + content.f0_frac * spec.f0_spread
    drift = content.drift_frac * f0_utt * (t / dur)
    vibrato = 0.015 * f0_utt * np.sin(
        2.0 * np.pi * content.vib_rate * t + content.vib_phase)
    f0 = f0_utt + drift + vibrato
    phase = 2.0 * np.pi * np.cumsum(f0) / sr

    # Harmonic source with 1/k rolloff up to ~5 kHz.
    pr = np.random.RandomState(content.harm_phase_seed)
    harm_phases = pr.uniform(0, 2 * np.pi, size=64)
    n_harm = max(3, int(5000.0 / f0_utt))
    src = np.zeros(n)
    for k in range(1, min(n_harm, 64) + 1):
        src += np.sin(k * phase + harm_phases[k - 1]) / k

    # Speaker envelope: formant resonators in parallel.
    voiced = sum(_resonator(src, f, b, sr)
                 for f, b in zip(spec.formants, spec.bandwidths))

    # Syllable-like amplitude envelope.
    env = np.zeros(n)
    for a_f, b_f in content.syllables:
        a, b = a_f * dur, b_f * dur
        env += np.clip(1.0 - np.abs((t - (a + b) / 2) / ((b - a) / 2)), 0, 1)
    env = np.clip(env, 0.0, 1.0) ** 0.7
    env *= np.minimum(1.0, t / 0.02) * np.minimum(1.0, (dur - t) / 0.02)

    # Brief unvoiced (noise-burst) segment, as consonants would be.
    nr = np.random.RandomState(noise_seed)
    noise = nr.randn(n) * 0.15
    u0 = content.unvoiced_at * dur
    unvoiced_mask = ((t > u0) & (t < u0 + 0.12)).astype(np.float64)
    x = voiced * env * (1.0 - unvoiced_mask) + noise * unvoiced_mask * env
    x += 0.003 * nr.randn(n)  # recording-noise floor

    x = x / max(1e-9, np.abs(x).max()) * 0.6
    return x.astype(np.float32)


def make_corpus(root: str, speakers: Optional[Dict[str, SpeakerSpec]] = None,
                n_utts: int = 20, seed: int = 0, parallel: bool = False,
                duration_s: float = 1.6,
                sr: int = SAMPLE_RATE) -> Dict[str, Sequence[str]]:
    """Write ``<root>/<speaker>/<i>.wav`` for each speaker; returns paths.

    ``parallel=False`` (training-style): each speaker draws independent
    content (per-speaker RNG streams independent of speaker iteration
    order, so adding a speaker never changes another's utterances).
    ``parallel=True`` (eval-style): utterance ``i`` shares one Content
    across all speakers — index-paired utterances are the same "sentence"
    in different voices, so DTW-MCD against the paired target is a true
    conversion-quality signal.
    """
    import zlib

    speakers = speakers or {k: DEFAULT_SPEAKERS[k]
                            for k in ("VCC2SF3", "VCC2TF1")}
    out: Dict[str, Sequence[str]] = {}
    shared = None
    if parallel:
        cr = np.random.RandomState(seed * 1000 + 777)
        shared = [make_content(cr, duration_s) for _ in range(n_utts)]
    for sid, spec in sorted(speakers.items()):
        # Seed from the speaker NAME so corpora are stable under
        # adding/removing other speakers.
        sh = zlib.crc32(sid.encode()) % 100_003
        rs = np.random.RandomState((seed * 1000 + sh) % (2**31))
        d = os.path.join(root, sid)
        os.makedirs(d, exist_ok=True)
        paths = []
        for i in range(n_utts):
            content = shared[i] if shared else make_content(rs, duration_s)
            wav = synth_utterance(spec, content, sr=sr,
                                  noise_seed=(seed * 7919 + sh * 101 + i)
                                             % (2**31))
            p = os.path.join(d, f"{i}.wav")
            write_wav(p, wav, sr)
            paths.append(p)
        out[sid] = paths
    return out
