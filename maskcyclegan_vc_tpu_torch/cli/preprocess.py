"""Preprocess CLI: wavs -> log-mels -> per-speaker z-norm -> pickles.

Counterpart of ``maskcyclegan_vc_tpu/cli/preprocess.py``, with its flags
and one more, ``--device {cuda,cpu}`` (cuda by default, with no silent
fallback). For each speaker it reads ``<data_directory>/<id>/**/*.wav``
(mono, resampled to 22050 Hz), computes each utterance's log-mel with the
fused mel kernel on the card (its plain version on the CPU), drops
utterances shorter than 64 frames, and writes
``<preprocessed_data_directory>/<id>/<id>_normalized.pickle`` and
``<id>_norm_stat.npz``, the files both packages' ``load_speaker`` read.
Statistics are numpy's, over the speaker's frames; with ``--distributed``
under torchrun and more than one process, every process computes every
utterance's log-mel and the statistics come from all-reduced sums of each
process's block of the speaker's frames (``parallel/stats.py``), as the
JAX CLI takes them with collectives when it sees more than one device; rank
0 writes the files.

    python -m maskcyclegan_vc_tpu_torch.cli.preprocess \\
        --data_directory vcc2018/vcc2018_training \\
        --preprocessed_data_directory vcc2018_preprocessed/vcc2018_training \\
        --speaker_ids VCC2SF3 VCC2TF1 [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Callable

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.data.audio_io import load_audio
from maskcyclegan_vc_tpu_torch.data.dataset import (
    compute_norm_stats,
    normalize,
    save_speaker,
)
from maskcyclegan_vc_tpu_torch.data.melspec import (
    HOP_LENGTH,
    N_FFT,
    PAD,
    SAMPLE_RATE,
    num_frames,
)
from maskcyclegan_vc_tpu_torch.ops.melspec import log_mel_spectrogram_fused
from maskcyclegan_vc_tpu_torch.parallel.dist import finalize, initialize, rank, world_size
from maskcyclegan_vc_tpu_torch.parallel.stats import norm_stats_over_ranks
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device

BUCKET_FRAMES = 64  # the JAX package's jit shape bucket, kept so outputs match
MIN_FRAMES = 64  # shorter utterances are dropped, as the reference's preprocessing does


def make_mel_fn(device) -> Callable[[np.ndarray], np.ndarray]:
    """(L,) audio -> (80, t) log-mel, as the JAX package's bucketed path:
    reflect pad of 384 samples on the host, zero-extend to the padded
    length of a multiple of 64 frames (or cut the reflected tail that no
    kept frame reads), one frontend call, crop to the t frames."""
    device = torch.device(device)

    @torch.inference_mode()
    def mel_fn(audio: np.ndarray) -> np.ndarray:
        t = num_frames(audio.shape[0])
        tb = -(-t // BUCKET_FRAMES) * BUCKET_FRAMES
        need = (tb - 1) * HOP_LENGTH + N_FFT
        a = np.pad(audio, (PAD, PAD), mode="reflect")
        a = np.pad(a, (0, max(0, need - a.shape[0])))[:need]
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(device)
        return log_mel_spectrogram_fused(x, pad=False)[0, :, :t].cpu().numpy()

    return mel_fn


def preprocess_speaker(data_dir: str, out_dir: str, speaker_id: str,
                       mel_fn: Callable[[np.ndarray], np.ndarray], device="cpu") -> int:
    """One speaker's wavs -> its normalized pickle and stats; returns the
    number of utterances kept. With more than one process the statistics
    are collective, summed on ``device`` (the process group's), and only
    rank 0 writes."""
    wavs = sorted(glob.glob(os.path.join(data_dir, speaker_id, "**/*.wav"),
                            recursive=True))
    if not wavs:
        raise FileNotFoundError(f"no wavs under {data_dir}/{speaker_id}")
    mels = []
    for w in wavs:
        mel = mel_fn(load_audio(w, target_sr=SAMPLE_RATE))
        if mel.shape[1] >= MIN_FRAMES:
            mels.append(mel)
    if not mels:
        raise ValueError(f"{speaker_id}: no utterance of {MIN_FRAMES} frames or more")
    if world_size() > 1:
        mean, std = norm_stats_over_ranks(mels, device)
    else:
        mean, std = compute_norm_stats(mels)
    if rank() == 0:
        save_speaker(out_dir, speaker_id, normalize(mels, mean, std), mean, std)
    return len(mels)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_directory", type=str, required=True)
    p.add_argument("--preprocessed_data_directory", type=str, required=True)
    p.add_argument("--speaker_ids", nargs="+", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group: collective statistics over "
                        "its processes (parallel/stats.py)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    created = initialize(args.device) if args.distributed else False
    try:
        device = resolve_device(args.device)
        mel_fn = make_mel_fn(device)
        for sid in args.speaker_ids:
            n = preprocess_speaker(args.data_directory, args.preprocessed_data_directory,
                                   sid, mel_fn, device)
            print(f"{sid}: {n} utterances preprocessed")
    finally:
        finalize(created)


if __name__ == "__main__":
    main()
