"""Per-speaker mel files, and the training sampler on the device.

Counterpart of ``maskcyclegan_vc_tpu/data/dataset.py``.
``load_speaker`` and ``save_speaker`` keep the reference's on-disk layout:
``<dir>/<id>/<id>_normalized.pickle`` holds the list of normalized (M, T)
mels and ``<id>_norm_stat.npz`` the speaker's mean and std, (M, 1) each, which
``compute_norm_stats`` takes and ``normalize`` applies at preprocessing.

``MelBank`` holds a speaker's corpus on the device as one padded array and
``sample_batch`` draws a training batch there from a ``torch.Generator``,
with the JAX sampler's distributions, per side and per slot:

    utterance      ~ U{0..N-1}
    crop start     = floor(u * (len - n_frames + 1)),  u ~ U[0, 1)
    mask size      ~ U{0..max_mask_len-1}
    mask start     = floor(u' * (n_frames - size)),    u' ~ U[0, 1)

``step_generator`` seeds the generator from (seed, step), so a resumed run
draws the batches an uninterrupted run draws: the contract of JAX's
``fold_in(base_key, step)``, though not its bits. A CUDA graph of the step
reseeds one registered generator with ``step_seed`` before each replay
instead: a generator seeded afresh starts at Philox offset 0 either way, so
both draw the same bits.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch


def compute_norm_stats(mels: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-speaker mean and std over the concatenated frames, the std
    plus 1e-9 (the reference's preprocessing). (M, 1) float32 each."""
    cat = np.concatenate(mels, axis=1)
    mean = cat.mean(axis=1, keepdims=True)
    std = cat.std(axis=1, keepdims=True) + 1e-9
    return mean.astype(np.float32), std.astype(np.float32)


def normalize(mels: List[np.ndarray], mean, std) -> List[np.ndarray]:
    return [((m - mean) / std).astype(np.float32) for m in mels]


def save_speaker(out_dir: str, speaker_id: str, normalized: List[np.ndarray],
                 mean: np.ndarray, std: np.ndarray) -> None:
    d = os.path.join(out_dir, speaker_id)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"{speaker_id}_norm_stat.npz"), mean=mean, std=std)
    with open(os.path.join(d, f"{speaker_id}_normalized.pickle"), "wb") as f:
        pickle.dump(normalized, f)


def load_speaker(data_dir: str, speaker_id: str):
    """Returns (mels, mean, std). The mels are a pickle: load only files
    that a preprocessing run of this project wrote."""
    d = os.path.join(data_dir, speaker_id)
    with open(os.path.join(d, f"{speaker_id}_normalized.pickle"), "rb") as f:
        mels = pickle.load(f)
    with np.load(os.path.join(d, f"{speaker_id}_norm_stat.npz")) as stats:
        mean, std = stats["mean"], stats["std"]
    return [np.asarray(m, np.float32) for m in mels], mean, std


@dataclasses.dataclass
class MelBank:
    """Padded utterance store on one device: data (N, M, Tmax), lengths (N,)."""

    data: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def from_list(mels: List[np.ndarray], min_frames: int = 64,
                  device="cpu") -> "MelBank":
        """From (M, T) arrays, dropping those shorter than ``min_frames`` (the
        reference's preprocessing drops short utterances)."""
        kept = [m for m in mels if m.shape[1] >= min_frames]
        if not kept:
            raise ValueError("no utterances with enough frames")
        tmax = max(m.shape[1] for m in kept)
        data = np.zeros((len(kept), kept[0].shape[0], tmax), np.float32)
        for i, m in enumerate(kept):
            data[i, :, :m.shape[1]] = m
        lengths = np.array([m.shape[1] for m in kept], np.int64)
        return MelBank(torch.from_numpy(data).to(device),
                       torch.from_numpy(lengths).to(device))

    def __len__(self) -> int:
        return self.data.shape[0]


def step_seed(seed: int, step: int) -> int:
    """The sampler's seed for one step, from (seed, step) alone."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return int(mixed) & (2 ** 63 - 1)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``step_seed(seed, step)``."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _sample_side(gen: torch.Generator, bank: MelBank, batch: int, n_frames: int,
                 max_mask_len: int):
    n, m, _ = bank.data.shape
    dev = bank.data.device
    utt = torch.randint(0, n, (batch,), generator=gen, device=dev)
    lens = bank.lengths[utt]
    u = torch.rand(batch, generator=gen, device=dev)
    start = (u * (lens - n_frames + 1)).long().clamp_max(lens - n_frames)
    t = torch.arange(n_frames, device=dev)
    idx = (start[:, None] + t[None, :])[:, None, :].expand(batch, m, n_frames)
    frames = torch.gather(bank.data[utt], 2, idx)

    size = torch.randint(0, max_mask_len, (batch,), generator=gen, device=dev)
    u2 = torch.rand(batch, generator=gen, device=dev)
    mstart = (u2 * (n_frames - size)).long()
    hole = (t[None, :] >= mstart[:, None]) & (t[None, :] < (mstart + size)[:, None])
    mask = (~hole).to(torch.float32)[:, None, :].expand(batch, m, n_frames)
    return frames, mask.contiguous()


def sample_batch(gen: torch.Generator, bank_a: MelBank, bank_b: MelBank, batch: int,
                 n_frames: int = 64, max_mask_len: int = 25) -> Dict[str, torch.Tensor]:
    """A paired training batch of (batch, M, n_frames) crops and FIF masks
    (1 = keep), drawn on the banks' device; side A first, then side B."""
    real_a, mask_a = _sample_side(gen, bank_a, batch, n_frames, max_mask_len)
    real_b, mask_b = _sample_side(gen, bank_b, batch, n_frames, max_mask_len)
    return {"real_A": real_a, "mask_A": mask_a, "real_B": real_b, "mask_B": mask_b}
