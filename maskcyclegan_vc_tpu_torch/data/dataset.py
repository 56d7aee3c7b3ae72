"""Per-speaker mel files in the reference's on-disk layout.

Counterpart of ``load_speaker`` and ``save_speaker`` of
``maskcyclegan_vc_tpu/data/dataset.py``: ``<dir>/<id>/<id>_normalized.pickle``
holds the list of normalized (M, T) mels and ``<id>_norm_stat.npz`` the
speaker's mean and std, (M, 1) each.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np


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
