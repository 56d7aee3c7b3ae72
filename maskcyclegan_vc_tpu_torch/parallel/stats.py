"""Per-speaker normalization statistics with collectives.

Counterpart of ``maskcyclegan_vc_tpu/parallel/stats.py``. The reference
takes a speaker's mean and std over all its frames in one numpy pass; here
each process contributes the sums of its contiguous block of the speaker's
padded frame bank, and an all-reduce gives every process the same
statistics:

    S1 = sum(x), S2 = sum(x^2), N = frame count      (this process's block)
    mean = S1 / N,  std = sqrt(max(S2 / N - mean^2, 0)) + 1e-9

(biased, with the reference's epsilon), over all-reduced S1, S2 and N.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from maskcyclegan_vc_tpu_torch.parallel.dist import local_batch_slice, world_size


def collective_norm_stats(frames: torch.Tensor, frame_valid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global mel mean and std from each process's block of frames.

    ``frames``: (n, M, T) this process's utterances, ``frame_valid``: (n, T)
    1 where a frame is real (padding excluded). Returns (mean, std), (M, 1)
    float32 each, the same on every process."""
    x = frames.float()
    v = frame_valid.float()[:, None, :]
    sums = torch.cat([(x * v).sum(dim=(0, 2)), (x.square() * v).sum(dim=(0, 2)),
                      v.sum().reshape(1)])
    if dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    m = x.shape[1]
    s1, s2, n = sums[:m], sums[m:2 * m], sums[2 * m]
    mean = s1 / n
    std = torch.sqrt(torch.clamp(s2 / n - mean.square(), min=0.0)) + 1e-9
    return mean[:, None], std[:, None]


def norm_stats_over_ranks(mels: List[np.ndarray], device="cpu"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Collective drop-in for ``data.dataset.compute_norm_stats``.

    Every process passes the speaker's whole utterance list; the list is
    padded into an (N, M, Tmax) bank with N a multiple of the world size,
    and each process sums its contiguous block of N / world rows on
    ``device`` (the process group's: the card for NCCL, the CPU for gloo).
    Returns (mean, std), (M, 1) float32 numpy arrays."""
    n_rank = world_size()
    m = mels[0].shape[0]
    t_max = max(x.shape[1] for x in mels)
    n = -(-len(mels) // n_rank) * n_rank
    frames = np.zeros((n, m, t_max), np.float32)
    valid = np.zeros((n, t_max), np.float32)
    for i, x in enumerate(mels):
        frames[i, :, :x.shape[1]] = x
        valid[i, :x.shape[1]] = 1.0
    rows = local_batch_slice(n)
    mean, std = collective_norm_stats(torch.from_numpy(frames[rows]).to(device),
                                      torch.from_numpy(valid[rows]).to(device))
    return mean.cpu().numpy(), std.cpu().numpy()
