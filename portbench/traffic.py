"""The general generator: weights, speakers and utterances from the seed.

Everything a run feeds the program is drawn here, on the device, from
``torch.Generator``s seeded from (seed, purpose), in a few large calls; a
traffic file (``traffic/<name>.json``) gives only the parameters. The same
seed gives the same inputs. Where the seed picks sizes, every seed gets the
same set of sizes in another order, so that seeds change the data and not
the work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

SALT = {"G": 1, "D": 2, "vocoder": 3, "speakers": 4, "utterances": 5, "order": 6, "sample": 7,
        "stats": 8}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed."""
    mixed = np.random.SeedSequence([seed, SALT[purpose]]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & (2 ** 63 - 1))


def uniform_init(model: nn.Module, prefix: str, gen: torch.Generator, device,
                 weight_gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """Seeded parameters under ``prefix`` for ``model`` (built on the meta
    device, or anywhere: only its shapes are read), by torch's default conv
    init: each conv weight U(+-gain / sqrt(fan_in)) and bias
    U(+-1 / sqrt(fan_in)), fan_in = weight[0].numel(); each norm's scale 1
    and shift 0. One draw for the whole model."""
    named = dict(model.named_parameters())
    scale: Dict[str, float] = {}
    for mname, m in model.named_modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            scale[f"{mname}.weight"] = weight_gain * bound
            scale[f"{mname}.bias"] = bound
    n = sum(named[k].numel() for k in scale)
    flat = torch.rand(n, generator=gen, device=device).mul_(2).sub_(1)
    out, i = {}, 0
    for k, p in named.items():
        if k in scale:
            out[f"{prefix}{k}"] = flat[i:i + p.numel()].view(p.shape).mul_(scale[k])
            i += p.numel()
        else:  # an InstanceNorm's affine vectors
            fill = 1.0 if k.endswith("weight") else 0.0
            out[f"{prefix}{k}"] = torch.full(p.shape, fill, device=device)
    return out


def speakers(traffic: dict, n_mels: int, seed: int,
             device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Two speakers' mel banks, (data (N, M, Tmax), lengths (N,)) each:
    ``utterances`` normalized mels of frames uniform in ``utterance_frames``
    (inclusive), N(0, 1) values, zeros past each length."""
    gen = generator(seed, "speakers", device)
    n = traffic["utterances"]
    lo, hi = traffic["utterance_frames"]
    out = []
    for _ in range(2):
        lengths = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
        data = torch.randn((n, n_mels, hi), generator=gen, device=device)
        t = torch.arange(hi, device=device)
        data *= (t[None, None, :] < lengths[:, None, None])
        out.append((data, lengths))
    return out


def utterance_lengths(traffic: dict, seed: int) -> List[int]:
    """One cycle of the closed loop: ``count`` lengths spread evenly over
    ``utterance_frames`` (inclusive), in an order drawn from the seed."""
    lo, hi = traffic["utterance_frames"]
    count = traffic["count"]
    lengths = [round(lo + (hi - lo) * i / (count - 1)) for i in range(count)]
    order = torch.randperm(count, generator=generator(seed, "order", "cpu")).tolist()
    return [lengths[i] for i in order]


def utterances(traffic: dict, n_mels: int, seed: int, device) -> List[np.ndarray]:
    """The cycle's normalized mels, (M, t) float32 each, on the host: drawn
    on the device in one call and copied back in one transfer."""
    lengths = utterance_lengths(traffic, seed)
    gen = generator(seed, "utterances", device)
    flat = torch.randn((n_mels, sum(lengths)), generator=gen, device=device).cpu().numpy()
    out, i = [], 0
    for t in lengths:
        out.append(np.ascontiguousarray(flat[:, i:i + t]))
        i += t
    return out


def speaker_stats(n_mels: int, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """The target speaker's (M, 1) log10-mel mean and std."""
    gen = generator(seed, "stats", device)
    mean = -2.5 + 0.5 * torch.randn((n_mels, 1), generator=gen, device=device)
    std = 0.5 + 0.5 * torch.rand((n_mels, 1), generator=gen, device=device)
    return mean.cpu().numpy(), std.cpu().numpy()
