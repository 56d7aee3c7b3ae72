"""The HiFi-GAN generator (jik876/hifi-gan) for PyTorch on an NVIDIA GPU.

Kong, Kim and Bae, *HiFi-GAN* (arXiv:2010.05646): ``models.py``
``Generator`` with ``ResBlock1``, built from a vocoder dict in the keys of
the published ``config_v1.json`` (``V1``; the V2 and V3 widths are other
dicts of the same keys, ``resblock`` "1" only):

    conv_pre: conv7 n_mels -> C, zero pad 3                       (cuDNN)
    for stage i, rate u, kernel 2u:
        lrelu 0.1 -> ConvTranspose1d(k=2u, s=u, p=u/2) C/2^i -> C/2^(i+1)
                                                  (cuDNN, ``melgan.conv``)
        MRF: one ResBlock1 per kernel k (3, 7, 11) on the same input,
             each 3 x (lrelu 0.1, conv k dilated d (1, 3, 5), lrelu 0.1,
             conv k, + residual), zero padding; their sum / 3     (cuDNN)
    lrelu 0.01 (PyTorch's default slope, as the published forward calls it)
    -> conv_post: conv7 -> 1, zero pad 3 -> tanh

Every convolution is one cuDNN call in the input's dtype (f32; the
conversion path keeps TF32 off, ``utils/device.resolve_device``). Weight
norm is folded into plain weights; the parameters carry the published
names (``conv_pre``, ``ups.i``, ``resblocks.k.convs1.j``, ``convs2.j``,
``conv_post``). Inference only.

Input scale: the published model was trained on natural-log mels with fmax
8,000 Hz; the port's frontend (MelGAN's) makes log10 mels with fmax
11,025 Hz. ``HiFiGANGenerator`` takes the port's log10 mel, as MelGAN does,
so ``melgan.decode_mel`` decodes with either, and its forward multiplies the
mel by ln 10 before ``conv_pre``, which converts the logarithm's base; the
fmax mismatch is left as it is (a published checkpoint hears a mel whose top
bins it was not trained on).

Tracing: inside ``decode.vocoder``, one ``hifigan.stage`` span for each
upsample-plus-MRF stage, its index as the request; ``CONVS`` counts the
convolutions by kind (``pre``, ``up``, ``mrf``, ``post``): a V1 decode
makes 1 + 4 + 72 + 1.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maskcyclegan_vc_tpu_torch.models.melgan import _fold_weight_norm
from maskcyclegan_vc_tpu_torch.models.melgan import conv as melgan_conv
from maskcyclegan_vc_tpu_torch.obs import profiler

V1 = {"resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
      "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
      "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}
LRELU_SLOPE = 0.1
LN10 = math.log(10.0)
CONV_KINDS = ("pre", "up", "mrf", "post")
CONVS = dict.fromkeys(CONV_KINDS, 0)


def get_padding(kernel: int, dilation: int) -> int:
    return (kernel * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """Three pairs of (lrelu, conv k dilated d, lrelu, conv k), each pair
    added to its input."""

    def __init__(self, channels: int, kernel: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, dilation=d, padding=get_padding(kernel, d))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, padding=get_padding(kernel, 1))
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = conv(c1, F.leaky_relu(x, LRELU_SLOPE), "mrf")
            x = conv(c2, F.leaky_relu(xt, LRELU_SLOPE), "mrf") + x
        return x


class HiFiGANGenerator(nn.Module):
    """The HiFi-GAN generator for ``vocoder`` (keys of ``V1``); 13,926,017
    parameters at V1. Weights are made on ``device`` by PyTorch's default
    conv init, drawn from ``generator`` (a CPU ``torch.Generator``, seed 0
    when None)."""

    def __init__(self, n_mels: int = 80, vocoder: Mapping[str, Any] = V1, *, device="cpu",
                 generator: torch.Generator = None):
        super().__init__()
        if str(vocoder["resblock"]) != "1":
            raise ValueError(f"resblock {vocoder['resblock']!r}: only ResBlock1 (\"1\") is built")
        rates, kernels = vocoder["upsample_rates"], vocoder["upsample_kernel_sizes"]
        ch = vocoder["upsample_initial_channel"]
        self.n_kernels = len(vocoder["resblock_kernel_sizes"])
        with torch.device("meta"):
            self.conv_pre = nn.Conv1d(n_mels, ch, 7, padding=3)
            self.ups = nn.ModuleList(
                nn.ConvTranspose1d(ch // 2 ** i, ch // 2 ** (i + 1), k, u, padding=(k - u) // 2)
                for i, (u, k) in enumerate(zip(rates, kernels)))
            self.resblocks = nn.ModuleList(
                ResBlock1(ch // 2 ** (i + 1), k, d) for i in range(len(rates))
                for k, d in zip(vocoder["resblock_kernel_sizes"],
                                vocoder["resblock_dilation_sizes"]))
            self.conv_post = nn.Conv1d(ch // 2 ** len(rates), 1, 7, padding=3)
        self.to_empty(device=device)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    for p in (m.weight, m.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) log10 mel -> (B, T x the product of the rates)
        waveform in [-1, 1]; the published network sees mel x ln 10."""
        x = conv(self.conv_pre, mel * LN10, "pre")
        for i, up in enumerate(self.ups):
            with profiler.span("hifigan.stage", request=i):
                x = melgan_conv(up, F.leaky_relu(x, LRELU_SLOPE))
                CONVS["up"] += 1
                blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels]
                xs = blocks[0](x)
                for block in blocks[1:]:
                    xs = xs + block(x)
                x = xs / self.n_kernels
        x = conv(self.conv_post, F.leaky_relu(x), "post")
        return torch.tanh(x)[:, 0]


def conv(module: nn.Conv1d, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``module``'s zero-padded, dilated convolution, one cuDNN call; counted
    in ``CONVS`` under ``kind``."""
    CONVS[kind] += 1
    return F.conv1d(x, module.weight, module.bias, 1, module.padding, module.dilation)


def load_hifigan_state_dict(
        sd: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
    """A jik876/hifi-gan generator ``state_dict`` -> (this module's
    ``state_dict``, n_mels, the vocoder dict its shapes give).

    Takes weight-normed convs (``weight_g`` / ``weight_v`` pairs, folded as
    ``melgan._fold_weight_norm`` folds them) or plain ``weight``s. The
    initial channels come from ``conv_pre``, each rate from its up-conv's
    kernel (2r), the kernel sizes from the first stage's blocks; three
    ``convs1`` a block are ResBlock1's dilations 1, 3, 5. Raises
    ``ValueError`` on a layout it cannot read so."""

    def np_(t) -> np.ndarray:
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def weight(prefix: str) -> np.ndarray:
        if f"{prefix}.weight_v" in sd:
            return _fold_weight_norm(np_(sd[f"{prefix}.weight_g"]), np_(sd[f"{prefix}.weight_v"]))
        return np_(sd[f"{prefix}.weight"])

    convs = sorted({k.rsplit(".", 1)[0] for k in sd if k.endswith(("weight", "weight_v"))})
    out = {f"{c}.{leaf}": torch.from_numpy(np.array(v, np.float32, order="C"))
           for c in convs for leaf, v in (("weight", weight(c)), ("bias", np_(sd[f"{c}.bias"])))}
    pre = out["conv_pre.weight"]
    n_ups = sum(f"ups.{i}.weight" in out for i in range(len(out)))
    kernels = [out[f"ups.{i}.weight"].shape[2] for i in range(n_ups)]
    n_blocks = sum(f"resblocks.{j}.convs1.0.weight" in out for j in range(len(out)))
    if not n_ups or n_blocks % n_ups or any(k % 2 for k in kernels):
        raise ValueError(f"not a HiFi-GAN ResBlock1 generator: {n_ups} up-convs of kernels "
                         f"{kernels}, {n_blocks} ResBlock1s")
    per_stage = n_blocks // n_ups
    block_kernels = [out[f"resblocks.{j}.convs1.0.weight"].shape[2] for j in range(per_stage)]
    n_dil = sum(f"resblocks.0.convs1.{k}.weight" in out for k in range(len(out)))
    if n_dil != 3:
        raise ValueError(f"ResBlock1 has 3 dilated convs (1, 3, 5), this one {n_dil}")
    vocoder = {"resblock": "1", "upsample_rates": [k // 2 for k in kernels],
               "upsample_kernel_sizes": kernels, "upsample_initial_channel": pre.shape[0],
               "resblock_kernel_sizes": block_kernels,
               "resblock_dilation_sizes": [[1, 3, 5]] * per_stage}
    return out, pre.shape[1], vocoder

