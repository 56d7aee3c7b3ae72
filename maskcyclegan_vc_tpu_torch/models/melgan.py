"""The MelGAN vocoder (melgan-neurips generator) for PyTorch on an NVIDIA GPU.

Counterpart of ``maskcyclegan_vc_tpu/models/melgan.py``: the pretrained
``descriptinc/melgan-neurips`` generator the reference decodes with, at its
defaults (80 mels, ngf 32, ratios 8, 8, 2, 2, three ResnetBlocks of
dilations 1, 3, 9 a stage; 256x upsampling, the mel hop):

    reflect_pad(3) -> conv7 80 -> 512                         (cuDNN)
    for r in (8, 8, 2, 2):
        lrelu -> ConvTranspose1d(k=2r, s=r, p=r//2 + r%2, op=r%2)  (cuDNN)
        3 ResnetBlocks                                     (K9, one call)
    lrelu -> reflect_pad(3) -> conv7 ngf -> 1 -> tanh     (K9's tail)

Layout (B, C, W), PyTorch's. Each stage's blocks run through
``ops.melgan_stack.melgan_resstack``: the kernel on the card, the plain
chain on the CPU. The stages but the last emit their output pre-activated,
and the last carries the tail, as the JAX package's fused path does, so a
decode is four K9 calls, a mel of 1-3 frames too (its first stage, as
narrow as W = 8, reflects its pads again, as ``jnp.pad`` does). Inference
only.

``dtype`` (None, f32, or ``torch.bfloat16``) is the compute dtype, as in
the JAX module (``models/melgan.py:88-103, 130-150``): the mel is cast to
it at entry, every conv and K9 stage takes its f32 parameters cast to it at
each call, and the waveform comes out in it. The parameters stay f32.

``load_melgan_state_dict`` maps a melgan-neurips ``state_dict`` (one
``nn.Sequential`` named ``model``, weight-normed convs as ``weight_g`` /
``weight_v`` pairs or plain ``weight``) onto this module's names, folding
the weight norm as the JAX package's ``melgan_params_from_torch`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.ops.melgan_stack import (
    DILATIONS,
    LRELU_SLOPE,
    melgan_resstack,
    reflect_pad,
)

RATIOS = (8, 8, 2, 2)
HOP = 256  # samples per mel frame: the product of RATIOS


class ResnetBlock(nn.Module):
    """lrelu -> reflect pad d -> conv3 dilated d -> lrelu -> conv1, plus a
    conv1 shortcut; computed by K9 with its stage's other blocks."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, channels, 3, dilation=dilation)
        self.conv2 = nn.Conv1d(channels, channels, 1)
        self.shortcut = nn.Conv1d(channels, channels, 1)


class MelGANGenerator(nn.Module):
    """melgan-neurips generator; 4,260,257 parameters at the defaults.

    Weights are made on ``device`` and drawn from ``generator`` (a CPU
    ``torch.Generator``, seed 0 when None) as melgan-neurips initializes
    them: N(0, 0.02) for conv weights, zero biases.
    """

    def __init__(self, n_mels: int = 80, ngf: int = 32, *, device="cpu",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        mult = 2 ** len(RATIOS)
        with torch.device("meta"):
            self.conv_in = nn.Conv1d(n_mels, mult * ngf, 7)
            self.ups = nn.ModuleList()
            self.stages = nn.ModuleList()
            for r in RATIOS:
                out_ch = mult * ngf // 2
                self.ups.append(nn.ConvTranspose1d(
                    mult * ngf, out_ch, 2 * r, stride=r, padding=r // 2 + r % 2,
                    output_padding=r % 2))
                self.stages.append(nn.ModuleList(
                    ResnetBlock(out_ch, d) for d in DILATIONS))
                mult //= 2
            self.conv_out = nn.Conv1d(ngf, 1, 7)
        self.to_empty(device=device)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=gen))
                else:
                    p.zero_()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) log10-mel -> (B, T * 256) waveform in [-1, 1], in
        the compute dtype (f32 by default)."""
        dt = self.dtype or torch.float32
        x = leaky_relu_in(conv(self.conv_in, reflect_pad(mel.to(dt), 3)))
        for up, stage in zip(self.ups[:-1], self.stages[:-1]):
            # emitted pre-activated: the stage output only feeds lrelu -> up-conv
            x = melgan_resstack(conv(up, x), _block_params(stage, dt), emit_lrelu=True)
        return melgan_resstack(conv(self.ups[-1], x), _block_params(self.stages[-1], dt),
                               tail=(self.conv_out.weight.to(dt), self.conv_out.bias.to(dt)))


def conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s convolution (``nn.Conv1d`` unpadded, or
    ``nn.ConvTranspose1d``) in x's dtype, its bias added to the conv's
    output in that dtype, as the JAX module adds it (``y + bias``: two
    roundings in bf16)."""
    w = module.weight.to(x.dtype)
    if isinstance(module, nn.ConvTranspose1d):
        y = F.conv_transpose1d(x, w, None, module.stride, module.padding,
                               module.output_padding)
    else:
        y = F.conv1d(x, w)
    return y + module.bias.to(x.dtype)[:, None]


def leaky_relu_in(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu`` in x's dtype: its slope is a constant of that
    dtype, 0.2001953125 in bf16."""
    return F.leaky_relu(x, torch.tensor(LRELU_SLOPE, dtype=x.dtype).item())


def _block_params(stage: nn.ModuleList, dtype: torch.dtype):
    return [{k: p.to(dtype) for k, p in block.named_parameters()} for block in stage]


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weight_norm(dim=0): w[o] = g[o] * v[o] / ||v[o]||, the norm over
    every axis after the first (numpy, as the JAX package folds it)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return (g / norm) * v


def load_melgan_state_dict(sd: Mapping[str, Any],
                           n_residual_layers: int = 3) -> Dict[str, torch.Tensor]:
    """A melgan-neurips generator ``state_dict`` -> this module's.

    The reference module is one ``nn.Sequential`` named ``model``: index 1
    is conv_in; each upsampling stage is a LeakyReLU, the transposed conv
    and ``n_residual_layers`` ResnetBlocks (``block.2`` the dilated conv3,
    ``block.4`` the conv1, ``shortcut``); then LeakyReLU, ReflectionPad,
    conv_out and Tanh. Takes raw (weight_g, weight_v) pairs or folded
    weights.
    """

    def np_(t) -> np.ndarray:
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def weight(prefix: str) -> np.ndarray:
        if f"{prefix}.weight_v" in sd:
            return _fold_weight_norm(np_(sd[f"{prefix}.weight_g"]),
                                     np_(sd[f"{prefix}.weight_v"]))
        return np_(sd[f"{prefix}.weight"])

    out: Dict[str, torch.Tensor] = {}

    def put(name: str, prefix: str) -> None:
        for leaf, value in (("weight", weight(prefix)), ("bias", np_(sd[f"{prefix}.bias"]))):
            out[f"{name}.{leaf}"] = torch.from_numpy(np.array(value, np.float32, order="C"))

    put("conv_in", "model.1")
    idx = 2
    for i in range(len(RATIOS)):
        idx += 1  # LeakyReLU
        put(f"ups.{i}", f"model.{idx}")
        idx += 1
        for j in range(n_residual_layers):
            base = f"model.{idx}"
            put(f"stages.{i}.{j}.conv1", f"{base}.block.2")
            put(f"stages.{i}.{j}.conv2", f"{base}.block.4")
            put(f"stages.{i}.{j}.shortcut", f"{base}.shortcut")
            idx += 1
    idx += 2  # LeakyReLU, ReflectionPad
    put("conv_out", f"model.{idx}")
    return out


@torch.inference_mode()
def decode_mel(vocoder: nn.Module, mel: torch.Tensor, mean, std) -> torch.Tensor:
    """Denormalize (mel * std + mean, the reference's decode) and vocode:
    (B, M, T) -> (B, T * 256), with a ``MelGANGenerator`` or any vocoder that
    takes log10 mels (``hifigan.HiFiGANGenerator``). A ``decode`` span
    holding ``decode.h2d`` (the mel, mean and std to the device) and
    ``decode.vocoder``."""
    dev = next(vocoder.parameters()).device
    with profiler.span("decode"):
        with profiler.span("decode.h2d"):
            mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
            mean = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
            std = torch.as_tensor(np.asarray(std, np.float32), device=dev)
        with profiler.span("decode.vocoder"):
            return vocoder(mel * std + mean)
