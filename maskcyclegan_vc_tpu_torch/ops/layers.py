"""Layers of the generator, NCHW, with the reference's parameter names.

Counterpart of ``maskcyclegan_vc_tpu/ops/layers.py``. Convolutions are
``nn.Conv2d``/``nn.Conv1d`` (cuDNN on the card) with torch's own symmetric
padding. InstanceNorm is affine with eps 1e-5, biased variance and f32
statistics; it, its swish form (the discriminator's epilogue) and the
true-GLU epilogue of a conv pair run the kernels of ``ops/in_gate.py``,
whose autograd Functions give them gradients. The JAX package's ways of lowering convs
through XLA (``tap_conv``, ``paired_conv``, ``conv1d_k3_matmul``) and its
weight permutations have no counterpart: in NCHW the torch layout is already
what the kernels read.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm,
    instance_norm_glu,
    instance_norm_swish,
)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the reference's self-gated "GLU"."""
    return x * torch.sigmoid(x)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over every axis after the channel (torch
    ``InstanceNorm{1,2}d(affine=True)`` numerics), optionally masked by
    per-sample valid lengths along the last (time) axis."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, lengths)


def init_conv_params(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default conv init, U(+-1/sqrt(fan_in)) for weights and biases,
    drawn from ``generator`` in module order; norms to scale 1, bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                          generator=generator))
            elif isinstance(m, InstanceNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def swish_instance_norm(x: torch.Tensor, norm: InstanceNorm,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(norm(x)) in one kernel: the discriminator's downsample epilogue."""
    return instance_norm_swish(x, norm.weight, norm.bias, lengths)


def gated_conv(x: torch.Tensor, conv_h: nn.Module, norm_h: InstanceNorm,
               conv_g: nn.Module, norm_g: InstanceNorm,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(conv_h(x)) * sigmoid(IN(conv_g(x))).

    The two convs read the same input, so they run as one conv with the
    kernels concatenated along the output channels; its (B, 2C, ...) output
    goes whole to the IN-GLU kernel, which reads h and g as channel halves.
    """
    conv = F.conv2d if conv_h.weight.ndim == 4 else F.conv1d
    hg = conv(x, torch.cat([conv_h.weight, conv_g.weight]),
              torch.cat([conv_h.bias, conv_g.bias]),
              conv_h.stride, conv_h.padding)
    return instance_norm_glu(hg, norm_h.weight, norm_h.bias,
                             norm_g.weight, norm_g.bias, lengths)


class GatedConv2d(nn.Module):
    """True-GLU downsample block (reference ``DownSampleGenerator``):
    ``convLayer`` = [conv, IN] and ``convLayer_gates`` = [conv, IN]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, padding):
        super().__init__()
        self.convLayer = nn.ModuleList([
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding),
            InstanceNorm(out_channels)])
        self.convLayer_gates = nn.ModuleList([
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding),
            InstanceNorm(out_channels)])

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gated_conv(x, self.convLayer[0], self.convLayer[1],
                          self.convLayer_gates[0], self.convLayer_gates[1],
                          lengths)
