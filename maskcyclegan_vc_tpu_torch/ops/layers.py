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

Compute dtype: each conv runs in its input's dtype, its f32 weight and bias
cast to it, as ``flax_dtypes.promote_dtype`` casts them in JAX
(``layers.py:113-116, 313``); the models cast their input once, to their
``dtype``. Parameters stay f32. Each norm runs the port's kernel (``fused``,
the default) or, with ``fused=False``, its plain PyTorch version, which
autograd differentiates: the JAX package's ``fused_norms=False`` XLA path.
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
    instance_norm_glu_plain,
    instance_norm_plain,
    instance_norm_swish,
    instance_norm_swish_plain,
)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the reference's self-gated "GLU"."""
    return x * torch.sigmoid(x)


def conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s convolution (an ``nn.Conv1d`` or ``nn.Conv2d`` with zero
    padding) in x's dtype."""
    fn = F.conv2d if module.weight.ndim == 4 else F.conv1d
    return fn(x, module.weight.to(x.dtype), module.bias.to(x.dtype), module.stride,
              module.padding, module.dilation, module.groups)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over every axis after the channel (torch
    ``InstanceNorm{1,2}d(affine=True)`` numerics), optionally masked by
    per-sample valid lengths along the last (time) axis. ``fused`` chooses
    the kernel, else the plain version."""

    def __init__(self, num_features: int, fused: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.fused = fused

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return norm_fn(self, instance_norm, instance_norm_plain)(
            x, self.weight, self.bias, lengths)


def norm_fn(norm: InstanceNorm, kernel, plain):
    """``kernel``, the port's kernel of ``norm``'s epilogue, or its
    ``plain`` version where ``norm`` was built with ``fused=False``."""
    return kernel if norm.fused else plain


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
    fn = norm_fn(norm, instance_norm_swish, instance_norm_swish_plain)
    return fn(x, norm.weight, norm.bias, lengths)


def gated_conv(x: torch.Tensor, conv_h: nn.Module, norm_h: InstanceNorm,
               conv_g: nn.Module, norm_g: InstanceNorm,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(conv_h(x)) * sigmoid(IN(conv_g(x))).

    The two convs read the same input, so they run as one conv with the
    kernels concatenated along the output channels; its (B, 2C, ...) output
    goes whole to the IN-GLU kernel, which reads h and g as channel halves.
    """
    fn = F.conv2d if conv_h.weight.ndim == 4 else F.conv1d
    hg = fn(x, torch.cat([conv_h.weight, conv_g.weight]).to(x.dtype),
            torch.cat([conv_h.bias, conv_g.bias]).to(x.dtype),
            conv_h.stride, conv_h.padding)
    glu = norm_fn(norm_h, instance_norm_glu, instance_norm_glu_plain)
    return glu(hg, norm_h.weight, norm_h.bias, norm_g.weight, norm_g.bias, lengths)


class GatedConv2d(nn.Module):
    """True-GLU downsample block (reference ``DownSampleGenerator``):
    ``convLayer`` = [conv, IN] and ``convLayer_gates`` = [conv, IN]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, padding, fused: bool = True):
        super().__init__()
        self.convLayer = nn.ModuleList([
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding),
            InstanceNorm(out_channels, fused)])
        self.convLayer_gates = nn.ModuleList([
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding),
            InstanceNorm(out_channels, fused)])

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gated_conv(x, self.convLayer[0], self.convLayer[1],
                          self.convLayer_gates[0], self.convLayer_gates[1],
                          lengths)
