"""MaskCycleGAN-VC generator, NCHW, for PyTorch on an NVIDIA GPU.

Counterpart of ``maskcyclegan_vc_tpu/models/generator.py``, with the
reference's module names, so ``load_state_dict(strict=True)`` takes a
reference state_dict or ``io.jax_params.generator_params_from_jax`` of a
JAX checkpoint. Shape trace (B batch, M=80 mels, T frames, R=256):

    x, mask: (B, M, T)
    stack([x*mask, mask])                          -> (B, 2, M, T)
    conv1 / conv1_gates (5,15) p(2,7), GLU         -> (B, R/2, M, T)
    downSample1, downSample2: k5 s2 p2 + IN-GLU    -> (B, R, M/4, T/4)
    view(B, R*M/4, T/4), conv2dto1dLayer k1 + IN   -> (B, R, T/4)
    6 residual blocks: k3 -> 2R + IN-GLU, k3 -> R + IN, add
    conv1dto2dLayer k1 + IN, view(B, R, M/4, T/4)
    upSample1: conv k5 -> 4R, pixel-shuffle + IN + swish -> (B, R, M/2, T/2)
    upSample2: conv k5 -> 2R, pixel-shuffle + IN + swish -> (B, R/2, M, T)
    lastConvLayer (5,15) p(2,7) -> 1, squeeze      -> (B, M, T)

Every norm runs one of the port's kernels: IN-GLU 2 + num_residual_blocks
times, IN 2 + num_residual_blocks times, pixel-shuffle + IN + swish twice
(their plain versions with ``fused_norms=False``). ``dtype`` (None: f32) is
the compute dtype, as in the JAX generator: the stacked input is cast to it
(JAX ``generator.py:192-194``), every conv and norm runs in it, and the
output leaves in f32 (``:328``). Parameters stay f32.
With ``lengths`` (bucketed conversion) each takes the valid length of its
stage, as the JAX generator's per-stage time masks do. Without (training),
they run through the kernels' autograd Functions wherever gradients are on.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from maskcyclegan_vc_tpu_torch.ops.in_gate import time_mask, widened
from maskcyclegan_vc_tpu_torch.ops.layers import (
    GatedConv2d,
    InstanceNorm,
    conv,
    conv_with,
    gated_conv,
    init_conv_params,
    norm_fn,
)
from maskcyclegan_vc_tpu_torch.ops.ps import (
    pixel_shuffle_in_swish,
    pixel_shuffle_in_swish_plain,
)


def strided_len(length: torch.Tensor, kernel: int = 5, stride: int = 2,
                padding: int = 2) -> torch.Tensor:
    """Output length of a torch-style strided conv: floor((L+2p-k)/s)+1."""
    return (length + 2 * padding - kernel) // stride + 1


class ResidualBlock(nn.Module):
    """1D residual GLU block (reference ``ResidualLayer``)."""

    def __init__(self, channels: int, hidden: int, fused: bool = True):
        super().__init__()
        self.conv1d_layer = nn.ModuleList([
            nn.Conv1d(channels, hidden, 3, 1, 1), InstanceNorm(hidden, fused)])
        self.conv_layer_gates = nn.ModuleList([
            nn.Conv1d(channels, hidden, 3, 1, 1), InstanceNorm(hidden, fused)])
        self.conv1d_out_layer = nn.ModuleList([
            nn.Conv1d(hidden, channels, 3, 1, 1), InstanceNorm(channels, fused)])

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        hg = gated_conv(x, self.conv1d_layer[0], self.conv1d_layer[1],
                        self.conv_layer_gates[0], self.conv_layer_gates[1],
                        lengths)
        out, norm = self.conv1d_out_layer
        return x + norm(conv(out, hg), lengths)


class Generator(nn.Module):
    """Mask-guided CycleGAN-VC generator. 24,537,729 parameters at defaults.

    Parameters are made on ``device`` and drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) with torch's default conv init,
    U(+-1/sqrt(fan_in)) for weights and biases, and 1 / 0 for the norms.
    """

    def __init__(self, n_mels: int = 80, residual_channels: int = 256,
                 num_residual_blocks: int = 6, *, device="cpu",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_norms: bool = True):
        super().__init__()
        if n_mels % 4:
            raise ValueError(f"n_mels must be divisible by 4, got {n_mels}")
        self.n_mels = n_mels
        self.dtype = dtype
        f = fused_norms
        R = residual_channels
        flat = (n_mels // 4) * R
        with torch.device("meta"):
            self.conv1 = nn.Conv2d(2, R // 2, (5, 15), 1, (2, 7))
            self.conv1_gates = nn.Conv2d(2, R // 2, (5, 15), 1, (2, 7))
            self.downSample1 = GatedConv2d(R // 2, R, 5, 2, 2, f)
            self.downSample2 = GatedConv2d(R, R, 5, 2, 2, f)
            self.conv2dto1dLayer = nn.Conv1d(flat, R, 1)
            self.conv2dto1dLayer_tfan = InstanceNorm(R, f)
            for i in range(1, num_residual_blocks + 1):
                setattr(self, f"residualLayer{i}", ResidualBlock(R, 2 * R, f))
            self.num_residual_blocks = num_residual_blocks
            self.conv1dto2dLayer = nn.Conv1d(R, flat, 1)
            self.conv1dto2dLayer_tfan = InstanceNorm(flat, f)
            # Index 1 is the reference's PixelShuffle, which the fused
            # kernel performs; it holds no parameters.
            self.upSample1 = nn.ModuleList([nn.Conv2d(R, 4 * R, 5, 1, 2),
                                            nn.PixelShuffle(2), InstanceNorm(R, f)])
            self.upSample2 = nn.ModuleList([nn.Conv2d(R, 2 * R, 5, 1, 2),
                                            nn.PixelShuffle(2), InstanceNorm(R // 2, f)])
            self.lastConvLayer = nn.Conv2d(R // 2, 1, (5, 15), 1, (2, 7))
        self.to_empty(device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_conv_params(self, generator or torch.Generator().manual_seed(0))

    def with_dtype(self, dtype: Optional[torch.dtype]) -> "Generator":
        """This generator computing in ``dtype``: a shallow copy that shares
        every parameter and submodule, as a JAX module rebuilt with another
        dtype applies the same params (the JAX trainer converts in f32
        whatever it trains in, ``train/trainer.py:232-241``)."""
        view = copy.copy(self)
        view.dtype = dtype
        return view

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, M, T) normalized mels and FIF mask (1 = keep) -> (B, M, T).

        ``lengths``, (B,) valid frame counts, turns on bucketed conversion:
        every InstanceNorm takes statistics over the valid frames of its
        stage only and the padded frames are zeroed, so the output equals
        the unpadded forward's. T must then be divisible by 4.
        """
        B, M, T = x.shape
        if M != self.n_mels:
            raise ValueError(f"expected {self.n_mels} mel bins, got {M}")
        l1 = l2 = lu1 = lu2 = valid = None
        if lengths is not None:
            if T % 4:
                raise ValueError(f"bucketed conversion needs T % 4 == 0, got T={T}")
            lengths = lengths.to(device=x.device, dtype=torch.int32)
            l1 = strided_len(lengths)
            l2 = strided_len(l1)
            # After each pixel shuffle the valid content spans 2*l2, 4*l2.
            lu1 = torch.clamp(2 * l2, max=T // 2)
            lu2 = torch.clamp(4 * l2, max=T)
            # Zero the bucket's tail in both input channels, so it matches
            # the convs' zero padding of an unpadded input.
            valid = time_mask(lengths, T)[:, None, :].to(x.dtype)  # (B, 1, T)
            x, mask = x * valid, mask * valid

        cdt = self.dtype or x.dtype
        h = torch.stack([x * mask, mask], dim=1).to(cdt)  # (B, 2, M, T)
        ag = conv_with(self.conv1, h, torch.cat([self.conv1.weight, self.conv1_gates.weight]),
                       torch.cat([self.conv1.bias, self.conv1_gates.bias]))
        a, g = ag.chunk(2, dim=1)
        h = a * torch.sigmoid(g)
        if valid is not None:
            h = h * valid[:, :, None, :].to(cdt)

        h = self.downSample1(h, l1)
        h = self.downSample2(h, l2)

        _, R, H2, W2 = h.shape
        h = self.conv2dto1dLayer_tfan(conv(self.conv2dto1dLayer, h.reshape(B, R * H2, W2)), l2)
        for i in range(1, self.num_residual_blocks + 1):
            h = getattr(self, f"residualLayer{i}")(h, l2)
        h = self.conv1dto2dLayer_tfan(conv(self.conv1dto2dLayer, h), l2)
        h = h.view(B, R, H2, W2)

        for (up, _, norm), lu in ((self.upSample1, lu1), (self.upSample2, lu2)):
            fn = norm_fn(norm, pixel_shuffle_in_swish, pixel_shuffle_in_swish_plain)
            h = fn(conv(up, h), norm.weight, norm.bias, lu)

        out = widened(conv(self.lastConvLayer, h)[:, 0])
        if valid is not None:
            out = out * valid
        return out
