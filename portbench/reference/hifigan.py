"""The HiFi-GAN generator in plain PyTorch.

As jik876/hifi-gan ``models.py`` writes ``Generator`` and ``ResBlock1``
(Kong, Kim and Bae, arXiv:2010.05646), built from a configuration's
``hifigan`` group in the keys of the published ``config_v1.json``
(``upsample_rates``, ``upsample_kernel_sizes``, ``upsample_initial_channel``,
``resblock_kernel_sizes``, ``resblock_dilation_sizes``), with its weight
norm folded into plain weights and the published parameter names
(``conv_pre``, ``ups.i``, ``resblocks.k.convs1.j``, ``convs2.j``,
``conv_post``). The input is a natural-log mel, as published. Every
convolution goes through ``conv``, which rounds its operands where a
control asks for it (``precision.operands``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import q

LRELU_SLOPE = 0.1


def get_padding(kernel: int, dilation: int) -> int:
    return int((kernel * dilation - dilation) / 2)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, 1, dilation=d, padding=get_padding(kernel, d))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel, 1, dilation=1, padding=get_padding(kernel, 1))
            for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = conv(c1, xt)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = conv(c2, xt)
            x = xt + x
        return x


class HiFiGAN(nn.Module):
    def __init__(self, n_mels: int, hifigan: dict):
        super().__init__()
        self.num_kernels = len(hifigan["resblock_kernel_sizes"])
        self.num_upsamples = len(hifigan["upsample_rates"])
        ch = hifigan["upsample_initial_channel"]
        self.conv_pre = nn.Conv1d(n_mels, ch, 7, 1, padding=3)
        self.ups = nn.ModuleList()
        for i, (u, k) in enumerate(zip(hifigan["upsample_rates"],
                                       hifigan["upsample_kernel_sizes"])):
            self.ups.append(nn.ConvTranspose1d(ch // (2 ** i), ch // (2 ** (i + 1)), k, u,
                                               padding=(k - u) // 2))
        self.resblocks = nn.ModuleList()
        for i in range(len(self.ups)):
            c = ch // (2 ** (i + 1))
            for k, d in zip(hifigan["resblock_kernel_sizes"], hifigan["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(c, k, d))
        self.conv_post = nn.Conv1d(c, 1, 7, 1, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) natural-log mel -> (B, T x the product of the
        rates) waveform."""
        x = conv(self.conv_pre, mel)
        for i in range(self.num_upsamples):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = conv(self.ups[i], x)
            xs = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = F.leaky_relu(x)  # PyTorch's default slope, 0.01, as the published forward
        x = conv(self.conv_post, x)
        return torch.tanh(x)[:, 0]


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(m, nn.ConvTranspose1d):
        return F.conv_transpose1d(q(x), q(m.weight), m.bias, m.stride, m.padding,
                                  m.output_padding)
    return F.conv1d(q(x), q(m.weight), m.bias, m.stride, m.padding, m.dilation)
