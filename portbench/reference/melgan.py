"""The melgan-neurips generator in plain PyTorch.

As descriptinc/melgan-neurips ``mel2wav/modules.py`` writes ``Generator``
(at its defaults ngf 32, ratios 8, 8, 2, 2, and ``n_residual_layers`` 3:
``ResnetBlock``s of dilation 1, 3, 9 a stage), built from a configuration's
``vocoder`` group, with its weight norm folded into plain weights and its
``nn.Sequential`` given names: ``conv_in``, ``ups.i``, ``stages.i.j``
(``conv1`` the dilated conv3, ``conv2`` the conv1, ``shortcut``) and
``conv_out``. Every convolution goes through ``conv``, which rounds its
operands where a control asks for it (``precision.operands``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import q

class ResnetBlock(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.conv1 = nn.Conv1d(channels, channels, 3, dilation=dilation)
        self.conv2 = nn.Conv1d(channels, channels, 1)
        self.shortcut = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        h = F.pad(F.leaky_relu(x, 0.2), (self.dilation, self.dilation), mode="reflect")
        h = conv(self.conv2, F.leaky_relu(conv(self.conv1, h), 0.2))
        return conv(self.shortcut, x) + h


class MelGAN(nn.Module):
    def __init__(self, n_mels: int, vocoder: dict):
        """``vocoder``: a configuration's group (``ngf``, ``ratios``,
        ``n_residual_layers``)."""
        super().__init__()
        ngf, ratios = vocoder["ngf"], vocoder["ratios"]
        mult = 2 ** len(ratios)
        self.conv_in = nn.Conv1d(n_mels, mult * ngf, 7)
        self.ups = nn.ModuleList()
        self.stages = nn.ModuleList()
        for r in ratios:
            self.ups.append(nn.ConvTranspose1d(mult * ngf, mult * ngf // 2, 2 * r, stride=r,
                                               padding=r // 2 + r % 2, output_padding=r % 2))
            self.stages.append(nn.ModuleList(ResnetBlock(mult * ngf // 2, 3 ** j)
                                             for j in range(vocoder["n_residual_layers"])))
            mult //= 2
        self.conv_out = nn.Conv1d(ngf, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) log10-mel -> (B, T x the product of the ratios)
        waveform."""
        x = conv(self.conv_in, F.pad(mel, (3, 3), mode="reflect"))
        for up, stage in zip(self.ups, self.stages):
            x = conv(up, F.leaky_relu(x, 0.2))
            for block in stage:
                x = block(x)
        x = conv(self.conv_out, F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect"))
        return torch.tanh(x)[:, 0]


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(m, nn.ConvTranspose1d):
        return F.conv_transpose1d(q(x), q(m.weight), m.bias, m.stride, m.padding,
                                  m.output_padding)
    return F.conv1d(q(x), q(m.weight), m.bias, m.stride, m.padding, m.dilation)
