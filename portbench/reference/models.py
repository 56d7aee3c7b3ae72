"""MaskCycleGAN-VC's generator and PatchGAN discriminator in plain PyTorch.

As GANtastic3/MaskCycleGAN-VC's ``mask_cyclegan_vc/model.py`` writes them,
with the same module names: ``nn.InstanceNorm{1,2}d(affine=True)`` after
each convolution, the gated (true GLU) downsamples, six residual blocks,
``nn.PixelShuffle(2)`` in the upsamples, and the self-gated "GLU"
x * sigmoid(x). Every convolution goes through ``conv``, which rounds its
operands where a control asks for it (``precision.operands``).

The generator takes any number of frames: the output of an input of T
frames is 4 * ceil(ceil(T / 2) / 2) wide, and a conversion keeps its first
T frames. The discriminator declares the published ``downSample4`` block,
which its forward never calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import q, q_grad


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    fn = F.conv2d if isinstance(m, nn.Conv2d) else F.conv1d
    return q_grad(fn(q(x), q(m.weight), m.bias, m.stride, m.padding))


def glu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``GLU`` module: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def norm_conv(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Conv then InstanceNorm: a ``Sequential(conv, norm)`` of the reference."""
    return seq[1](conv(seq[0], x))


class ResidualLayer(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.conv1d_layer = nn.Sequential(nn.Conv1d(channels, hidden, 3, 1, 1),
                                          nn.InstanceNorm1d(hidden, affine=True))
        self.conv_layer_gates = nn.Sequential(nn.Conv1d(channels, hidden, 3, 1, 1),
                                              nn.InstanceNorm1d(hidden, affine=True))
        self.conv1d_out_layer = nn.Sequential(nn.Conv1d(hidden, channels, 3, 1, 1),
                                              nn.InstanceNorm1d(channels, affine=True))

    def forward(self, x):
        h = norm_conv(self.conv1d_layer, x) * torch.sigmoid(norm_conv(self.conv_layer_gates, x))
        return x + norm_conv(self.conv1d_out_layer, h)


class DownSampleGenerator(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convLayer = nn.Sequential(nn.Conv2d(cin, cout, 5, 2, 2),
                                       nn.InstanceNorm2d(cout, affine=True))
        self.convLayer_gates = nn.Sequential(nn.Conv2d(cin, cout, 5, 2, 2),
                                             nn.InstanceNorm2d(cout, affine=True))

    def forward(self, x):
        return norm_conv(self.convLayer, x) * torch.sigmoid(norm_conv(self.convLayer_gates, x))


class Generator(nn.Module):
    def __init__(self, n_mels: int = 80, residual_channels: int = 256,
                 num_residual_blocks: int = 6):
        super().__init__()
        R = residual_channels
        self.R, self.n_mels = R, n_mels
        self.flat = n_mels // 4 * R
        self.conv1 = nn.Conv2d(2, R // 2, (5, 15), 1, (2, 7))
        self.conv1_gates = nn.Conv2d(2, R // 2, (5, 15), 1, (2, 7))
        self.downSample1 = DownSampleGenerator(R // 2, R)
        self.downSample2 = DownSampleGenerator(R, R)
        self.conv2dto1dLayer = nn.Conv1d(self.flat, R, 1)
        self.conv2dto1dLayer_tfan = nn.InstanceNorm1d(R, affine=True)
        self.blocks = num_residual_blocks
        for i in range(1, num_residual_blocks + 1):
            setattr(self, f"residualLayer{i}", ResidualLayer(R, 2 * R))
        self.conv1dto2dLayer = nn.Conv1d(R, self.flat, 1)
        self.conv1dto2dLayer_tfan = nn.InstanceNorm1d(self.flat, affine=True)
        self.upSample1 = nn.Sequential(nn.Conv2d(R, 4 * R, 5, 1, 2), nn.PixelShuffle(2),
                                       nn.InstanceNorm2d(R, affine=True))
        self.upSample2 = nn.Sequential(nn.Conv2d(R, 2 * R, 5, 1, 2), nn.PixelShuffle(2),
                                       nn.InstanceNorm2d(R // 2, affine=True))
        self.lastConvLayer = nn.Conv2d(R // 2, 1, (5, 15), 1, (2, 7))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, M, T) mels and mask -> (B, M, 4 * ceil(ceil(T / 2) / 2))."""
        h = torch.stack((x * mask, mask), dim=1)
        h = conv(self.conv1, h) * torch.sigmoid(conv(self.conv1_gates, h))
        h = self.downSample2(self.downSample1(h))
        B = h.shape[0]
        h = self.conv2dto1dLayer_tfan(conv(self.conv2dto1dLayer, h.reshape(B, self.flat, -1)))
        for i in range(1, self.blocks + 1):
            h = getattr(self, f"residualLayer{i}")(h)
        h = self.conv1dto2dLayer_tfan(conv(self.conv1dto2dLayer, h))
        h = h.view(B, self.R, self.n_mels // 4, -1)
        for up in (self.upSample1, self.upSample2):
            h = glu(up[2](up[1](conv(up[0], h))))
        return conv(self.lastConvLayer, h)[:, 0]


class Discriminator(nn.Module):
    def __init__(self, residual_channels: int = 256):
        super().__init__()
        R = residual_channels

        def down(cin, cout, k, s, p):
            return nn.Sequential(nn.Conv2d(cin, cout, k, s, p),
                                 nn.InstanceNorm2d(cout, affine=True))

        self.convLayer1 = nn.Sequential(nn.Conv2d(1, R // 2, 3, 1, 1))
        self.downSample1 = down(R // 2, R, 3, 2, 1)
        self.downSample2 = down(R, 2 * R, 3, 2, 1)
        self.downSample3 = down(2 * R, 4 * R, 3, 2, 1)
        self.downSample4 = down(4 * R, 4 * R, (1, 10), 1, (0, 2))  # never called
        self.outputConvLayer = nn.Sequential(nn.Conv2d(4 * R, 1, (1, 3), 1, (0, 1)))

    def live_parameters(self):
        return [p for n, p in self.named_parameters() if not n.startswith("downSample4.")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = glu(conv(self.convLayer1[0], x[:, None]))
        for block in (self.downSample1, self.downSample2, self.downSample3):
            h = glu(norm_conv(block, h))
        return torch.sigmoid(conv(self.outputConvLayer[0], h))
