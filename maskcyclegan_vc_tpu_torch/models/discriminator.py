"""MaskCycleGAN-VC PatchGAN discriminator, NCHW, for PyTorch on an NVIDIA GPU.

Counterpart of ``maskcyclegan_vc_tpu/models/discriminator.py``, with the
reference's module names, so ``load_state_dict(strict=True)`` takes a
reference state_dict or ``io.jax_params.discriminator_params_from_jax`` of
a JAX checkpoint. Shape trace (B batch, M=80 mels, T frames, R=256):

    x: (B, M, T) -> (B, 1, M, T)
    convLayer1: conv 3x3 p1 -> R/2, swish               -> (B, R/2, M, T)
    downSample1: conv 3x3 s2 p1 -> R, IN + swish        -> (B, R, M/2, T/2)
    downSample2: conv 3x3 s2 p1 -> 2R, IN + swish       -> (B, 2R, M/4, T/4)
    downSample3: conv 3x3 s2 p1 -> 4R, IN + swish       -> (B, 4R, M/8, T/8)
    outputConvLayer: conv (1,3) p(0,1) -> 1, sigmoid    -> (B, M/8, T/8)

Each IN + swish is one launch of the port's swish-InstanceNorm kernel. The
reference also declares a ``downSample4`` block (conv (1,10) 4R -> 4R and
an affine IN, 10,488,832 parameters) that its forward never calls; it is
declared here too (``include_dead_params``), so checkpoints of either
package and the reference round-trip, and it is never called or trained.
LSGAN is computed on the sigmoid's probabilities, as in the reference.

``dtype`` (None: f32) is the compute dtype, as in the JAX discriminator:
the input is cast to it (JAX ``discriminator.py:96``), every conv and norm
runs in it, and the sigmoid is taken in f32 (``:145``). ``fused_norms=False``
runs the norms' plain versions in place of the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maskcyclegan_vc_tpu_torch.ops.in_gate import time_mask, widened
from maskcyclegan_vc_tpu_torch.ops.layers import (
    InstanceNorm,
    conv,
    init_conv_params,
    swish,
    swish_instance_norm,
)

# The dead block: declared, never called, never trained.
DEAD_PREFIX = "downSample4."


def halved_len(length: torch.Tensor) -> torch.Tensor:
    """Valid length after a k3 s2 p1 conv: ceil(L / 2)."""
    return (length + 1) // 2


class Discriminator(nn.Module):
    """PatchGAN over (B, M, T) mels -> (B, M/8, ceil(T/8)) probabilities.

    16,691,713 parameters at the defaults with the dead block, 6,202,881
    live. Parameters are made on ``device`` and drawn from ``generator`` (a
    CPU ``torch.Generator``; seed 0 when None).
    """

    def __init__(self, residual_channels: int = 256, include_dead_params: bool = True,
                 *, device="cpu", generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, fused_norms: bool = True):
        super().__init__()
        R = residual_channels
        self.dtype = dtype
        with torch.device("meta"):
            self.convLayer1 = nn.ModuleList([nn.Conv2d(1, R // 2, 3, 1, 1)])
            self.downSample1 = nn.ModuleList([nn.Conv2d(R // 2, R, 3, 2, 1),
                                              InstanceNorm(R, fused_norms)])
            self.downSample2 = nn.ModuleList([nn.Conv2d(R, 2 * R, 3, 2, 1),
                                              InstanceNorm(2 * R, fused_norms)])
            self.downSample3 = nn.ModuleList([nn.Conv2d(2 * R, 4 * R, 3, 2, 1),
                                              InstanceNorm(4 * R, fused_norms)])
            if include_dead_params:
                self.downSample4 = nn.ModuleList([
                    nn.Conv2d(4 * R, 4 * R, (1, 10), 1, (0, 2)),
                    InstanceNorm(4 * R, fused_norms)])
            self.outputConvLayer = nn.ModuleList([nn.Conv2d(4 * R, 1, (1, 3), 1, (0, 1))])
        self.to_empty(device=device)
        init_conv_params(self, generator or torch.Generator().manual_seed(0))

    def live_parameters(self):
        """Every parameter the forward uses: all but the dead block's."""
        return [p for n, p in self.named_parameters() if not n.startswith(DEAD_PREFIX)]

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, M, T) -> (B, M/8, ceil(T/8)) patch probabilities.

        ``lengths``, (B,) valid frame counts, evaluates padded inputs: the
        norms take statistics over each stage's valid frames only, padded
        activations are zero at every stage, and invalid output patches are
        zero, so the valid patches equal the unpadded forward's.
        """
        h = x[:, None].to(self.dtype or x.dtype)  # (B, 1, M, T)
        valid = None
        if lengths is not None:
            lengths = lengths.to(device=x.device, dtype=torch.int32)
            valid = time_mask(lengths, x.shape[-1])[:, None, None, :].to(h.dtype)
            h = h * valid
        h = swish(conv(self.convLayer1[0], h))
        if valid is not None:
            h = h * valid
        for block in (self.downSample1, self.downSample2, self.downSample3):
            if lengths is not None:
                lengths = halved_len(lengths)
            h = swish_instance_norm(conv(block[0], h), block[1], lengths)
        out = torch.sigmoid(widened(conv(self.outputConvLayer[0], h)))[:, 0]
        if lengths is not None:
            out = out * time_mask(lengths, out.shape[-1])[:, None, :]
        return out
