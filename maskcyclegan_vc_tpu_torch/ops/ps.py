"""Pixel-shuffle(2) + InstanceNorm + swish, the generator's upsample epilogue.

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py``
(``subpixel_in_swish``, forward) and of the masked XLA form at the same
call sites (``models/generator.py:303-306, 319-322``). x is the upsample
conv's (B, 4C, H, W) output in ``torch.nn.PixelShuffle`` channel order
``c*4 + (2i+j)``; the result is swish(IN(pixel_shuffle(x))), (B, C, 2H, 2W),
with torch InstanceNorm numerics on the shuffled tensor. ``lengths`` counts
the valid frames of the *shuffled* time axis (2W wide), as ``tm_up1`` and
``tm_up2`` do in the JAX generator.

``pixel_shuffle_in_swish`` launches the CUDA kernel (``csrc/ps_in_swish.cu``)
for a tensor on the card and runs ``pixel_shuffle_in_swish_plain`` for a
tensor on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel
from maskcyclegan_vc_tpu_torch.ops.in_gate import check_args, instance_norm_plain
from maskcyclegan_vc_tpu_torch.ops.layers import swish

PS_IN_SWISH_KERNEL = CudaKernel("ps_in_swish", "ps_in_swish_forward",
                                [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])


def pixel_shuffle_in_swish_plain(x: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(IN(pixel_shuffle(x, 2))) in plain PyTorch."""
    return swish(instance_norm_plain(F.pixel_shuffle(x, 2), scale, bias, lengths))


def pixel_shuffle_in_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 4C, H, W) PixelShuffle-ordered -> (B, C, 2H, 2W)."""
    if x.ndim != 4 or x.shape[1] % 4:
        raise ValueError(f"expected (B, 4C, H, W), got {tuple(x.shape)}")
    B, C4, H, W = x.shape
    C = C4 // 4
    check_args(x, C, (scale, bias), lengths)
    if x.device.type == "cpu":
        return pixel_shuffle_in_swish_plain(x, scale, bias, lengths)
    y = torch.empty((B, C, 2 * H, 2 * W), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        PS_IN_SWISH_KERNEL(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                           None if lengths is None else lengths.data_ptr(),
                           y.data_ptr(), B, C, H, W,
                           torch.cuda.current_stream().cuda_stream)
    return y
