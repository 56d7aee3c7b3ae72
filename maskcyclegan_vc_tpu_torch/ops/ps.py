"""Pixel-shuffle(2) + InstanceNorm + swish, the generator's upsample epilogue.

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py``
(``subpixel_in_swish`` and its fused backward ``_sis_bwd_pallas``) and of
the masked XLA form at the same call sites (``models/generator.py:303-306,
319-322``). x is the upsample conv's (B, 4C, H, W) output in
``torch.nn.PixelShuffle`` channel order ``c*4 + (2i+j)``; the result is
swish(IN(pixel_shuffle(x))), (B, C, 2H, 2W), with torch InstanceNorm
numerics on the shuffled tensor. ``lengths`` counts the valid frames of the
*shuffled* time axis (2W wide), as ``tm_up1`` and ``tm_up2`` do in the JAX
generator.

``pixel_shuffle_in_swish`` launches the CUDA forward (``csrc/ps_in_swish.cu``)
for a tensor on the card and runs ``pixel_shuffle_in_swish_plain`` for a
tensor on the CPU. Where an input requires grad it runs through an
autograd Function: the forward also keeps each (sample, channel)'s mean
and inv-std, and the backward is the fused kernel
``pixel_shuffle_in_swish_backward`` on the card, its plain version on the
CPU. The masked function has no backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    EPS,
    check_args,
    instance_norm_plain,
    wants_grad,
)

PS_IN_SWISH_KERNEL = CudaKernel("ps_in_swish", "ps_in_swish_forward",
                                [PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                 INT, INT, INT, INT, PTR])
PS_IN_SWISH_BWD_KERNEL = CudaKernel("ps_in_swish", "ps_in_swish_backward",
                                    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                     INT, INT, INT, INT, PTR])


def pixel_shuffle_in_swish_plain(x: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(IN(pixel_shuffle(x, 2))) in plain PyTorch."""
    z = instance_norm_plain(F.pixel_shuffle(x, 2), scale, bias, lengths)
    return z * torch.sigmoid(z)


def pixel_shuffle_stats_plain(x: torch.Tensor):
    """Unmasked (mean, inv-std) of each shuffled channel, (B, C) each: the
    statistics of the channel's four input rows, the same values."""
    B, C4 = x.shape[:2]
    xs = x.float().reshape(B, C4 // 4, -1)
    mean = xs.mean(-1)
    inv = torch.rsqrt((xs - mean[..., None]).square().mean(-1) + EPS)
    return mean, inv


def pixel_shuffle_in_swish_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                                          scale: torch.Tensor, bias: torch.Tensor,
                                          mean: torch.Tensor, inv: torch.Tensor):
    """(dx, dscale, dbias) of the unmasked function from the forward's
    statistics: the formulas of ``_sis_bwd_xla`` (``ps_kernel.py:314-336``)
    over the inverse shuffle of dy."""
    B, C4, H, W = x.shape
    C, n = C4 // 4, 4 * H * W
    xs = x.reshape(B, C, n)
    dys = F.pixel_unshuffle(dy, 2).reshape(B, C, n)
    m, iv = mean[..., None], inv[..., None]
    a = scale[None, :, None] * iv
    z = xs * a + (bias[None, :, None] - m * a)
    s = torch.sigmoid(z)
    dz = dys * (s + z * s * (1.0 - s))
    sdz = dz.sum(-1, keepdim=True)
    dsc = iv * ((dz * xs).sum(-1, keepdim=True) - m * sdz)
    xhat = (xs - m) * iv
    dx = a * (dz - sdz / n - xhat * dsc / n)
    return dx.reshape(x.shape), dsc.sum((0, 2)), sdz.sum((0, 2))


def _check(x: torch.Tensor):
    if x.ndim != 4 or x.shape[1] % 4:
        raise ValueError(f"expected (B, 4C, H, W), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3]


def _forward(x, scale, bias, lengths=None, stats=False):
    """(y, mean, inv); mean and inv are None unless ``stats``."""
    B, C, H, W = _check(x)
    if x.device.type == "cpu":
        y = pixel_shuffle_in_swish_plain(x, scale, bias, lengths)
        return (y, *pixel_shuffle_stats_plain(x)) if stats else (y, None, None)
    y = torch.empty((B, C, 2 * H, 2 * W), device=x.device, dtype=x.dtype)
    mean = inv = None
    if stats:
        mean = torch.empty((B, C), device=x.device, dtype=torch.float32)
        inv = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        PS_IN_SWISH_KERNEL(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                           None if lengths is None else lengths.data_ptr(),
                           y.data_ptr(), None if mean is None else mean.data_ptr(),
                           None if inv is None else inv.data_ptr(), B, C, H, W,
                           torch.cuda.current_stream().cuda_stream)
    return y, mean, inv


def pixel_shuffle_in_swish_with_stats(x: torch.Tensor, scale: torch.Tensor,
                                      bias: torch.Tensor):
    """The unmasked forward and its statistics: (y, mean, inv)."""
    check_args(x, _check(x)[1], (scale, bias), None)
    return _forward(x, scale, bias, stats=True)


def pixel_shuffle_in_swish_backward(x: torch.Tensor, dy: torch.Tensor,
                                    scale: torch.Tensor, bias: torch.Tensor,
                                    mean: torch.Tensor, inv: torch.Tensor):
    """(dx, dscale, dbias) of the unmasked function; dscale and dbias are
    summed over the batch. dy may be non-contiguous (a batch slice, or a
    checkpoint's recompute): it is made contiguous before the launch."""
    B, C, H, W = _check(x)
    check_args(x, C, (scale, bias), None)
    dy = dy.contiguous()
    for name, t, shape in (("dy", dy, (B, C, 2 * H, 2 * W)), ("mean", mean, (B, C)),
                           ("inv", inv, (B, C))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 {name} of shape "
                             f"{shape} on {x.device}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return pixel_shuffle_in_swish_backward_plain(x, dy, scale, bias, mean, inv)
    dx = torch.empty_like(x)
    dscale = torch.empty((B, C), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    with torch.cuda.device(x.device):
        PS_IN_SWISH_BWD_KERNEL(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                               bias.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                               dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                               B, C, H, W, torch.cuda.current_stream().cuda_stream)
    return dx, dscale.sum(0), dbias.sum(0)


class _PixelShuffleInSwishFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        y, mean, inv = _forward(x, scale, bias, stats=True)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, inv = ctx.saved_tensors
        return pixel_shuffle_in_swish_backward(x, dy, scale, bias, mean, inv)


def pixel_shuffle_in_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 4C, H, W) PixelShuffle-ordered -> (B, C, 2H, 2W)."""
    check_args(x, _check(x)[1], (scale, bias), lengths)
    if wants_grad((x, scale, bias), lengths):
        return _PixelShuffleInSwishFn.apply(x, scale, bias)
    return _forward(x, scale, bias, lengths)[0]
