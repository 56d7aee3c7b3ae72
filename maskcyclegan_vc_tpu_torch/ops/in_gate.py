"""Affine InstanceNorm and the true-GLU pair IN(h) * sigmoid(IN(g)).

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py``
(``instance_norm_fused``, ``instance_norm_glu_fused``) and of the masked
InstanceNorm of ``maskcyclegan_vc_tpu/ops/layers.py``
(``_masked_moments``, ``instance_norm_apply``). Torch InstanceNorm
numerics: per-(sample, channel) statistics over every axis after the
channel, biased variance, eps 1e-5, f32, affine.

Layout NCHW (or NCL): x is (B, C, *spatial) with time on the last axis.
``lengths``, an int32 (B,) count of valid frames along that axis, restricts
the statistics to the valid frames (the divisor clamped to at least 1) and
zeroes the output beyond them; ``lengths=None`` is the unmasked function.

Each public function launches its CUDA kernel (``csrc/in_gate.cu``) for a
tensor on the card and runs its ``*_plain`` version for a tensor on the
CPU, and raises for anything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel

EPS = 1e-5

IN_KERNEL = CudaKernel("in_gate", "in_forward",
                       [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])
IN_GLU_KERNEL = CudaKernel("in_gate", "in_glu_forward",
                           [PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                            INT, INT, INT, INT, PTR])


def time_mask(lengths: torch.Tensor, width: int) -> torch.Tensor:
    """(B,) lengths -> (B, width) {0, 1} f32 mask, 1 at valid frames."""
    t = torch.arange(width, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(torch.float32)


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine InstanceNorm of x (B, C, *spatial), f32 statistics."""
    B, C = x.shape[:2]
    dims = tuple(range(2, x.ndim))
    affine_shape = (1, C) + (1,) * (x.ndim - 2)
    xf = x.float()
    if lengths is None:
        m = None
        mean = xf.mean(dims, keepdim=True)
        var = (xf - mean).square().mean(dims, keepdim=True)
    else:
        m = time_mask(lengths, x.shape[-1])
        m = m.view((B,) + (1,) * (x.ndim - 2) + (x.shape[-1],)).expand_as(xf)
        denom = m.sum(dims, keepdim=True).clamp_min(1.0)
        mean = (xf * m).sum(dims, keepdim=True) / denom
        var = ((xf - mean).square() * m).sum(dims, keepdim=True) / denom
    a = torch.rsqrt(var + EPS) * scale.float().view(affine_shape)
    b = bias.float().view(affine_shape) - mean * a
    y = xf * a + b
    return y if m is None else y * m


def instance_norm_glu_plain(hg: torch.Tensor, scale_h: torch.Tensor,
                            bias_h: torch.Tensor, scale_g: torch.Tensor,
                            bias_g: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(h) * sigmoid(IN(g)) with h, g the two channel halves of hg."""
    C = hg.shape[1] // 2
    h = instance_norm_plain(hg[:, :C], scale_h, bias_h, lengths)
    g = instance_norm_plain(hg[:, C:], scale_g, bias_g, lengths)
    return h * torch.sigmoid(g)


def check_args(x: torch.Tensor, channels: int, vecs, lengths) -> None:
    """Raise unless x, the per-channel vectors and lengths suit the kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32, got {x.dtype}")
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, C, *spatial) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    for v in vecs:
        if v.shape != (channels,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"expected float32 ({channels},) vectors on {x.device}")
        if not v.is_contiguous():
            raise ValueError("expected contiguous vectors")
    if lengths is not None and (lengths.shape != (x.shape[0],)
                                or lengths.dtype != torch.int32
                                or lengths.device != x.device
                                or not lengths.is_contiguous()):
        raise ValueError(f"expected int32 lengths of shape ({x.shape[0]},) on {x.device}")
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, *vecs))):
        raise NotImplementedError(
            "the CUDA kernels are forward-only: run under torch.no_grad()")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine InstanceNorm of x (B, C, *spatial) -> the same shape."""
    B, C = x.shape[:2]
    check_args(x, C, (scale, bias), lengths)
    if x.device.type == "cpu":
        return instance_norm_plain(x, scale, bias, lengths)
    y = torch.empty(x.shape, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        IN_KERNEL(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(lengths),
                  y.data_ptr(), B, C, x[0, 0].numel(), x.shape[-1],
                  torch.cuda.current_stream().cuda_stream)
    return y


def instance_norm_glu(hg: torch.Tensor, scale_h: torch.Tensor,
                      bias_h: torch.Tensor, scale_g: torch.Tensor,
                      bias_g: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(h) * sigmoid(IN(g)): hg (B, 2C, *spatial) -> (B, C, *spatial)."""
    B, C2 = hg.shape[:2]
    if C2 % 2:
        raise ValueError(f"expected an even channel count, got {C2}")
    C = C2 // 2
    check_args(hg, C, (scale_h, bias_h, scale_g, bias_g), lengths)
    if hg.device.type == "cpu":
        return instance_norm_glu_plain(hg, scale_h, bias_h, scale_g, bias_g, lengths)
    y = torch.empty((B, C) + tuple(hg.shape[2:]), device=hg.device, dtype=hg.dtype)
    with torch.cuda.device(hg.device):
        IN_GLU_KERNEL(hg.data_ptr(), scale_h.data_ptr(), bias_h.data_ptr(),
                      scale_g.data_ptr(), bias_g.data_ptr(), _ptr(lengths),
                      y.data_ptr(), B, C, hg[0, 0].numel(), hg.shape[-1],
                      torch.cuda.current_stream().cuda_stream)
    return y
