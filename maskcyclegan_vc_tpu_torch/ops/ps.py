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

x is f32 or bf16, as the Pallas kernels take it; y, dy and dx are in x's
dtype, and scale, bias, the statistics, dscale and dbias are f32. Every
kernel has one C entry per dtype, with its own launch count.

``pixel_shuffle_in_swish`` launches the CUDA forward (``csrc/ps_in_swish.cu``)
for a tensor on the card and runs ``pixel_shuffle_in_swish_plain`` for a
tensor on the CPU. On the card each launch also counts the route its
blocks took, as the C entry reports it (``ROUTES``): each (sample,
channel) row staged once in shared memory by a bulk copy, or streamed from
device memory where it is larger than a block's shared memory. Where an
input requires grad it runs through an autograd Function: the forward also
keeps each (sample, channel)'s mean and inv-std. The masked function has
no backward.

The backward takes the JAX package's two routes (``_sis_bwd``,
``ps_kernel.py:386-392``), chosen by the same per-sample size:

- up to ``BWD_BUDGET_BYTES`` of ``pixel_shuffle_in_swish_backward_bytes``,
  the fused kernel K5, ``pixel_shuffle_in_swish_backward``, from the
  forward's statistics, each row's x and dy staged in shared memory (it
  raises for rows that do not fit, ``smem_limit_bytes``; within the budget
  the model's rows are at most 87 KB);
- past it, ``pixel_shuffle_in_swish_backward_split``: the inverse shuffle
  K6 on dy, then the gradient in eager PyTorch from one-pass statistics
  recomputed from x (``_sis_bwd_xla``).

On the TPU the budget bounds the fused kernel's VMEM blocks; the card has
no such limit, but the port keeps it so that both packages run the same
formulas at every crop size (the full-width generator's upSample2 takes the
split route from 137 frames, upSample1 from 273; in bf16, whose bytes are
half, from 273 and 545), and since it is the JAX package's only path
through K6. On the CPU both routes run plain versions.

``pixel_shuffle`` (K7) and ``inverse_pixel_shuffle`` (K6) are the bare
permutations, ``csrc/pixel_shuffle.cu``: each is the other's transpose, so
each one's gradient is the other kernel. On the card each launch counts the
route its C entry reports (``SHUFFLE_ROUTES``): 16-byte units ("vector")
where a row's W elements fill whole 16-byte words and both tensors start on
a 16-byte boundary, else one element pair a thread ("pair").

Inside ``utils.debug.nan_debug_mode`` the tensors each launch wrote are
checked for NaN (``debug.check_kernel_outputs``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel, load
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    EPS,
    instance_norm_f32,
    check_args,
    wants_grad,
)
from maskcyclegan_vc_tpu_torch.utils import debug

_FWD_ARGS = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR]
_BWD_ARGS = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR]
_SHUFFLE_ARGS = [PTR, PTR, INT, INT, INT, INT, PTR, PTR]
PS_IN_SWISH_KERNEL = CudaKernel("ps_in_swish", "ps_in_swish_forward", _FWD_ARGS)
PS_IN_SWISH_BWD_KERNEL = CudaKernel("ps_in_swish", "ps_in_swish_backward", _BWD_ARGS)
SHUFFLE_KERNEL = CudaKernel("pixel_shuffle", "pixel_shuffle_forward", _SHUFFLE_ARGS)
INV_SHUFFLE_KERNEL = CudaKernel("pixel_shuffle", "inverse_pixel_shuffle_forward",
                                _SHUFFLE_ARGS)
# The entry of each kernel for each dtype of x.
ENTRIES = {
    "ps_in_swish": {
        torch.float32: PS_IN_SWISH_KERNEL,
        torch.bfloat16: CudaKernel("ps_in_swish", "ps_in_swish_forward_bf16", _FWD_ARGS)},
    "ps_in_swish_bwd": {
        torch.float32: PS_IN_SWISH_BWD_KERNEL,
        torch.bfloat16: CudaKernel("ps_in_swish", "ps_in_swish_backward_bf16", _BWD_ARGS)},
    "shuffle": {
        torch.float32: SHUFFLE_KERNEL,
        torch.bfloat16: CudaKernel("pixel_shuffle", "pixel_shuffle_forward_bf16",
                                   _SHUFFLE_ARGS)},
    "inv_shuffle": {
        torch.float32: INV_SHUFFLE_KERNEL,
        torch.bfloat16: CudaKernel("pixel_shuffle", "inverse_pixel_shuffle_forward_bf16",
                                   _SHUFFLE_ARGS)},
}

# K4's launches by the route its blocks took, for each dtype of x, as the
# C entry reports it (``csrc/ps_in_swish.cu``): the row bulk-copied into
# shared memory ("bulk"), or read from device memory where it exceeds a
# block's shared memory ("stream"). K5 has the first route only; its
# launches are its entry's count. A caller may set a count back to 0.
ROUTE_NAMES = ("bulk", "stream")
ROUTES = {dtype: dict.fromkeys(ROUTE_NAMES, 0) for dtype in (torch.float32, torch.bfloat16)}
# K7's ("shuffle") and K6's ("inv_shuffle") launches by route, for each
# dtype, as the C entry reports it (``csrc/pixel_shuffle.cu``). A caller may
# set a count back to 0.
SHUFFLE_ROUTE_NAMES = ("vector", "pair")
SHUFFLE_ROUTES = {k: {dtype: dict.fromkeys(SHUFFLE_ROUTE_NAMES, 0)
                      for dtype in (torch.float32, torch.bfloat16)}
                  for k in ("shuffle", "inv_shuffle")}


def smem_limit_bytes(device) -> int:
    """The most bytes one K4 or K5 block stages in shared memory on
    ``device``: K4's row, or K5's x row and dy plane together. A larger
    K4 row streams from device memory; K5 refuses it."""
    lib = load("ps_in_swish")
    lib.ps_in_swish_smem_limit.restype = INT
    with torch.cuda.device(device):
        return lib.ps_in_swish_smem_limit()


# ``_BWD_VMEM_BUDGET`` of ps_kernel.py: past it the backward takes the split
# route. Read at each call, so a test may patch it.
BWD_BUDGET_BYTES = 32 << 20


def pixel_shuffle_in_swish_plain(x: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(IN(pixel_shuffle(x, 2))) in plain PyTorch, computed in f32 and
    rounded once to x's dtype."""
    z = instance_norm_f32(F.pixel_shuffle(x, 2), scale, bias, lengths)
    return (z * torch.sigmoid(z)).to(x.dtype)


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
    over the inverse shuffle of dy, in f32. dx uses dz rounded to x's dtype,
    as K5 and the Pallas kernel use the dz they park in dx
    (``ps_kernel.py:233, 251``); the sums take dz unrounded."""
    B, C4, H, W = x.shape
    C, n = C4 // 4, 4 * H * W
    xs = x.float().reshape(B, C, n)
    dys = F.pixel_unshuffle(dy, 2).float().reshape(B, C, n)
    m, iv = mean[..., None], inv[..., None]
    a = scale[None, :, None] * iv
    z = xs * a + (bias[None, :, None] - m * a)
    s = torch.sigmoid(z)
    dz = dys * (s + z * s * (1.0 - s))
    sdz = dz.sum(-1, keepdim=True)
    dsc = iv * ((dz * xs).sum(-1, keepdim=True) - m * sdz)
    xhat = (xs - m) * iv
    parked = dz.to(x.dtype).float()
    dx = a * (parked - sdz / n - xhat * dsc / n)
    return dx.reshape(x.shape).to(x.dtype), dsc.sum((0, 2)), sdz.sum((0, 2))


def _check(x: torch.Tensor):
    if x.ndim != 4 or x.shape[1] % 4:
        raise ValueError(f"expected (B, 4C, H, W), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3]


def pixel_shuffle_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W): ``F.pixel_shuffle(x, 2)``."""
    return F.pixel_shuffle(x, 2)


def inverse_pixel_shuffle_plain(dy: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) -> (B, 4C, H, W): ``F.pixel_unshuffle(dy, 2)``."""
    return F.pixel_unshuffle(dy, 2)


def _launch_shuffle(kernel: str, src: torch.Tensor) -> torch.Tensor:
    """K7 (``kernel`` "shuffle") on a (B, 4C, H, W) tensor, or K6
    ("inv_shuffle") on a (B, C, 2H, 2W) one: one launch of the entry for
    src's dtype on the card, the plain version on the CPU."""
    if src.device.type == "cpu":
        plain = pixel_shuffle_plain if kernel == "shuffle" else inverse_pixel_shuffle_plain
        return plain(src)
    check_args(src, src.shape[1], (), None)
    if kernel == "shuffle":
        B, C, H, W = _check(src)
        out = torch.empty((B, C, 2 * H, 2 * W), device=src.device, dtype=src.dtype)
    else:
        if src.ndim != 4 or src.shape[2] % 2 or src.shape[3] % 2:
            raise ValueError(f"expected (B, C, 2H, 2W), got {tuple(src.shape)}")
        B, C, H, W = src.shape[0], src.shape[1], src.shape[2] // 2, src.shape[3] // 2
        out = torch.empty((B, 4 * C, H, W), device=src.device, dtype=src.dtype)
    if src.data_ptr() % (2 * src.element_size()):
        raise ValueError("expected a tensor aligned to two elements")
    route = ctypes.c_int()
    entry = ENTRIES[kernel][src.dtype]
    with torch.cuda.device(src.device):
        entry(src.data_ptr(), out.data_ptr(), B, C, H, W, ctypes.addressof(route),
              torch.cuda.current_stream().cuda_stream)
    SHUFFLE_ROUTES[kernel][src.dtype][SHUFFLE_ROUTE_NAMES[route.value]] += 1
    debug.check_kernel_outputs(entry.symbol, out)
    return out


class _PixelShuffleFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _launch_shuffle("shuffle", x)

    @staticmethod
    def backward(ctx, dy):
        return inverse_pixel_shuffle(dy.contiguous())


class _InversePixelShuffleFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dy):
        return _launch_shuffle("inv_shuffle", dy)

    @staticmethod
    def backward(ctx, dx):
        return pixel_shuffle(dx.contiguous())


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """K7: (B, 4C, H, W) PixelShuffle-ordered -> (B, C, 2H, 2W)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PixelShuffleFn.apply(x)
    return _launch_shuffle("shuffle", x)


def inverse_pixel_shuffle(dy: torch.Tensor) -> torch.Tensor:
    """K6: (B, C, 2H, 2W) -> (B, 4C, H, W) PixelShuffle-ordered."""
    if torch.is_grad_enabled() and dy.requires_grad:
        return _InversePixelShuffleFn.apply(dy)
    return _launch_shuffle("inv_shuffle", dy)


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
    route = ctypes.c_int()
    entry = ENTRIES["ps_in_swish"][x.dtype]
    with torch.cuda.device(x.device):
        entry(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
              None if lengths is None else lengths.data_ptr(),
              y.data_ptr(), None if mean is None else mean.data_ptr(),
              None if inv is None else inv.data_ptr(), B, C, H, W,
              ctypes.addressof(route), torch.cuda.current_stream().cuda_stream)
    ROUTES[x.dtype][ROUTE_NAMES[route.value]] += 1
    debug.check_kernel_outputs(entry.symbol, y, *([mean, inv] if stats else []))
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
    summed over the batch. dy, in x's dtype, may be non-contiguous (a batch
    slice, or a checkpoint's recompute): it is made contiguous before the
    launch. mean and inv are the forward's f32 statistics. On the card a
    row's x and dy must fit a block's shared memory together
    (``smem_limit_bytes``), else the launch raises."""
    B, C, H, W = _check(x)
    check_args(x, C, (scale, bias), None)
    dy = dy.contiguous()
    for name, t, shape, dtype in (("dy", dy, (B, C, 2 * H, 2 * W), x.dtype),
                                  ("mean", mean, (B, C), torch.float32),
                                  ("inv", inv, (B, C), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} {name} of shape "
                             f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)}")
    if x.device.type == "cpu":
        return pixel_shuffle_in_swish_backward_plain(x, dy, scale, bias, mean, inv)
    dx = torch.empty_like(x)
    dscale = torch.empty((B, C), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    entry = ENTRIES["ps_in_swish_bwd"][x.dtype]
    with torch.cuda.device(x.device):
        entry(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
              mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
              dbias.data_ptr(), B, C, H, W, torch.cuda.current_stream().cuda_stream)
    debug.check_kernel_outputs(entry.symbol, dx, dscale, dbias)
    return dx, dscale.sum(0), dbias.sum(0)


def pixel_shuffle_in_swish_backward_bytes(x: torch.Tensor) -> int:
    """``_sis_bwd_vmem_bytes`` of ps_kernel.py: six times one sample of x
    (x, dy and dx blocks, each double-buffered on the TPU)."""
    return 6 * x[0].numel() * x.element_size()


def pixel_shuffle_in_swish_backward_split(x: torch.Tensor, dy: torch.Tensor,
                                          scale: torch.Tensor, bias: torch.Tensor):
    """(dx, dscale, dbias) of the unmasked function, dscale and dbias summed
    over the batch: ``_sis_bwd_xla`` (``ps_kernel.py:314-336``). K6 brings dy
    into x's layout, in dy's dtype; the rest is f32, the statistics
    recomputed from x in one pass, rsqrt(max(E[x^2] - E[x]^2, 0) + eps), not
    taken from the forward. dx leaves in x's dtype."""
    B, C, H, W = _check(x)
    check_args(x, C, (scale, bias), None)
    dy = dy.contiguous()
    if dy.shape != (B, C, 2 * H, 2 * W) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"expected {x.dtype} dy of shape {(B, C, 2 * H, 2 * W)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)}")
    n = 4 * H * W
    dyq = inverse_pixel_shuffle(dy).float().reshape(B, C, n)
    xs = x.float().reshape(B, C, n)
    mean = xs.mean(-1, keepdim=True)
    var = ((xs * xs).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + EPS)
    xhat = (xs - mean) * inv
    sc = scale[None, :, None]
    z = xhat * sc + bias[None, :, None]
    s = torch.sigmoid(z)
    dz = dyq * (s + z * s * (1.0 - s))
    sdz = dz.sum(-1, keepdim=True)
    sdzx = (dz * xhat).sum(-1, keepdim=True)
    dx = (sc * inv) * (dz - sdz / n - xhat * sdzx / n)
    return dx.reshape(x.shape).to(x.dtype), sdzx.sum((0, 2)), sdz.sum((0, 2))


class _PixelShuffleInSwishFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        y, mean, inv = _forward(x, scale, bias, stats=True)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, inv = ctx.saved_tensors
        if pixel_shuffle_in_swish_backward_bytes(x) > BWD_BUDGET_BYTES:
            return pixel_shuffle_in_swish_backward_split(x, dy, scale, bias)
        return pixel_shuffle_in_swish_backward(x, dy, scale, bias, mean, inv)


def pixel_shuffle_in_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 4C, H, W) PixelShuffle-ordered -> (B, C, 2H, 2W)."""
    check_args(x, _check(x)[1], (scale, bias), lengths)
    if wants_grad((x, scale, bias), lengths):
        return _PixelShuffleInSwishFn.apply(x, scale, bias)
    return _forward(x, scale, bias, lengths)[0]
