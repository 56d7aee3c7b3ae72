"""Affine InstanceNorm, swish(IN(x)) and the true-GLU pair IN(h) * sigmoid(IN(g)).

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py``
(``instance_norm_fused``, ``instance_norm_swish_fused``,
``instance_norm_glu_fused`` and their custom_vjp backwards) and of the
masked InstanceNorm of ``maskcyclegan_vc_tpu/ops/layers.py``
(``_masked_moments``, ``instance_norm_apply``). Torch InstanceNorm
numerics: per-(sample, channel) statistics over every axis after the
channel, biased variance, eps 1e-5, f32 statistics, affine.

x is f32 or bf16, as the Pallas kernels take it; the per-channel vectors are
f32. Statistics, affine and gate are computed in f32 and the output is
rounded once to x's dtype (``in_gate_kernel.py:77-114``). Each kernel has
one C entry per dtype, with its own launch count; a bf16 tensor never runs
an f32 entry.

Layout NCHW (or NCL): x is (B, C, *spatial) with time on the last axis.
``lengths``, an int32 (B,) count of valid frames along that axis, restricts
the statistics to the valid frames (the divisor clamped to at least 1) and
zeroes the output beyond them; ``lengths=None`` is the unmasked function.

Each public function launches its CUDA kernel (``csrc/in_gate.cu``) for a
tensor on the card and runs its ``*_plain`` version for a tensor on the
CPU, and raises for anything else. On the card each launch of K2 (the
InstanceNorm), K1 (the GLU) and K3 (swish) also counts the route its blocks
took, as the C entry reports it (``ROUTES``): the rows staged once in shared
memory by a bulk copy, or each row streamed from device memory where it is
larger than a block's shared memory (``smem_limit_bytes``). Where an input requires
grad, the unmasked function runs through a ``torch.autograd.Function``
whose forward is that same kernel or plain version. Its backward
(``instance_norm_backward``, ``instance_norm_swish_backward``,
``instance_norm_glu_backward``) recomputes the statistics from the saved
input in f32 and returns dx in x's dtype, dscale and dbias in f32: on the
card one launch of ``in_gate.cu``'s backward entry (x and dy read once, dx
written once; its routes counted in ``ROUTES`` as the forwards'), on the
CPU the JAX package's custom_vjp formulas (``_in_bwd``, ``_insw_bwd``,
``_inglu_bwd``, XLA there) in plain PyTorch (``*_backward_plain``), which
are also the kernel's oracle. On the card those formulas had run as chains
of eager ops, about 83 % of the bytes of a training step's eager ops. The
masked functions have no backward: no training path runs them.
Inside ``utils.debug.nan_debug_mode`` each launch's output is checked for
NaN (``debug.check_kernel_outputs``), as in every kernel wrapper of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel, load
from maskcyclegan_vc_tpu_torch.utils import debug

EPS = 1e-5

DTYPES = (torch.float32, torch.bfloat16)
_ROW_ARGS = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR]
_GLU_ARGS = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR]
IN_KERNEL = CudaKernel("in_gate", "in_forward", _ROW_ARGS)
IN_SWISH_KERNEL = CudaKernel("in_gate", "in_swish_forward", _ROW_ARGS)
IN_GLU_KERNEL = CudaKernel("in_gate", "in_glu_forward", _GLU_ARGS)
# The entry of each kernel for each dtype of x.
ENTRIES = {
    "in": {torch.float32: IN_KERNEL,
           torch.bfloat16: CudaKernel("in_gate", "in_forward_bf16", _ROW_ARGS)},
    "in_swish": {torch.float32: IN_SWISH_KERNEL,
                 torch.bfloat16: CudaKernel("in_gate", "in_swish_forward_bf16", _ROW_ARGS)},
    "in_glu": {torch.float32: IN_GLU_KERNEL,
               torch.bfloat16: CudaKernel("in_gate", "in_glu_forward_bf16", _GLU_ARGS)},
}
# The backwards: (x, dy, vectors, dx, part, B, C, S, W, route, stream).
_ROW_BWD_ARGS = [PTR] * 6 + [INT] * 4 + [PTR, PTR]
_GLU_BWD_ARGS = [PTR] * 8 + [INT] * 4 + [PTR, PTR]
for _k, _symbol, _args in (("in", "in_backward", _ROW_BWD_ARGS),
                           ("in_swish", "in_swish_backward", _ROW_BWD_ARGS),
                           ("in_glu", "in_glu_backward", _GLU_BWD_ARGS)):
    ENTRIES[f"{_k}_bwd"] = {torch.float32: CudaKernel("in_gate", _symbol, _args),
                            torch.bfloat16: CudaKernel("in_gate", f"{_symbol}_bf16", _args)}

# The launches of each entry by the route its blocks took, for each kernel
# (K2's, K3's and K1's forwards and backwards) and dtype of x, as the C
# entry reports it: the rows (a backward's x and dy rows) bulk-copied into
# shared memory ("bulk"), or each row read from device memory where it
# exceeds a block's shared memory ("stream"). On the card every backward of
# a step launches once for each forward launch that recorded a gradient. A
# caller may set a count back to 0.
ROUTE_NAMES = ("bulk", "stream")
ROUTES = {k: {dtype: dict.fromkeys(ROUTE_NAMES, 0) for dtype in DTYPES} for k in ENTRIES}


def smem_limit_bytes(device) -> int:
    """The most bytes one K1, K2 or K3 block stages in shared memory on
    ``device``: its rows (K1's h and g rows together), each from its first
    16-byte boundary to the one after its end. A longer row streams from
    device memory."""
    lib = load("in_gate")
    lib.in_gate_smem_limit.restype = INT
    with torch.cuda.device(device):
        return lib.in_gate_smem_limit()


def widened(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64: the plain versions compute in
    f32 from bf16 and f32 values, and in f64 from f64 ones, which the
    kernels refuse (the f64 gradient tests run the plain versions)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def time_mask(lengths: torch.Tensor, width: int) -> torch.Tensor:
    """(B,) lengths -> (B, width) {0, 1} f32 mask, 1 at valid frames."""
    t = torch.arange(width, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(torch.float32)


def instance_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine InstanceNorm of x (B, C, *spatial) in f32 whatever x's dtype
    (f64 for f64 x: ``widened``)."""
    B, C = x.shape[:2]
    dims = tuple(range(2, x.ndim))
    affine_shape = (1, C) + (1,) * (x.ndim - 2)
    xf = widened(x)
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
    a = torch.rsqrt(var + EPS) * widened(scale).view(affine_shape)
    b = widened(bias).view(affine_shape) - mean * a
    y = xf * a + b
    return y if m is None else y * m


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine InstanceNorm of x (B, C, *spatial), f32 statistics, in x's dtype."""
    return instance_norm_f32(x, scale, bias, lengths).to(x.dtype)


def instance_norm_swish_plain(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(IN(x)); swish(0) = 0 keeps the masked frames at zero."""
    z = instance_norm_f32(x, scale, bias, lengths)
    return (z * torch.sigmoid(z)).to(x.dtype)


def instance_norm_glu_plain(hg: torch.Tensor, scale_h: torch.Tensor,
                            bias_h: torch.Tensor, scale_g: torch.Tensor,
                            bias_g: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(h) * sigmoid(IN(g)) with h, g the two channel halves of hg."""
    C = hg.shape[1] // 2
    h = instance_norm_f32(hg[:, :C], scale_h, bias_h, lengths)
    g = instance_norm_f32(hg[:, C:], scale_g, bias_g, lengths)
    return (h * torch.sigmoid(g)).to(hg.dtype)


def check_args(x: torch.Tensor, channels: int, vecs, lengths) -> None:
    """Raise unless x, the per-channel vectors and lengths suit the kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"expected float32 or bfloat16, got {x.dtype}")
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


def wants_grad(tensors: Sequence[torch.Tensor], lengths) -> bool:
    """True where the call must record a backward; raises for a masked call
    that would need one (the masked functions have none)."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return False
    if lengths is not None:
        raise NotImplementedError(
            "the masked (lengths) functions have no backward: run them under "
            "torch.no_grad(), or pass lengths=None")
    return True


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_rows(kernel: str, x: torch.Tensor, vecs, lengths,
                 out_channels: int) -> torch.Tensor:
    """One launch of in_gate.cu's entry of ``kernel`` for x's dtype over
    x's (B, C) rows."""
    B = x.shape[0]
    y = torch.empty((B, out_channels) + tuple(x.shape[2:]), device=x.device,
                    dtype=x.dtype)
    route = ctypes.c_int(-1)
    entry = ENTRIES[kernel][x.dtype]
    with torch.cuda.device(x.device):
        entry(x.data_ptr(), *(v.data_ptr() for v in vecs), _ptr(lengths), y.data_ptr(), B,
              out_channels, x[0, 0].numel(), x.shape[-1], ctypes.addressof(route),
              torch.cuda.current_stream().cuda_stream)
    ROUTES[kernel][x.dtype][ROUTE_NAMES[route.value]] += 1
    debug.check_kernel_outputs(entry.symbol, y)
    return y


def _in_forward(x, scale, bias, lengths=None):
    if x.device.type == "cpu":
        return instance_norm_plain(x, scale, bias, lengths)
    return _launch_rows("in", x, (scale, bias), lengths, x.shape[1])


def _in_swish_forward(x, scale, bias, lengths=None):
    if x.device.type == "cpu":
        return instance_norm_swish_plain(x, scale, bias, lengths)
    return _launch_rows("in_swish", x, (scale, bias), lengths, x.shape[1])


def _in_glu_forward(hg, scale_h, bias_h, scale_g, bias_g, lengths=None):
    if hg.device.type == "cpu":
        return instance_norm_glu_plain(hg, scale_h, bias_h, scale_g, bias_g, lengths)
    return _launch_rows("in_glu", hg, (scale_h, bias_h, scale_g, bias_g),
                        lengths, hg.shape[1] // 2)


# ---------------------------------------------------------------------------
# Backwards: in_gate.cu's backward entries on the card, the JAX package's
# custom_vjp formulas in plain PyTorch on the CPU
# ---------------------------------------------------------------------------

def _normalized(x: torch.Tensor):
    """(xhat, inv) of x's per-(sample, channel) statistics, recomputed in
    f32 (``xf = x.astype(f32)``, ``in_gate_kernel.py:164``)."""
    x = x.float()
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dims, keepdim=True)
    inv = torch.rsqrt((x - mean).square().mean(dims, keepdim=True) + EPS)
    return (x - mean) * inv, inv


def _affine_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (ndim - 2))


def in_backward(dz: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor,
                scale: torch.Tensor):
    """Gradient of z = xhat * scale + bias: (dx, dscale, dbias), all f32
    (``in_gate_kernel.py:161-174``); dz is f32."""
    dims = tuple(range(2, dz.ndim))
    dscale = (dz * xhat).sum((0,) + dims)
    dbias = dz.sum((0,) + dims)
    a = _affine_view(scale, dz.ndim) * inv
    dx = a * (dz - dz.mean(dims, keepdim=True)
              - xhat * (dz * xhat).mean(dims, keepdim=True))
    return dx, dscale, dbias


def instance_norm_backward_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor):
    """(dx, dscale, dbias) of ``instance_norm``: dx in x's dtype, the
    others f32 (``in_gate_kernel.py:161-174``)."""
    xhat, inv = _normalized(x)
    dx, dscale, dbias = in_backward(dy.float(), xhat, inv, scale)
    return dx.to(x.dtype), dscale, dbias


def instance_norm_swish_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                                       scale: torch.Tensor, bias: torch.Tensor):
    """(dx, dscale, dbias) of ``instance_norm_swish`` (``in_gate_kernel.py:191-207``)."""
    xhat, inv = _normalized(x)
    z = xhat * _affine_view(scale, x.ndim) + _affine_view(bias, x.ndim)
    s = torch.sigmoid(z)
    dz = dy.float() * (s + z * s * (1.0 - s))
    dx, dscale, dbias = in_backward(dz, xhat, inv, scale)
    return dx.to(x.dtype), dscale, dbias


def instance_norm_glu_backward_plain(hg: torch.Tensor, dy: torch.Tensor,
                                     scale_h: torch.Tensor, bias_h: torch.Tensor,
                                     scale_g: torch.Tensor, bias_g: torch.Tensor):
    """(dhg, dscale_h, dbias_h, dscale_g, dbias_g) of ``instance_norm_glu``
    (``in_gate_kernel.py:226-258``); h and g are hg's channel halves, and
    their gradients leave as one (B, 2C, ...) tensor, as hg came in."""
    h, g = hg.chunk(2, dim=1)
    hhat, ih = _normalized(h)
    ghat, ig = _normalized(g)
    yh = hhat * _affine_view(scale_h, hg.ndim) + _affine_view(bias_h, hg.ndim)
    s = torch.sigmoid(ghat * _affine_view(scale_g, hg.ndim) + _affine_view(bias_g, hg.ndim))
    dyf = dy.float()
    dh, dsh, dbh = in_backward(dyf * s, hhat, ih, scale_h)
    dg, dsg, dbg = in_backward(dyf * yh * s * (1.0 - s), ghat, ig, scale_g)
    return torch.cat([dh, dg], dim=1).to(hg.dtype), dsh, dbh, dsg, dbg


PLAIN_BACKWARDS = {"in": instance_norm_backward_plain,
                   "in_swish": instance_norm_swish_backward_plain,
                   "in_glu": instance_norm_glu_backward_plain}


def _launch_backward(kernel: str, x: torch.Tensor, dy: torch.Tensor, vecs):
    """One launch of in_gate.cu's backward entry of ``kernel`` for x's
    dtype: (dx, dscale, dbias, ...), one (dscale, dbias) pair for each
    array of x (K1: h's, then g's). The kernel leaves each row's share in a
    (2A, B, C) f32 array, summed here over the batch."""
    B = x.shape[0]
    arrays = len(vecs) // 2
    C = x.shape[1] // arrays
    dx = torch.empty_like(x)
    part = torch.empty((2 * arrays, B, C), device=x.device, dtype=torch.float32)
    route = ctypes.c_int(-1)
    name = f"{kernel}_bwd"
    entry = ENTRIES[name][x.dtype]
    with torch.cuda.device(x.device):
        entry(x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in vecs), dx.data_ptr(),
              part.data_ptr(), B, C, x[0, 0].numel(), x.shape[-1], ctypes.addressof(route),
              torch.cuda.current_stream().cuda_stream)
    ROUTES[name][x.dtype][ROUTE_NAMES[route.value]] += 1
    debug.check_kernel_outputs(entry.symbol, dx, part)
    return (dx, *(part[:, 0] if B == 1 else part.sum(1)))


def _backward(kernel: str, x: torch.Tensor, dy: torch.Tensor, vecs):
    """The gradients of ``kernel`` (an ENTRIES key of a forward) at x from
    dy, the gradient of its output: the kernel on the card, the plain
    formulas on the CPU. dy may be non-contiguous (a batch slice of a
    larger gradient): it is made contiguous before the launch."""
    arrays = len(vecs) // 2
    check_args(x, x.shape[1] // arrays if x.ndim > 1 else 0, vecs, None)
    want = (x.shape[0], x.shape[1] // arrays) + tuple(x.shape[2:])
    if dy.shape != want or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"expected {x.dtype} dy of shape {want} on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return PLAIN_BACKWARDS[kernel](x, dy, *vecs)
    return _launch_backward(kernel, x, dy, vecs)


def instance_norm_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor):
    """(dx, dscale, dbias) of the unmasked ``instance_norm`` at x from dy:
    dx in x's dtype, dscale and dbias f32, summed over the batch."""
    return _backward("in", x, dy, (scale, bias))


def instance_norm_swish_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor):
    """(dx, dscale, dbias) of the unmasked ``instance_norm_swish``."""
    return _backward("in_swish", x, dy, (scale, bias))


def instance_norm_glu_backward(hg: torch.Tensor, dy: torch.Tensor, scale_h: torch.Tensor,
                               bias_h: torch.Tensor, scale_g: torch.Tensor,
                               bias_g: torch.Tensor):
    """(dhg, dscale_h, dbias_h, dscale_g, dbias_g) of the unmasked
    ``instance_norm_glu``; dhg is (B, 2C, ...), as hg."""
    return _backward("in_glu", hg, dy, (scale_h, bias_h, scale_g, bias_g))


class _InstanceNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale, bias)
        return _in_forward(x, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        return instance_norm_backward(x, dy, scale, bias)


class _InstanceNormSwishFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale, bias)
        return _in_swish_forward(x, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        return instance_norm_swish_backward(x, dy, scale, bias)


class _InstanceNormGluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hg, scale_h, bias_h, scale_g, bias_g):
        ctx.save_for_backward(hg, scale_h, bias_h, scale_g, bias_g)
        return _in_glu_forward(hg, scale_h, bias_h, scale_g, bias_g)

    @staticmethod
    def backward(ctx, dy):
        hg, *vecs = ctx.saved_tensors
        return instance_norm_glu_backward(hg, dy, *vecs)


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine InstanceNorm of x (B, C, *spatial) -> the same shape."""
    check_args(x, x.shape[1] if x.ndim > 1 else 0, (scale, bias), lengths)
    if wants_grad((x, scale, bias), lengths):
        return _InstanceNormFn.apply(x, scale, bias)
    return _in_forward(x, scale, bias, lengths)


def instance_norm_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(IN(x)) of x (B, C, *spatial) -> the same shape."""
    check_args(x, x.shape[1] if x.ndim > 1 else 0, (scale, bias), lengths)
    if wants_grad((x, scale, bias), lengths):
        return _InstanceNormSwishFn.apply(x, scale, bias)
    return _in_swish_forward(x, scale, bias, lengths)


def instance_norm_glu(hg: torch.Tensor, scale_h: torch.Tensor,
                      bias_h: torch.Tensor, scale_g: torch.Tensor,
                      bias_g: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN(h) * sigmoid(IN(g)): hg (B, 2C, *spatial) -> (B, C, *spatial)."""
    if hg.ndim < 2 or hg.shape[1] % 2:
        raise ValueError(f"expected (B, 2C, ...) with an even channel count, "
                         f"got {tuple(hg.shape)}")
    vecs = (scale_h, bias_h, scale_g, bias_g)
    check_args(hg, hg.shape[1] // 2, vecs, lengths)
    if wants_grad((hg, *vecs), lengths):
        return _InstanceNormGluFn.apply(hg, *vecs)
    return _in_glu_forward(hg, *vecs, lengths)
