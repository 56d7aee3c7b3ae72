"""One MelGAN residual stage (K9): three ResnetBlocks, then lrelu or the tail.

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/melgan_stack_kernel.py``
(``melgan_resstack``), in PyTorch's conv layout: x is (B, C, W), time
last, as the port's ``MelGANGenerator`` keeps it for cuDNN's up-convs (the
JAX kernel takes (B, W, C); the tests transpose). ``blocks`` are the three
ResnetBlocks' parameters under their module names (``conv1.weight`` (C, C,
3) dilated 1, 3, 9; ``conv2.weight`` and ``shortcut.weight`` (C, C, 1); and
the biases), and ``tail`` the generator's last conv, (weight (1, C, 7),
bias (1,)).

x is f32 or bf16, as the Pallas kernel takes it. In bf16 the weights are
rounded to bf16 as the JAX MelGAN's ``conv_param`` casts them
(``models/melgan.py:139-144``), the arithmetic is f32, and values are
rounded to bf16 where the Pallas kernel rounds them
(``melgan_resstack_plain_bf16``). The weights come in f32 or in x's dtype.

On the card both forms multiply on the tensor cores (``csrc/melgan_stack.cu``):
f32 as 3xTF32 ``mma.sync`` products, bf16 as bf16 ``mma.sync.m16n8k16``
implicit GEMMs over a position-major tile (bf16 products are exact in f32,
so only the order of the f32 sums differs from the plain version's).

``melgan_resstack`` launches ``csrc/melgan_stack.cu``'s entry for x's
dtype (``ENTRIES``) for x on the card and runs that dtype's plain version
(``PLAIN``) for x on the CPU; anything else raises. Each entry has its own
launch count, which counts calls: one call is 3 device launches (one per
block), 4 with the tail. Inference only, as in JAX: a call that would need
a gradient raises. Every block writes its own buffer, so that inside
``utils.debug.nan_debug_mode`` each block's output is checked in order,
then the tail's, and the first launch to make a NaN is the one named.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel
from maskcyclegan_vc_tpu_torch.utils import debug

DILATIONS = (1, 3, 9)
LRELU_SLOPE = 0.2

_ARGS = [PTR] * 11 + [INT, INT, INT, INT, PTR]
MELGAN_STACK_KERNEL = CudaKernel("melgan_stack", "melgan_resstack_forward", _ARGS)
# The entry for each dtype of x.
ENTRIES = {torch.float32: MELGAN_STACK_KERNEL,
           torch.bfloat16: CudaKernel("melgan_stack", "melgan_resstack_forward_bf16", _ARGS)}

Blocks = Sequence[Mapping[str, torch.Tensor]]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Mirror-pad the last axis of (B, C, W) by p a side, as ``jnp.pad(...,
    mode="reflect")``: for p >= W the mirror repeats with period 2 (W - 1)
    (a constant for W = 1), where ``F.pad`` refuses."""
    W = x.shape[-1]
    if p < W:
        return F.pad(x, (p, p), mode="reflect")
    i = torch.arange(-p, W + p, device=x.device)
    if W > 1:
        i = i.remainder(2 * (W - 1))
        i = torch.where(i >= W, 2 * (W - 1) - i, i)
    else:
        i = torch.zeros_like(i)
    return x.index_select(-1, i)


def melgan_resstack_plain(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool = False,
                          tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """The per-block chain of the JAX package's XLA path, with F.conv1d."""
    for d, bp in zip(DILATIONS, blocks):
        h = F.conv1d(reflect_pad(leaky_relu(x), d), bp["conv1.weight"],
                     bp["conv1.bias"], dilation=d)
        h = F.conv1d(leaky_relu(h), bp["conv2.weight"], bp["conv2.bias"])
        x = F.conv1d(x, bp["shortcut.weight"], bp["shortcut.bias"]) + h
    if tail is not None:
        return torch.tanh(F.conv1d(reflect_pad(leaky_relu(x), 3), *tail))[:, 0]
    return leaky_relu(x) if emit_lrelu else x


def melgan_resstack_plain_bf16(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool = False,
                               tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                               ) -> torch.Tensor:
    """The bf16 form, bf16 x -> bf16 output: weights and biases rounded to
    bf16, products and sums in f32 on bf16 values, and a rounding to bf16
    at each point where the Pallas kernel rounds
    (``melgan_stack_kernel.py:161-229``):

    1. lrelu(x), before the dilated conv;
    2. lrelu(h), h summed in f32 from the f32-widened bias b1;
    3. each block's output, the merged 1x1 conv [shortcut | conv2] over
       [x ; lrelu(h)] plus bm, in f32;
    4. bm = bs + b2, summed in bf16 and widened (:304-313);
    5. with ``emit_lrelu``, lrelu of the bf16 output, in f32;
    6. with ``tail``, tanh of the f32 conv7 over lrelu(x) in bf16 plus b7.
    """
    bf16 = torch.bfloat16

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(bf16).float()

    cur = x.float()  # exact: x holds bf16 values
    for d, bp in zip(DILATIONS, blocks):
        h = F.conv1d(reflect_pad(rnd(leaky_relu(cur)), d), rnd(bp["conv1.weight"]),
                     rnd(bp["conv1.bias"]), dilation=d)
        wm = torch.cat([rnd(bp["shortcut.weight"]), rnd(bp["conv2.weight"])], dim=1)
        bm = (bp["shortcut.bias"].to(bf16) + bp["conv2.bias"].to(bf16)).float()
        cur = rnd(F.conv1d(torch.cat([cur, rnd(leaky_relu(h))], dim=1), wm, bm))
    if tail is not None:
        y = F.conv1d(reflect_pad(rnd(leaky_relu(cur)), 3), rnd(tail[0]), rnd(tail[1]))
        return torch.tanh(y)[:, 0].to(bf16)
    return (leaky_relu(cur) if emit_lrelu else cur).to(bf16)


# The plain version for each dtype of x.
PLAIN = {torch.float32: melgan_resstack_plain, torch.bfloat16: melgan_resstack_plain_bf16}


def pack_weights(blocks: Blocks, tail=None, dtype: torch.dtype = torch.float32):
    """The kernel's weight layout: w1 (3, 3, C, C) [block][tap][ci][co],
    b1 (3, C), wm (3, 2C, C) [block][shortcut ci | conv2 ci][co],
    bm (3, C) = bs + b2, and the tail's k7 (7, C), b7 (1,). w1, wm and k7
    in the compute ``dtype``; the biases rounded to it, then widened to f32,
    bm summed in ``dtype`` (JAX casts the biases first,
    ``melgan_stack_kernel.py:304-313``)."""
    def bias(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype).float()

    w1 = torch.stack([bp["conv1.weight"].to(dtype).permute(2, 1, 0) for bp in blocks])
    b1 = torch.stack([bias(bp["conv1.bias"]) for bp in blocks])
    wm = torch.stack([torch.cat([bp["shortcut.weight"][:, :, 0].t(),
                                 bp["conv2.weight"][:, :, 0].t()]).to(dtype) for bp in blocks])
    bm = torch.stack([(bp["shortcut.bias"].to(dtype) + bp["conv2.bias"].to(dtype)).float()
                      for bp in blocks])
    packed = [t.contiguous() for t in (w1, b1, wm, bm)]
    if tail is None:
        return (*packed, None, None)
    return (*packed, tail[0][0].t().to(dtype).contiguous(), bias(tail[1]).contiguous())


def _check(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool, tail) -> None:
    if x.ndim != 3 or x.dtype not in ENTRIES:
        raise ValueError(f"expected (B, C, W) float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    B, C, W = x.shape
    if len(blocks) != len(DILATIONS):
        raise ValueError(f"expected {len(DILATIONS)} blocks, got {len(blocks)}")
    if W < 1:
        raise ValueError("expected W >= 1")
    if emit_lrelu and tail is not None:
        raise ValueError("emit_lrelu and tail exclude each other")
    shapes = {"conv1.weight": (C, C, 3), "conv2.weight": (C, C, 1),
              "shortcut.weight": (C, C, 1), "conv1.bias": (C,), "conv2.bias": (C,),
              "shortcut.bias": (C,)}
    params = [bp[k] for bp in blocks for k in shapes] + list(tail or ())
    for bp in blocks:
        for k, shape in shapes.items():
            if tuple(bp[k].shape) != shape:
                raise ValueError(f"{k}: expected {shape}, got {tuple(bp[k].shape)}")
    if tail is not None and (tuple(tail[0].shape) != (1, C, 7)
                             or tuple(tail[1].shape) != (1,)):
        raise ValueError("tail: expected weight (1, C, 7) and bias (1,)")
    dtypes = {t.dtype for t in params}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, x.dtype):
        raise ValueError(f"expected the weights all float32 or all {x.dtype}, got "
                         f"{sorted(str(t.dtype) for t in params)}")
    if any(t.device != x.device for t in params):
        raise ValueError(f"expected the weights on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x] + params):
        raise NotImplementedError("the MelGAN stage has no backward: run it under "
                                  "torch.no_grad() or torch.inference_mode()")


def melgan_resstack(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool = False,
                    tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """(B, C, W) stage input -> (B, C, W) stage output (pre-activated with
    ``emit_lrelu``), or the (B, W) waveform with ``tail``."""
    _check(x, blocks, emit_lrelu, tail)
    if x.device.type == "cpu":
        return PLAIN[x.dtype](x, blocks, emit_lrelu, tail)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, C, W = x.shape
    if C < 4 or C > 256 or 1024 % C:
        raise ValueError(f"the kernel takes C a power of two from 4 to 256, got {C}")
    x = x.contiguous()
    packed = pack_weights(blocks, tail, x.dtype)
    # Blocks 1 and 2 write buf0 and buf1; block 3 writes out, or buf2 for
    # the tail to read.
    buf0, buf1 = torch.empty_like(x), torch.empty_like(x)
    buf2 = torch.empty_like(x) if tail is not None else None
    out = torch.empty((B, W) if tail is not None else (B, C, W), device=x.device,
                      dtype=x.dtype)
    ptrs = [None if t is None else t.data_ptr() for t in packed]
    kernel = ENTRIES[x.dtype]
    with torch.cuda.device(x.device):
        kernel(x.data_ptr(), *ptrs, buf0.data_ptr(), buf1.data_ptr(),
               None if buf2 is None else buf2.data_ptr(), out.data_ptr(), B, C, W,
               int(emit_lrelu), torch.cuda.current_stream().cuda_stream)
    tail_out = [] if tail is None else [("tail", out)]
    debug.check_kernel_outputs(kernel.symbol, ("block 1 of 3", buf0), ("block 2 of 3", buf1),
                               ("block 3 of 3", out if tail is None else buf2), *tail_out)
    return out
