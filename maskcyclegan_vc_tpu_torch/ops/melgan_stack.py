"""One MelGAN residual stage (K9): three ResnetBlocks, then lrelu or the tail.

Counterpart of ``maskcyclegan_vc_tpu/ops/pallas/melgan_stack_kernel.py``
(``melgan_resstack``), in PyTorch's conv layout: x is (B, C, W), time
last, as the port's ``MelGANGenerator`` keeps it for cuDNN's up-convs (the
JAX kernel takes (B, W, C); the tests transpose). ``blocks`` are the three
ResnetBlocks' parameters under their module names (``conv1.weight`` (C, C,
3) dilated 1, 3, 9; ``conv2.weight`` and ``shortcut.weight`` (C, C, 1); and
the biases), and ``tail`` the generator's last conv, (weight (1, C, 7),
bias (1,)).

``melgan_resstack`` launches ``csrc/melgan_stack.cu`` for x on the card and
runs ``melgan_resstack_plain`` for x on the CPU; anything else raises. Its
launch count counts calls: one call is 3 device launches (one per block),
4 with the tail. Inference only, as in JAX: a call that would need a
gradient raises.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.cuda_lib import INT, PTR, CudaKernel

DILATIONS = (1, 3, 9)
LRELU_SLOPE = 0.2

MELGAN_STACK_KERNEL = CudaKernel("melgan_stack", "melgan_resstack_forward",
                                 [PTR] * 10 + [INT, INT, INT, INT, PTR])

Blocks = Sequence[Mapping[str, torch.Tensor]]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Mirror-pad the last axis of (B, C, W) by p a side."""
    return F.pad(x, (p, p), mode="reflect")


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


def pack_weights(blocks: Blocks, tail=None):
    """The kernel's weight layout: w1 (3, 3, C, C) [block][tap][ci][co],
    b1 (3, C), wm (3, 2C, C) [block][shortcut ci | conv2 ci][co],
    bm (3, C) = bs + b2, and the tail's k7 (7, C), b7 (1,)."""
    w1 = torch.stack([bp["conv1.weight"].permute(2, 1, 0) for bp in blocks]).contiguous()
    b1 = torch.stack([bp["conv1.bias"] for bp in blocks]).contiguous()
    wm = torch.stack([torch.cat([bp["shortcut.weight"][:, :, 0].t(),
                                 bp["conv2.weight"][:, :, 0].t()]) for bp in blocks]).contiguous()
    bm = torch.stack([bp["shortcut.bias"] + bp["conv2.bias"] for bp in blocks]).contiguous()
    if tail is None:
        return w1, b1, wm, bm, None, None
    return w1, b1, wm, bm, tail[0][0].t().contiguous(), tail[1].contiguous()


def _check(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool, tail) -> None:
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"expected (B, C, W) float32, got {tuple(x.shape)} {x.dtype}")
    B, C, W = x.shape
    if len(blocks) != len(DILATIONS):
        raise ValueError(f"expected {len(DILATIONS)} blocks, got {len(blocks)}")
    if W <= max(DILATIONS):
        raise ValueError(f"W = {W}: reflect padding by {max(DILATIONS)} needs W > 9")
    if emit_lrelu and tail is not None:
        raise ValueError("emit_lrelu and tail exclude each other")
    shapes = {"conv1.weight": (C, C, 3), "conv2.weight": (C, C, 1),
              "shortcut.weight": (C, C, 1), "conv1.bias": (C,), "conv2.bias": (C,),
              "shortcut.bias": (C,)}
    tensors = [x] + [bp[k] for bp in blocks for k in shapes] + list(tail or ())
    for bp in blocks:
        for k, shape in shapes.items():
            if tuple(bp[k].shape) != shape:
                raise ValueError(f"{k}: expected {shape}, got {tuple(bp[k].shape)}")
    if tail is not None and (tuple(tail[0].shape) != (1, C, 7)
                             or tuple(tail[1].shape) != (1,)):
        raise ValueError("tail: expected weight (1, C, 7) and bias (1,)")
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"expected float32 tensors on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the MelGAN stage has no backward: run it under "
                                  "torch.no_grad() or torch.inference_mode()")


def melgan_resstack(x: torch.Tensor, blocks: Blocks, emit_lrelu: bool = False,
                    tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """(B, C, W) stage input -> (B, C, W) stage output (pre-activated with
    ``emit_lrelu``), or the (B, W) waveform with ``tail``."""
    _check(x, blocks, emit_lrelu, tail)
    if x.device.type == "cpu":
        return melgan_resstack_plain(x, blocks, emit_lrelu, tail)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, C, W = x.shape
    if C < 4 or C > 256 or 1024 % C:
        raise ValueError(f"the kernel takes C a power of two from 4 to 256, got {C}")
    x = x.contiguous()
    packed = pack_weights(blocks, tail)
    buf0, buf1 = torch.empty_like(x), torch.empty_like(x)
    out = torch.empty((B, W) if tail is not None else (B, C, W), device=x.device,
                      dtype=x.dtype)
    ptrs = [None if t is None else t.data_ptr() for t in packed]
    with torch.cuda.device(x.device):
        MELGAN_STACK_KERNEL(x.data_ptr(), *ptrs, buf0.data_ptr(), buf1.data_ptr(),
                            out.data_ptr(), B, C, W, int(emit_lrelu),
                            torch.cuda.current_stream().cuda_stream)
    return out
