"""Operand rounding for the reference's lower-precision controls.

The reference computes in float32 with TF32 off. Its control computes each
convolution from operands rounded to a lower precision, with float32
accumulation, which is what a TF32 or an fp8 tensor-core product does, in
the forward and in the backward:

- ``tf32``: inputs, weights and the incoming gradient rounded to 10
  explicit mantissa bits, to nearest even (the control of a float32
  configuration);
- ``fp8``: inputs and weights scaled per tensor so that the largest
  magnitude is 448 and rounded to float8 e4m3, the incoming gradient
  scaled to 57344 and rounded to float8 e5m2, each scaled back: the usual
  recipe of fp8 training (the control of a bfloat16 configuration).

The rounding is done in PyTorch, so that the control reads the same on the
CPU and on the card. ``q`` rounds an operand straight through: the forward
takes the rounded values and the gradient reaches the unrounded tensor
unchanged, so that a convolution's backward runs on its rounded operands.
``q_grad`` leaves its input alone and rounds the gradient that its
backward receives, the convolution's incoming gradient.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

MODES = (None, "tf32", "fp8")
_mode: Optional[str] = None


@contextlib.contextmanager
def operands(mode: Optional[str]):
    """Convolutions inside the block take operands rounded to ``mode``."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}: one of {MODES}")
    saved, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, ties to even."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 values through an fp8 format with one scale per tensor."""
    t = t.float()
    amax = t.abs().amax().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).float() / scale


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            g = round_tf32(g) if ctx.mode == "tf32" else round_fp8(g, torch.float8_e5m2)
        return g, None


def q(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the active mode rounds a convolution's operand."""
    if _mode is None:
        return t
    with torch.no_grad():
        r = round_tf32(t) if _mode == "tf32" else round_fp8(t)
    return t + (r - t).detach() if t.requires_grad else r


def q_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``, its gradient rounded as the active mode rounds a
    convolution's incoming gradient."""
    if _mode is None or not t.requires_grad:
        return t
    return _RoundGrad.apply(t, _mode)
