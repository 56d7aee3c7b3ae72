"""Device selection and matmul precision for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# --precision values, as the JAX CLI takes them (jax.lax.Precision names and
# aliases): true f32, or TF32 products on the tensor cores.
_F32 = ("highest", "float32")
_TF32 = ("high", "tensorfloat32", "default")


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch device for ``name`` ("cuda" or "cpu"), never a silent
    substitute: "cuda" without a usable GPU raises.

    Also turns TF32 off for matmuls and cuDNN convolutions, which PyTorch
    allows for convolutions by default: the port computes in true f32, as
    the JAX package it is checked against does.
    """
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: use 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available to PyTorch here; pass --device cpu to "
            "run on the CPU (slowly, through the kernels' plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def allows_tf32(precision: Optional[str]) -> bool:
    """Whether ``precision`` lets convolutions and matmuls use TF32; raises
    for a value that is not a precision. None keeps true f32, as every
    check of the port against the CPU and the JAX package needs (the JAX
    package's None means the backend's default, TF32 on a GPU)."""
    if precision is None or precision in _F32:
        return False
    if precision in _TF32:
        return True
    raise ValueError(f"unknown precision {precision!r}: use one of "
                     f"{', '.join(_F32 + _TF32)}")


@contextlib.contextmanager
def precision_scope(precision: Optional[str]):
    """TF32 on or off for cuDNN and cuBLAS inside the block, as
    ``precision`` says; the process-wide switches are restored after it."""
    allow = allows_tf32(precision)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
