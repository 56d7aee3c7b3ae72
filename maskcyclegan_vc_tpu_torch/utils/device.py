"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


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
