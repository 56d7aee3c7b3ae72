"""Device selection, matmul precision and cuDNN's autotuner for the port's
entry points."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from maskcyclegan_vc_tpu_torch.obs import profiler

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


class ConvAutotune:
    """Whether ``autotune_scope`` is on, and the conv problems met inside
    it: (input shape, weight shape, stride, padding, dilation, dtype), each
    counted once into the profiler counter ``conv.autotuned``. On the card
    cuDNN times its candidate engines for each problem's forward, dgrad and
    wgrad the first time it meets them and keeps the winners in a plan
    cache of the process, which later calls look up whatever the flag then
    says; on the CPU nothing is timed. One per process, as that cache is."""

    def __init__(self):
        self.on = False
        self.problems = set()

    def note(self, x: torch.Tensor, weight: torch.Tensor, stride, padding, dilation) -> None:
        key = (tuple(x.shape), tuple(weight.shape), tuple(stride), tuple(padding),
               tuple(dilation), x.dtype)
        if key not in self.problems:
            self.problems.add(key)
            profiler.count("conv.autotuned")


CONV_AUTOTUNE = ConvAutotune()
# The engines cuDNN's autotuner times for a problem: its heuristics' first 5.
# At f32 1 x 64 on an H100 a replayed step took 45.3 ms on the heuristics'
# engines, 38.5-39.1 ms on the best of 10 (PyTorch's default), 39.0-39.2 on
# the best of 5 and 39.4-39.7 on the best of 3; the first step's timing took
# 2.0-4.8 s at 10 and 1.0-1.8 s at 5 (scripts/conv_sites.py, first-step
# probes). Every engine (0) gained nothing more at f32.
AUTOTUNE_ENGINES = 5


def autotunes(dtype: Optional[torch.dtype]) -> bool:
    """Whether a training step computing in ``dtype`` (None: f32) runs its
    convolutions on cuDNN's autotuned engines: f32 does, bf16 keeps the
    heuristics. cuDNN's f32 heuristics pick its legacy direct and FFT engines
    (``dgrad_engine``, ``gemm_cf32cf32``), which the autotuner replaces: an
    f32 1 x 64 step 17 % faster. Its bf16 heuristics already pick tensor-core
    engines: the autotuner made a 32 x 128 step 4 % faster and a 1 x 64 step
    no faster, while building every bf16 engine's plan (about 50 ms a pass,
    whatever the engine count) cost the first step 2-4.5 s at 32 x 128 and
    6-23 s at 1 x 64 (H100), where the set-up is bounded to a quarter."""
    return dtype in (None, torch.float32)


@contextlib.contextmanager
def cudnn_benchmark(on: bool):
    """``torch.backends.cudnn.benchmark`` set to ``on`` inside the block; the
    process-wide value is restored after it, exceptions included."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def _allocator_cache_kept():
    """PyTorch empties the CUDA allocator's cache after each cuDNN timing, so
    a training step's first run frees and reallocates its activations at
    every new conv problem: that took 7-17 s of the bf16 32 x 128 step where
    5 s do with the cache kept (H100). Kept inside the block, as PyTorch's
    own CUDA-graph trees keep it around their warm-up; a build without CUDA
    has no such switch."""
    get = getattr(torch._C, "_cuda_get_conv_benchmark_empty_cache", None)
    if get is None:
        yield
        return
    saved = get()
    torch._C._cudnn_set_conv_benchmark_empty_cache(False)
    try:
        yield
    finally:
        torch._C._cudnn_set_conv_benchmark_empty_cache(saved)


@contextlib.contextmanager
def autotune_scope(on: bool = True):
    """cuDNN's autotuner on (or off) inside the block, timing
    ``AUTOTUNE_ENGINES`` engines a problem, and its conv problems counted
    (``ConvAutotune``); all restored after it, exceptions included.

    The training steps run inside it: every conv problem of a run has the
    same shapes at every step, so each is timed once, in the run's first
    step, and its winner serves every later one. Conversion stays outside,
    on cuDNN's heuristics: it meets a new length with every utterance.
    Where the block met a new problem, the timings' workspaces, which the
    allocator kept cached through it, are returned to the device after it."""
    saved = CONV_AUTOTUNE.on, torch.backends.cudnn.benchmark_limit
    met = len(CONV_AUTOTUNE.problems)
    CONV_AUTOTUNE.on, torch.backends.cudnn.benchmark_limit = on, AUTOTUNE_ENGINES
    try:
        with cudnn_benchmark(on), _allocator_cache_kept():
            yield
    finally:
        CONV_AUTOTUNE.on, torch.backends.cudnn.benchmark_limit = saved
        if len(CONV_AUTOTUNE.problems) > met:
            torch.cuda.empty_cache()
