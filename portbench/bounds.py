"""Peaks, and the least time of each of the port's kernels at its call sites.

The arithmetic is copied at commit 05371c2 from ``chip_smoke.py``
(``bound_ms``, ``out_shape``, the ``flops_per_out`` of ``KERNELS``, the
operations of ``measure_resstack``); the call sites are those that
``chip_smoke.per_step`` counts, worked out from the published layer shapes
here. A kernel's bound is the larger of its bytes (each input read once,
each output written once) over the memory rate and its operations over
the compute rate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
# K9's f32 form takes each f32 product as three TF32 products (3xTF32),
# at 495 TFLOP/s dense TF32 (H100 SXM).
F32_3XTF32_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_FLOPS = {"float32": F32_FLOPS_PER_S, "bfloat16": BF16_FLOPS_PER_S}
ESIZE = {"float32": 4, "bfloat16": 2}

# Per output element: K1 2 x (sum 1 + centred square 3 + affine 2),
# sigmoid 4, product 1; K2 6; K3 10; K4 10; K5 z 2, sigmoid 4, dz 5, two
# sums 3, xhat 2, dx 4.
FLOPS_PER_OUT = {"in_glu": 17, "in": 6, "in_swish": 10, "ps_in_swish": 10,
                 "ps_in_swish_bwd": 20}
N_VECS = {"in_glu": 4, "in": 2, "in_swish": 2, "ps_in_swish": 2, "ps_in_swish_bwd": 2}

Site = Tuple[str, Tuple[int, ...]]


def out_shape(kernel: str, shape: tuple) -> tuple:
    if kernel == "in_glu":
        return (shape[0], shape[1] // 2) + shape[2:]
    if kernel == "ps_in_swish":
        return (shape[0], shape[1] // 4, 2 * shape[2], 2 * shape[3])
    return shape


def bound_s(kernel: str, shape: tuple, dtype: str) -> float:
    """The least seconds of one launch of ``kernel`` on an input of
    ``shape`` in ``dtype``: x, y, dy and dx at the dtype's element size,
    the vectors and statistics at 4 bytes; operations at the f32 rate (the
    bf16 entries compute in f32 too). The fused backward reads x and dy and
    writes dx, plus the per-sample statistics in and dscale, dbias out."""
    n_in = math.prod(shape)
    C = out_shape(kernel, shape)[1]
    esize = ESIZE[dtype]
    n_vecs = N_VECS[kernel]
    if kernel == "ps_in_swish_bwd":
        n_out, C = n_in, C // 4
        nbytes = esize * 3 * n_in + 4 * (n_vecs * C + 4 * shape[0] * C)
    else:
        n_out = math.prod(out_shape(kernel, shape))
        nbytes = esize * (n_in + n_out) + 4 * n_vecs * C
    flops = FLOPS_PER_OUT[kernel] * n_out
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def generator_sites(rows: int, n_mels: int, frames: int, R: int, blocks: int,
                    grad: bool) -> List[Site]:
    """The norm-kernel launches of one generator call on ``rows`` samples:
    K1 at both downsamples and each residual block's gate, K2 after the 2D
    to 1D conv, each residual block and the 1D to 2D conv, K4 at both
    upsamples, and with ``grad`` K5 at both upsamples."""
    t2 = -(-frames // 2)
    t4 = -(-t2 // 2)
    up = [(rows, 4 * R, n_mels // 4, t4), (rows, 2 * R, n_mels // 2, 2 * t4)]
    sites = [("in_glu", (rows, 2 * R, n_mels // 2, t2)), ("in_glu", (rows, 2 * R, n_mels // 4, t4))]
    sites += [("in_glu", (rows, 4 * R, t4))] * blocks
    sites += [("in", (rows, R, t4))] * (blocks + 1) + [("in", (rows, n_mels // 4 * R, t4))]
    sites += [("ps_in_swish", s) for s in up]
    if grad:
        sites += [("ps_in_swish_bwd", s) for s in up]
    return sites


def discriminator_sites(rows: int, n_mels: int, frames: int, R: int) -> List[Site]:
    """K3 at the discriminator's three downsamples."""
    out, m, t, c = [], n_mels, frames, R
    for _ in range(3):
        m, t = -(-m // 2), -(-t // 2)
        out.append(("in_swish", (rows, c, m, t)))
        c *= 2
    return out


def train_step_sites(rows: int, n_mels: int, frames: int, R: int, blocks: int,
                     paired: bool) -> List[Site]:
    """The K1-K5 launches of one training step with the identity loss on
    ``rows`` samples, as the port's step batches its forwards: with
    ``paired`` (a global batch under 16) same-parameter forwards as one
    call, else one call each."""
    b = rows
    if paired:
        g = [(2 * b, True), (3 * b, True), (b, True), (b, False), (2 * b, False), (b, False)]
        d = [b] * 4 + [2 * b] * 4
    else:
        g = [(b, True)] * 6 + [(b, False)] * 4
        d = [b] * 12
    sites = [s for n, grad in g for s in generator_sites(n, n_mels, frames, R, blocks, grad)]
    sites += [s for n in d for s in discriminator_sites(n, n_mels, frames, R)]
    return sites


def sites_bound_s(sites: List[Site], dtype: str) -> Dict[str, float]:
    """Summed bound seconds of ``sites`` by kernel."""
    out: Dict[str, float] = {}
    for k, shape in sites:
        out[k] = out.get(k, 0.0) + bound_s(k, shape, dtype)
    return out


def melgan_stage_bound_s(C: int, W: int, blocks: int, tail: bool, dtype: str) -> float:
    """One K9 call (``blocks`` ResnetBlocks of C channels over W positions,
    with the tail): operations at the 3xTF32 rate in f32 and the dense bf16
    rate in bf16; bytes of x, the output and the weights at the dtype's
    size, the biases at 4."""
    flops = W * (10 * blocks * C * C + (14 * C if tail else 0))
    n_w = blocks * 5 * C * C + (7 * C if tail else 0)
    n_b = blocks * 2 * C + (1 if tail else 0)
    n_out = W if tail else C * W
    nbytes = ESIZE[dtype] * (C * W + n_out + n_w) + 4 * n_b
    rate = F32_3XTF32_FLOPS_PER_S if dtype == "float32" else BF16_FLOPS_PER_S
    return max(flops / rate, nbytes / HBM_BYTES_PER_S)


def decode_bound_s(frames: int, vocoder: dict, dtype: str) -> float:
    """K9's least seconds over one decode of ``frames`` mel frames by the
    configuration's ``vocoder`` group: one call a stage, the last with the
    tail."""
    ratios = vocoder["ratios"]
    total, W, C = 0.0, frames, vocoder["ngf"] * 2 ** len(ratios)
    for i, r in enumerate(ratios):
        W, C = W * r, C // 2
        total += melgan_stage_bound_s(C, W, vocoder["n_residual_layers"],
                                      i == len(ratios) - 1, dtype)
    return total
