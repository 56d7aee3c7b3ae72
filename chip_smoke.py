#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of the repository:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. env        torch and CUDA versions, the card's name and power limit.
2. build      nvcc builds every kernel source in csrc/, all at once.
3. preprocess the preprocess CLI (cli/preprocess.py main, --device cuda)
              over 2 speakers x 5 synthetic wavs of 2-6 s; K8's launch
              count (one per utterance), the output held against the same
              CLI on the CPU, and ms per utterance. Every CPU reference of
              the script runs on one intra-op thread (main says why).
4. convert    the conversion CLI (cli/test.py main, --device cuda) on a
              full-width generator with seeded random weights, written as a
              JAX-layout checkpoint, over 5 synthetic utterances; the launch
              counts of the run and K1's, K2's and K4's routes (every row
              bulk-copied into shared memory), the output held against the
              CPU plain path, and the per-utterance latency.
5. decode     the conversion CLI on the preprocessed speakers with a
              full-width melgan-neurips vocoder (seeded random weights saved
              as a state_dict) and --compute_mcd: 12 K9 calls per utterance
              (converted, original and target, 4 stages each); the card's
              waveforms against the CPU's and against the melgan-neurips
              module itself; mels of 1-4 frames against the CPU, each 4 K9
              calls (at 1 frame the first stage is W = 8 wide); decode
              latency per utterance, audio-seconds decoded per second, a
              profile; then the same CLI with --griffin_lim (16 iterations,
              on the host); then with a HiFi-GAN V1 checkpoint in
              jik876/hifi-gan's layout at the published widths (seeded
              random weights, weight-normed): 78 convolutions a decode and
              no K9 launch, the waveforms T x 256 samples; a 517-frame decode
              against the plain reference (portbench/reference/hifigan.py)
              on the card; its latency and a profile.
6. train      the train CLI (cli/train.py main, --device cuda, --scan_epochs
              1 by default: each step a CUDA-graph replay) at full width on
              two synthetic speakers, 2 epochs then resumed to 3, with
              --vocoder_ckpt and one plot (its 4 panels decoded: 16 K9
              calls); the launch counts of the run, a graph's counted at its
              capture times its replays; the same 3 epochs with
              --scan_epochs 0, its losses held against the graph run's; one
              step on the card held against the same step on the CPU (losses
              and Adam's first moments, the gradients' image); ms/step and
              audio-seconds trained per second at batch 1 x 64 and 32 x 128,
              a step at a time and as graph replays (with the device-busy
              share of each, and the replays' batches held bit for bit
              against the eager sampler's), each step's launch counts and
              K1's, K2's, K3's and K4's routes and those of K1-K3's backwards
              (all bulk-copied; a backward for each K1-K3 forward with grad,
              and no plain K1-K3 backward on the card), peak memory and a
              profiler breakdown.
7. train bf16 the same CLI run as 6 with --dtype bfloat16: launches per
              replayed step on the bf16 entries of K1-K5 only (the plot's
              two conversions stay f32), losses within 0.15 relative of 6's
              at every step, a checkpoint of f32 arrays that the conversion
              CLI reads on the card; then one epoch with --fused_norms 0,
              which launches no kernel. ms/step, audio-s/s, device-busy
              share and profile in bf16 at both sizes as in 6, and in f32
              with --precision tensorfloat32 (TF32 convolutions) at 1 x 64
              as graph replays and at 32 x 128 a step at a time.
8. long crops the train CLI at --num_frames 192 for one epoch, where each
              step's upSample2 backwards take the split route (K6, then
              eager PyTorch) and its upSample1 backwards K5, with the launch
              counts of the run; one step at 1 x 320, where both stages
              split: ms/step, its kernel sites, and at one upSample2 site the
              split route against K5 on the same (x, dy), both timed. In
              bf16, whose bytes are half, the CLI at --num_frames 320 for one
              epoch and one 1 x 320 step: upSample2 splits (bf16 K6) and
              upSample1 takes K5, as pixel_shuffle_in_swish_backward_bytes
              predicts. Every K6 launch of the CLI runs and of the 1 x 320
              steps takes the vector route (16-byte units).
9. eval decode the benchmark's config 5 (bench.py:81-107): one training step
              with with_eval_fake, then the MelGAN decode of its A->B
              conversion (fake_B_eval, no denormalization) by a full-width
              bf16 vocoder, in one function: in bf16 at 1 x 64 as CUDA-graph
              replays (one graph per identity variant, StepRunner's) and a
              step at a time, at 32 x 128 a step at a time, and in f32 at
              1 x 64 as graph replays (the f32 decode, as bench.py's f32
              run). ms per step+decode (median and spread), audio-s/s, the
              decode's share of the device time, launches per step+decode
              (bf16: 48/48/24/12/6 bf16 K1-K5 and 4 bf16 K9 calls, 13
              device launches), the waveform's finiteness and range, and
              every K9 call of one recorded step+decode against its plain
              version.
10. distributed the train CLI with --distributed on a world of this one card
              (NCCL; the script sets torchrun's environment), one epoch at
              1 x 64 with deterministic cuDNN, f32 and bf16 gradient wires,
              --scan_epochs 1 and 0: the plain run's launches per step, the
              f32 wire's losses equal to the plain run's (steps 1-3 within
              1e-5), the bf16 wire's within 1e-3, rank 0's checkpoint; bf16
              graph replays at 1 x 64 and 32 x 128 with and without the
              sync, in turns: ms/step, the NCCL kernels inside the replayed
              graph as the profiler sees them (3 a step), their device ms,
              the values and bytes on the wire; two gloo ranks sharing the
              card (``--gloo_worker``), eager, batch 2, against one process.
11. obs       obs/profiler.py and utils/debug.nan_debug_mode on the card:
              profiler.trace around 3 f32 1 x 64 steps of the published
              model, a step at a time (the trace's device events, K1-K5 by
              their kernels' names against the launch counts, a cuDNN
              convolution); profiler.timed_steps over 20 chained steps beside
              the step timing's median; one f32 and one bf16 step through the
              trainer under nan_debug_mode with --scan_epochs 1 (a step at a
              time inside the mode; every kernel launch's output checked);
              the mode's cost on a step; a K2 row of 3e38 (finite) whose
              overflowed statistics make NaN, named after the kernel's entry
              (in_forward), the plain version making NaN from it too; the
              norm of zeros, whose NaN is made in the CUDA backward.
12. pairwise  cli/launch_pairwise.py, benchmarks/pairwise_run.py's path with
              the port's modules: 3 synthetic speakers of 4 utterances
              (data/synth.py), preprocessed on the card (12 K8 launches);
              --dry_run for hosts 0 and 1 of 2 (disjoint, together the 3
              pairs); the launcher for host 0 of 1, one train CLI process a
              pair at the published width, 1 epoch each, with each job's wall
              time; each pair's checkpoint converted by the conversion CLI on
              the card (finite, of the input's shape, K1, K2 and K4 launched).
13. kernels   each kernel against its plain PyTorch version on the card, with
              its time, the plain version's, the library call's where one
              exists, and its bound: K1-K5 at every call site recorded in one
              431-frame conversion (unmasked and with the call's lengths) and
              in one training step at each size (unmasked and with lengths
              one frame short), the fused backward also against autograd, K1,
              K2, K3 and K4 with the route each site takes; K1-K3's backwards
              (in_backward_kernel) at every backward site of those steps
              against their plain formulas, with their routes, their bounds
              (x and dy read, dx written, the vectors and the (B, C)
              partials, over 3.35 TB/s) and launches a step; K6
              and K7 (exact, on the vector route) at every inverse-shuffle
              site of the 1 x 320 step; the bf16 entries of K1-K7 likewise at the sites of the
              bf16 steps; K8 on the audio of every bucket the preprocess
              phase ran (its DFT on 3xTF32 mma.sync: bound at 495 / 3
              TFLOP/s, the f32 cores' bound and the achieved TFLOP/s
              beside it); K9 on the four stage inputs of one real 431-frame
              decode, in f32 and with the bf16 vocoder in bf16. K9's f32
              form runs its products as 3xTF32 on the tensor cores: its
              bound is the flops at 495 / 3 TFLOP/s (the f32 cores' 67
              TFLOP/s bound printed beside it); its bf16 form runs bf16
              mma.sync products, bound at the dense bf16 rate (989
              TFLOP/s); both with the achieved TFLOP/s of each stage.

The last three lines are the kernels' JSON record, the card as nvidia-smi
names it, and {"ok": true, "device": {...}}. Working files go to
build/chip_smoke/ (listed in .gitignore).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.cli import launch_pairwise
from maskcyclegan_vc_tpu_torch.cli import preprocess as preprocess_cli
from maskcyclegan_vc_tpu_torch.cli.test import main as convert_main
from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.cli.train import main as train_main
from maskcyclegan_vc_tpu_torch.data.audio_io import read_wav, write_wav
from maskcyclegan_vc_tpu_torch.data.dataset import (
    MelBank,
    load_speaker,
    sample_batch,
    save_speaker,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.data.synth import DEFAULT_SPEAKERS, make_corpus
from maskcyclegan_vc_tpu_torch.io.checkpoint import save_checkpoint
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    generator_params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.models import hifigan, melgan
from maskcyclegan_vc_tpu_torch.models import vocoder as vocoder_mod
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.obs.logger import TrainLogger, to_host
from maskcyclegan_vc_tpu_torch.ops import cuda_lib, in_gate, melgan_stack, melspec, ps
from maskcyclegan_vc_tpu_torch.parallel.dist import finalize, initialize
from maskcyclegan_vc_tpu_torch.parallel.mesh import explicit_sync_fns, wire_bytes
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.schedules import identity_lambda
from maskcyclegan_vc_tpu_torch.train.step import (
    LOGGED_METRICS,
    METRICS,
    as_train_step,
    make_train_step,
    make_update,
)
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs
from maskcyclegan_vc_tpu_torch.utils import debug
from maskcyclegan_vc_tpu_torch.utils.device import precision_scope, resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
# K8 and K9's f32 form take each f32 product as three TF32 products on the
# tensor cores (3xTF32), at 495 TFLOP/s dense TF32 (H100 SXM).
F32_3XTF32_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
TOL = dict(atol=1e-5, rtol=1e-5)  # kernel vs plain, f32: reduction order only
# Kernel vs plain in bf16: both compute in f32 from the same bf16 inputs and
# round once, so they are at most one bf16 rounding apart (2**-7 of the
# value), atol 1e-5 for values that f32 cancellation leaves near 0. K5's dx
# two roundings (``k5_dx_bound``). f32 outputs (statistics, dscale, dbias)
# as in f32.
TOL_BF16 = dict(atol=1e-5, rtol=2 ** -7)
# bf16 losses against f32's on the same seed and steps: the bound of the JAX
# package's own bf16 pin (tests/test_bf16_dynamics.py).
BF16_LOSS_RTOL = 0.15
N_PARAMS = 24_537_729
N_PARAMS_D, N_PARAMS_D_LIVE = 16_691_713, 6_202_881
HOP, SAMPLE_RATE = 256, 22050
UTTERANCE_FRAMES = (173, 260, 345, 431, 517)  # 2-6 s, VCC2018-like
PER_FORWARD = {"in_glu": 8, "in": 8, "ps_in_swish": 2}
# One training step at batch 1 (pair_forwards on, identity on): 6 G
# forwards, 3 with grad, and 8 D forwards; at batch 32 (pair_forwards
# off): 10 G forwards, 6 with grad, and 12 D forwards. Each G forward with
# grad runs two upsample backwards (``per_step``).
G_FORWARDS = {1: (6, 3, 8), 32: (10, 6, 12)}  # G forwards, of them with grad, D forwards


def per_step(batch: int, frames: int, dtype=torch.float32) -> dict:
    """The launches of one training step at the published width, by entry.
    Each K1, K2 and K3 forward with grad (every discriminator forward, the
    generator forwards with grad) launches its backward once. Each
    upsample backward takes K5 where its stage's per-sample block is
    within the budget, else the split route (one K6), as
    ``pixel_shuffle_in_swish_backward_bytes`` decides at ``dtype``: in f32
    at 64 and 128 frames both stages take K5, at 192 upSample2 splits, at
    320 both split; in bf16, whose bytes are half, at 320 only upSample2."""
    n_g, n_grad, n_d = G_FORWARDS[batch]
    out = {"in_glu": 8 * n_g, "in": 8 * n_g, "in_swish": 3 * n_d, "ps_in_swish": 2 * n_g,
           # each K1, K2 and K3 launch that records a gradient: one backward
           "in_glu_bwd": 8 * n_grad, "in_bwd": 8 * n_grad, "in_swish_bwd": 3 * n_d}
    w2 = -(-(-(-frames // 2)) // 2)
    for shape in ((1, 1024, 20, w2), (1, 512, 40, 2 * w2)):  # upSample1, upSample2 inputs
        x = torch.empty(shape, dtype=dtype, device="meta")
        k = ("inv_shuffle" if ps.pixel_shuffle_in_swish_backward_bytes(x) > ps.BWD_BUDGET_BYTES
             else "ps_in_swish_bwd")
        out[k] = out.get(k, 0) + n_grad
    return entry_names(out, dtype)


def entry_name(kernel: str, dtype) -> str:
    """The KERNELS name of ``kernel``'s entry for ``dtype``: "in_bf16" for
    "in" in bf16."""
    return kernel + ("_bf16" if dtype == torch.bfloat16 else "")


def entry_names(launches: dict, dtype) -> dict:
    return {entry_name(k, dtype): n for k, n in launches.items()}


# The split route against K5 on the same (x, dy): each output within this
# fraction of its largest magnitude. The two take the statistics in another
# way (one-pass from x against the forward's two-pass) and sum in another
# order.
SPLIT_TOL = 1e-5
TRAIN_SPEAKER_UTTERANCES = 8
# Card vs CPU, per leaf of Adam's first moment after one step
# (phase_cross_step): G's gradients differ by summation order amplified by
# the chained norms (median 1.8e-5, worst 6.1e-4 measured on an H100); D's
# also see fakes from generators that already differ by the sign flips of
# near-zero gradients (median 6.8e-4, worst 1.6e-3). A faulty kernel or
# backward gives O(1).
MOMENT_BOUND = {"g": 5e-3, "d": 1e-2}
N_PARAMS_VOCODER = 4_260_257  # melgan-neurips at its defaults, weight norm folded
SPEAKERS = {"VCC2SF3": 220.0, "VCC2TF1": 330.0}
# K8 against its plain version, in log10 units (1.2e-4 relative in mel
# power): each bin's DFT sums 1024 windowed products and each mel 513
# magnitudes in f32, in another order than cuBLAS or the CPU's BLAS. The
# synthetic wavs carry broadband noise, so no bin sits near the 1e-5 floor,
# where log10 would amplify rounding without bound.
MEL_TOL = 5e-5
# K9 against its plain version: 1e-4 of the output's largest magnitude plus
# rtol 1e-4. A block sums up to 5C = 1280 f32 products per output in another
# order than cuDNN, and three blocks chain.
STAGE_TOL = 1e-4
# K9's bf16 form against its bf16 plain version: two bf16 roundings (2**-7
# each) of the output's largest magnitude. Both compute in f32 from the same
# bf16 values and round at the same points; a sum within f32 rounding of a
# bf16 tie rounds one ulp apart, and the later blocks spread that ulp.
STAGE_TOL_BF16 = 2 * 2 ** -7
# Waveforms in [-1, 1]: the card's decode against the CPU's and against the
# melgan-neurips module (weight norm applied by torch), max abs. Rounding
# through 4 up-convs and 12 blocks gives ~1e-6; a faulty stage gives O(0.01+).
WAV_TOL = 1e-4
# HiFi-GAN on the card against the plain reference on the card, both f32
# cuDNN with TF32 off: only the convolutions' algorithms and the order of
# the bias add and the MRF sum differ (sums of up to 512 x 7 products).
HIFIGAN_REL_TOL = 1e-5
GRIFFIN_LIM_ITERS = 16  # the CLI's default is 60; 16 keeps the host-side run short


@dataclasses.dataclass
class TrainState:
    """The JAX trainer's checkpoint root: its field gives the ``.g_params``
    key prefix of a checkpoint that trainer writes."""
    g_params: dict


@dataclasses.dataclass
class Site:
    kernel: str        # key of KERNELS
    shape: tuple       # kernel input
    lengths: tuple     # the call's lengths, or None for an unmasked call
    count: int         # calls in the recorded run


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def recording_sites():
    """Record every kernel launch made inside the block as a Site: the
    wrappers' launch points are wrapped for its duration, so the sites are
    the ones the real call graph produces. A site's kernel is the entry of
    its input's dtype ("in" or "in_bf16"). A plain K1-K3 backward on a
    CUDA tensor inside the block raises."""
    sites = {}

    def record(kernel, x, lengths):
        if x.device.type == "cuda":
            lens = None if lengths is None else tuple(lengths.tolist())
            key = (entry_name(kernel, x.dtype), tuple(x.shape), lens)
            sites.setdefault(key, Site(*key, 0)).count += 1

    launch_rows, forward, backward = (in_gate._launch_rows, ps._forward,
                                      ps.pixel_shuffle_in_swish_backward)
    launch_shuffle, launch_row_backward = ps._launch_shuffle, in_gate._launch_backward
    normalized = in_gate._normalized

    def rec_launch_rows(kernel, x, vecs, lengths, out_channels):
        record(kernel, x, lengths)
        return launch_rows(kernel, x, vecs, lengths, out_channels)

    def rec_launch_row_backward(kernel, x, dy, vecs):
        record(f"{kernel}_bwd", x, None)
        return launch_row_backward(kernel, x, dy, vecs)

    def rec_normalized(x):
        # The plain K1-K3 backwards start here: none may run on the card.
        if x.device.type == "cuda":
            raise AssertionError(f"a plain InstanceNorm backward ran on the card at "
                                 f"{tuple(x.shape)} {x.dtype}")
        return normalized(x)

    def rec_forward(x, scale, bias, lengths=None, stats=False):
        record("ps_in_swish", x, lengths)
        return forward(x, scale, bias, lengths, stats)

    def rec_backward(x, dy, *args):
        record("ps_in_swish_bwd", x, None)
        return backward(x, dy, *args)

    def rec_launch_shuffle(kernel, src):
        record(kernel, src, None)
        return launch_shuffle(kernel, src)

    in_gate._launch_rows, ps._forward = rec_launch_rows, rec_forward
    in_gate._launch_backward, in_gate._normalized = rec_launch_row_backward, rec_normalized
    ps.pixel_shuffle_in_swish_backward = rec_backward
    ps._launch_shuffle = rec_launch_shuffle
    try:
        yield sites
    finally:
        in_gate._launch_rows, ps._forward = launch_rows, forward
        in_gate._launch_backward, in_gate._normalized = launch_row_backward, normalized
        ps.pixel_shuffle_in_swish_backward = backward
        ps._launch_shuffle = launch_shuffle


def site_counts(sites) -> dict:
    counts = {}
    for s in sites.values():
        counts[s.kernel] = counts.get(s.kernel, 0) + s.count
    return counts


@contextlib.contextmanager
def graph_accounting():
    """Launches on the card while the block runs, CUDA-graph replays
    included. The wrappers count a launch when the host calls them: a
    capture counts each kernel of the step once though nothing runs, and a
    replay counts nothing. So each capture's counts are recorded and taken
    off, and added once for each replay of that graph. ``run_launches(acct)``
    gives the result after the block."""
    acct = {"captures": 0, "replays": 0, "at_capture": {}, "replayed": {}}
    per_graph = {}
    real_capture, real_replay = StepRunner.capture, StepRunner.replay

    def capture(self, *args):
        before = counts()
        out = real_capture(self, *args)
        delta = {k: n - before[k] for k, n in counts().items() if n != before[k]}
        per_graph[id(out[0])] = delta
        acct["captures"] += 1
        for k, n in delta.items():
            acct["at_capture"][k] = acct["at_capture"].get(k, 0) + n
        return out

    def replay(self, graph):
        real_replay(self, graph)
        acct["replays"] += 1
        for k, n in per_graph[id(graph)].items():
            acct["replayed"][k] = acct["replayed"].get(k, 0) + n

    StepRunner.capture, StepRunner.replay = capture, replay
    try:
        yield acct
    finally:
        StepRunner.capture, StepRunner.replay = real_capture, real_replay


def run_launches(acct) -> dict:
    """The counters, less what captures counted, plus what replays ran."""
    return {k: n - acct["at_capture"].get(k, 0) + acct["replayed"].get(k, 0)
            for k, n in counts().items()}


def accounting_line(acct) -> str:
    return (f"graph accounting: {acct['captures']} captures counted {acct['at_capture']} "
            f"(not run), {acct['replays']} replays ran {acct['replayed']}")


KERNELS = {
    "in_glu": dict(
        counter=in_gate.IN_GLU_KERNEL, fn=in_gate.instance_norm_glu,
        plain=in_gate.instance_norm_glu_plain, library=None, n_vecs=4,
        source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:127 (instance_norm_glu_fused :214)",
        # per output element: 2 x (sum 1 + centred square 3 + affine 2), sigmoid 4, product 1
        flops_per_out=17),
    "in": dict(
        counter=in_gate.IN_KERNEL, fn=in_gate.instance_norm,
        plain=in_gate.instance_norm_plain, n_vecs=2,
        # On bf16 x with the f32 vectors: batch norm's mixed-dtype form.
        library=lambda x, s, b: F.instance_norm(x, weight=s, bias=b, eps=1e-5),
        source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:127 (instance_norm_fused :152)",
        flops_per_out=6),
    "in_swish": dict(
        counter=in_gate.IN_SWISH_KERNEL, fn=in_gate.instance_norm_swish,
        plain=in_gate.instance_norm_swish_plain, library=None, n_vecs=2,
        source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:127 (instance_norm_swish_fused :181)",
        flops_per_out=10),
    "ps_in_swish": dict(
        counter=ps.PS_IN_SWISH_KERNEL, fn=ps.pixel_shuffle_in_swish,
        plain=ps.pixel_shuffle_in_swish_plain, library=None, n_vecs=2,
        source="maskcyclegan_vc_tpu_torch/csrc/ps_in_swish.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:344 (subpixel_in_swish :371)",
        flops_per_out=10),
    "ps_in_swish_bwd": dict(
        counter=ps.PS_IN_SWISH_BWD_KERNEL, fn=None, plain=None, library=None, n_vecs=2,
        source="maskcyclegan_vc_tpu_torch/csrc/ps_in_swish.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:259 (_sis_bwd_pallas, backward of subpixel_in_swish :386)",
        # per element: z 2, sigmoid 4, dz 5, two sums 3, xhat 2, dx 4
        flops_per_out=20),
    # K1's, K2's and K3's backwards (in_backward_kernel): the gradients at x
    # of the saved forward input, from dy. Per element of dx: statistics 4,
    # the sums 4, dx 5, and dz twice (K3: z 2, sigmoid 4, dz 5; K1 per
    # element of the pair: half of the gate's z 2, sigmoid 4, dz 6).
    "in_glu_bwd": dict(
        counter=in_gate.ENTRIES["in_glu_bwd"][torch.float32],
        fn=in_gate.instance_norm_glu_backward, plain=in_gate.instance_norm_glu_backward_plain,
        library=None, n_vecs=4, source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="no Pallas kernel: the custom_vjp backward of instance_norm_glu_fused "
                 "(maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:226-258, XLA)",
        flops_per_out=25),
    "in_bwd": dict(
        counter=in_gate.ENTRIES["in_bwd"][torch.float32],
        fn=in_gate.instance_norm_backward, plain=in_gate.instance_norm_backward_plain,
        library=None, n_vecs=2, source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="no Pallas kernel: the custom_vjp backward of instance_norm_fused "
                 "(maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:161-174, XLA)",
        flops_per_out=13),
    "in_swish_bwd": dict(
        counter=in_gate.ENTRIES["in_swish_bwd"][torch.float32],
        fn=in_gate.instance_norm_swish_backward,
        plain=in_gate.instance_norm_swish_backward_plain,
        library=None, n_vecs=2, source="maskcyclegan_vc_tpu_torch/csrc/in_gate.cu",
        replaces="no Pallas kernel: the custom_vjp backward of instance_norm_swish_fused "
                 "(maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:191-207, XLA)",
        flops_per_out=35),
    # The shuffles: measured by measure_shuffles, at the K6 sites.
    "inv_shuffle": dict(
        counter=ps.INV_SHUFFLE_KERNEL, fn=ps.inverse_pixel_shuffle,
        plain=ps.inverse_pixel_shuffle_plain, library=lambda t: F.pixel_unshuffle(t, 2),
        source="maskcyclegan_vc_tpu_torch/csrc/pixel_shuffle.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:164 (inverse_pixel_shuffle_q_major, body _inv_shuffle_kernel :116)"),
    "shuffle": dict(
        counter=ps.SHUFFLE_KERNEL, fn=ps.pixel_shuffle,
        plain=ps.pixel_shuffle_plain, library=lambda t: F.pixel_shuffle(t, 2),
        source="maskcyclegan_vc_tpu_torch/csrc/pixel_shuffle.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:138 (pixel_shuffle_q_major, body _ps_shuffle_only :150)"),
    # The audio path's kernels: measured by measure_log_mel / measure_resstack.
    "log_mel": dict(
        counter=melspec.LOG_MEL_KERNEL,
        source="maskcyclegan_vc_tpu_torch/csrc/melspec.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/melspec_kernel.py:116 (log_mel_spectrogram_pallas, body _melspec_kernel :60)"),
    "melgan_stack": dict(
        counter=melgan_stack.MELGAN_STACK_KERNEL,
        source="maskcyclegan_vc_tpu_torch/csrc/melgan_stack.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/melgan_stack_kernel.py:362 (melgan_resstack, body _stage_kernel :137)"),
}
# The bf16 entries (``--dtype bfloat16``): the same functions, plain
# versions, sources and TPU kernels, each entry with its own launch count.
for _name, _entries in (*in_gate.ENTRIES.items(), *ps.ENTRIES.items()):
    KERNELS[f"{_name}_bf16"] = dict(KERNELS[_name], counter=_entries[torch.bfloat16],
                                    dtype=torch.bfloat16)
KERNELS["melgan_stack_bf16"] = dict(KERNELS["melgan_stack"], dtype=torch.bfloat16,
                                   counter=melgan_stack.ENTRIES[torch.bfloat16])
NORM_KERNELS = ("in_glu", "in", "in_swish", "ps_in_swish", "ps_in_swish_bwd", "in_glu_bwd",
                "in_bwd", "in_swish_bwd")
ROW_BACKWARDS = ("in_glu_bwd", "in_bwd", "in_swish_bwd")


def dtype_of(kernel: str) -> torch.dtype:
    return KERNELS[kernel].get("dtype", torch.float32)


def base_name(kernel: str) -> str:
    return kernel.removesuffix("_bf16")


def out_shape(kernel: str, shape: tuple) -> tuple:
    if base_name(kernel) == "in_glu":
        return (shape[0], shape[1] // 2) + shape[2:]
    if base_name(kernel) == "ps_in_swish":
        return (shape[0], shape[1] // 4, 2 * shape[2], 2 * shape[3])
    return shape


def bound_ms(kernel: str, shape: tuple, n_vecs: int):
    """The least time for the work: each input read once, each output
    written once, over the memory rate; or the flops over the f32 rate (the
    bf16 entries compute in f32 too). x, y, dy and dx take the entry's
    element size (2 bytes in bf16), the vectors and statistics 4. The fused
    backward reads x and dy and writes dx (three tensors of x's size) plus
    the per-sample statistics in and dscale, dbias out; K1-K3's backwards
    read x and dy (K1's dy half x's size) and write dx, plus the vectors in
    and each row's dscale and dbias partials out."""
    n_in = int(np.prod(shape))
    C = out_shape(kernel, shape)[1]
    esize = torch.finfo(dtype_of(kernel)).bits // 8
    if base_name(kernel) == "ps_in_swish_bwd":
        n_out, C = n_in, C // 4
        nbytes = esize * 3 * n_in + 4 * (n_vecs * C + 4 * shape[0] * C)
    elif base_name(kernel) in ROW_BACKWARDS:
        # x and dy read, dx written; the vectors, and each row's dscale and
        # dbias partials written in f32.
        arrays = n_vecs // 2
        n_out, C = n_in, C // arrays
        nbytes = esize * (2 * n_in + n_in // arrays) + 4 * (n_vecs * C + 2 * arrays * shape[0] * C)
    else:
        n_out = int(np.prod(out_shape(kernel, shape)))
        nbytes = esize * (n_in + n_out) + 4 * n_vecs * C
    flops = KERNELS[kernel]["flops_per_out"] * n_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def call_ms(fn, reps: int = 50) -> float:
    """Mean time of back-to-back eager calls, CUDA events around the loop:
    the rate at which the host can issue them, or the device's time for
    them, whichever is slower."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed under CUDA events, so no host dispatch falls between them.
    The inputs stay in L2 from one call to the next, as a conv's output
    mostly is when the next layer reads it at batch 1 (at batch 32 they
    exceed L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _inputs(site: Site, device, gen):
    spec = KERNELS[site.kernel]
    C = out_shape(site.kernel, site.shape)[1]
    if base_name(site.kernel) == "ps_in_swish_bwd":
        C = site.shape[1] // 4
    elif base_name(site.kernel) in ROW_BACKWARDS:
        C = site.shape[1] // (spec["n_vecs"] // 2)
    x = (torch.randn(site.shape, device=device, generator=gen) * 2.0 + 0.5).to(
        dtype_of(site.kernel))
    vecs = []
    for i in range(spec["n_vecs"]):
        v = torch.rand(C, device=device, generator=gen)
        vecs.append(v + 0.5 if i % 2 == 0 else v * 2.0 - 1.0)
    return x, vecs


def site_lengths(site: Site, device) -> torch.Tensor:
    """The site's own lengths; for an unmasked site, one frame short of its
    time axis (for K4 the shuffled axis, 2W wide)."""
    if site.lengths is not None:
        return torch.tensor(site.lengths, dtype=torch.int32, device=device)
    full = site.shape[-1] * (2 if base_name(site.kernel) == "ps_in_swish" else 1)
    return torch.full((site.shape[0],), full - 1, dtype=torch.int32, device=device)


def check_forward(site: Site, x, vecs, device):
    """max abs err of the kernel against its plain version, unmasked and
    with the site's lengths; for K4 also its statistics output."""
    spec = KERNELS[site.kernel]
    lengths = site_lengths(site, device)
    err = 0.0
    tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL
    checks = [(spec["fn"](x, *vecs, lens), spec["plain"](x, *vecs, lens), f"lengths={lens}",
               tol, x.dtype) for lens in (None, lengths)]
    if base_name(site.kernel) == "ps_in_swish":
        _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, *vecs)
        want_mean, want_inv = ps.pixel_shuffle_stats_plain(x)
        checks += [(mean, want_mean, "mean", TOL, torch.float32),
                   (inv, want_inv, "inv", TOL, torch.float32)]
    for got, want, what, tol, dtype in checks:
        torch.cuda.synchronize()
        if not got.dtype == want.dtype == dtype:
            raise AssertionError(f"{site.kernel} {what}: {got.dtype} against {want.dtype}, "
                                 f"expected {dtype}")
        got, want = got.float(), want.float()
        e = (got - want).abs().max().item()
        if not torch.allclose(got, want, **tol):
            raise AssertionError(f"{site.kernel} at {site.shape} {what}: "
                                 f"max abs err {e:.3g} > {tol}")
        err = max(err, e)
    return err, lengths


def k5_dx_bound(x, dy, s, b, mean, inv, dx):
    """K5's dx in bf16, elementwise: 1e-5 + 2**-6 max(|dx|, |a dz|). Both
    sides round dz to bf16 before dx is computed from it (the value K5 parks
    in dx), and may round it to neighbouring values: that difference reaches
    dx times a = scale * inv, whatever the size of dx itself. In f32 the
    bound is TOL's."""
    if x.dtype != torch.bfloat16:
        return TOL["atol"] + TOL["rtol"] * dx.abs()
    B, C4, H, W = x.shape
    xs = x.float().reshape(B, C4 // 4, -1)
    a = s[None, :, None] * inv[..., None]
    z = xs * a + (b[None, :, None] - mean[..., None] * a)
    sg = torch.sigmoid(z)
    dys = F.pixel_unshuffle(dy.float(), 2).reshape(xs.shape)
    a_dz = (a * dys * (sg + z * sg * (1 - sg))).reshape(x.shape)
    return 1e-5 + 2 ** -6 * torch.maximum(dx.float().abs(), a_dz.abs())


def check_backward(site: Site, x, vecs, device, gen):
    """K5 against its plain version and against autograd through the plain
    forward. dx: atol = rtol = 1e-5 in f32, ``k5_dx_bound`` in bf16. dscale and dbias sum n = 4HW terms per
    (sample, channel) and again over the batch, in another order than the
    plain version (up to 10,240 terms at 128 frames): f32 summation error
    grows with the sum of the terms' magnitudes, so they are held to 1e-5
    of that sum (with 4|dy| standing for |dz * xhat|)."""
    s, b = vecs
    B, C4, H, W = site.shape
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device, generator=gen).to(x.dtype)
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    got = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    auto = torch.autograd.grad(ps.pixel_shuffle_in_swish_plain(xr, sr, br), (xr, sr, br), dy)
    torch.cuda.synchronize()
    bound = 4e-5 * F.pixel_unshuffle(dy.float(), 2).reshape(B, C4 // 4, -1).abs().sum((0, 2))
    err, worst = 0.0, 0.0
    for ref, what in ((want, "plain"), (auto, "autograd")):
        if got[0].dtype != x.dtype or ref[0].dtype != x.dtype:
            raise AssertionError(f"K5 dx {got[0].dtype}, {what} {ref[0].dtype}, x {x.dtype}")
        diff = (got[0].float() - ref[0].float()).abs()
        e = diff.max().item()
        if (diff > k5_dx_bound(x, dy, s, b, mean, inv, ref[0])).any():
            raise AssertionError(f"K5 dx at {site.shape} {x.dtype} vs {what}: "
                                 f"max abs err {e:.3g} past its bound")
        err = max(err, e)
        for i in (1, 2):
            ratio = ((got[i] - ref[i]).abs() / bound).max().item()
            if ratio > 1.0:
                raise AssertionError(f"K5 d{'scale' if i == 1 else 'bias'} at {site.shape} "
                                     f"vs {what}: {ratio:.3g} of the summation bound")
            worst = max(worst, ratio)
    return err, worst, (x, dy, s, b, mean, inv)


def row_backward_bound(kernel: str, x, dy, vecs) -> list:
    """1e-5 of sum |dz| (1 + |xhat|) per channel, for each (dscale, dbias)
    output of K1's, K2's or K3's backward: each row's sums leave the
    kernel as partials summed again over the batch, in another order than
    the plain formulas'."""
    arrays = len(vecs) // 2
    xs = x.float().reshape(x.shape[0], x.shape[1], -1)
    hat = (xs - xs.mean(-1, keepdim=True)) * torch.rsqrt(
        xs.var(-1, unbiased=False, keepdim=True) + 1e-5)
    d = dy.float().reshape(dy.shape[0], dy.shape[1], -1)
    hats = hat.split(d.shape[1], dim=1)
    z = [hats[a] * vecs[2 * a][:, None] + vecs[2 * a + 1][:, None] for a in range(arrays)]
    if base_name(kernel) == "in_bwd":
        dz = [d]
    elif base_name(kernel) == "in_swish_bwd":
        sg = torch.sigmoid(z[0])
        dz = [d * (sg + z[0] * sg * (1 - sg))]
    else:
        sg = torch.sigmoid(z[1])
        dz = [d * sg, d * z[0] * sg * (1 - sg)]
    return [1e-5 * (dz[a].abs() * (1 + hats[a].abs())).sum((0, 2)) for a in range(arrays)
            for _ in range(2)]


def check_row_backward(site: Site, x, vecs, device, gen):
    """K1's, K2's or K3's backward against its plain formulas on a seeded
    dy: dx at TOL in f32, one bf16 rounding in bf16; dscale and dbias
    within ``row_backward_bound``. Returns the worst dx error, the worst
    share of the summation bound and the call's arguments."""
    spec = KERNELS[site.kernel]
    C = x.shape[1] // (spec["n_vecs"] // 2)
    dy = torch.randn((x.shape[0], C) + x.shape[2:], device=device, generator=gen).to(x.dtype)
    got = spec["fn"](x, dy, *vecs)
    want = spec["plain"](x, dy, *vecs)
    torch.cuda.synchronize()
    tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL
    if got[0].dtype != x.dtype or want[0].dtype != x.dtype:
        raise AssertionError(f"{site.kernel} dx {got[0].dtype}, plain {want[0].dtype}")
    err = (got[0].float() - want[0].float()).abs().max().item()
    if not torch.allclose(got[0].float(), want[0].float(), **tol):
        raise AssertionError(f"{site.kernel} dx at {site.shape}: max abs err {err:.3g} > {tol}")
    worst = 0.0
    for g, w, bound in zip(got[1:], want[1:], row_backward_bound(site.kernel, x, dy, vecs)):
        ratio = ((g - w).abs() / bound).max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"{site.kernel} dscale/dbias at {site.shape}: {ratio:.3g} of "
                                 f"the summation bound")
        worst = max(worst, ratio)
    return err, worst, (x, dy, *vecs)


def measure_sites(sites, device, label: str):
    """Check and time every recorded site; returns per-kernel sums (each
    site's time times its count)."""
    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
    for site in sites.values():
        spec = KERNELS[site.kernel]
        x, vecs = _inputs(site, device, gen)
        extra, ms_masked = "", None
        reps = 20 if x.numel() < (1 << 22) else 5  # bounds the graphs' memory
        if base_name(site.kernel) == "ps_in_swish_bwd":
            err, ratio, args = check_backward(site, x, vecs, device, gen)
            ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward(*args), reps)
            plain_ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward_plain(*args), reps)
            eager_ms = call_ms(lambda: ps.pixel_shuffle_in_swish_backward(*args))
            lib_ms = None
            extra = f"dscale/dbias at {ratio:.3g} of their summation bound "
        elif base_name(site.kernel) in ROW_BACKWARDS:
            before = route_counts()
            err, ratio, args = check_row_backward(site, x, vecs, device, gen)
            taken = sorted({k.split("/")[1] for k, n in route_counts().items()
                            if k.split("/")[0] == site.kernel and n > before.get(k, 0)})
            ms = device_ms(lambda: spec["fn"](*args), reps)
            plain_ms = device_ms(lambda: spec["plain"](*args), reps)
            eager_ms = call_ms(lambda: spec["fn"](*args))
            lib_ms = None
            extra = f"dscale/dbias at {ratio:.3g} of their summation bound "
        else:
            before = route_counts()
            err, lengths = check_forward(site, x, vecs, device)
            taken = sorted({k.split("/")[1] for k, n in route_counts().items()
                            if n > before.get(k, 0)})
            ms = device_ms(lambda: spec["fn"](x, *vecs), reps)
            ms_masked = device_ms(lambda: spec["fn"](x, *vecs, lengths), reps)
            plain_ms = device_ms(lambda: spec["plain"](x, *vecs), reps)
            lib_ms = (device_ms(lambda: spec["library"](x, *vecs), reps)
                      if spec["library"] else None)
            eager_ms = call_ms(lambda: spec["fn"](x, *vecs))
        b_ms, bound_by = bound_ms(site.kernel, site.shape, spec["n_vecs"])
        masked = "" if site.lengths is None else f"lengths {list(site.lengths)} "
        if base_name(site.kernel) in ROUTED:
            masked += f"route {' '.join(taken)} "
        tol = ("atol=rtol=1e-5" if x.dtype == torch.float32 else
               "two bf16 roundings" if base_name(site.kernel) == "ps_in_swish_bwd"
               else "one bf16 rounding")
        print(f"kernels: {label} {site.kernel:20s} in {str(site.shape):22s} {masked}"
              f"x{site.count} max_abs_err {err:.3g} (tol {tol}) {extra}"
              f"ms {ms:.5f} "
              + ("" if ms_masked is None else f"masked_ms {ms_masked:.5f} ")
              + f"eager_call_ms {eager_ms:.5f} plain_ms {plain_ms:.5f} "
              f"library_ms {'null' if lib_ms is None else f'{lib_ms:.5f}'} "
              f"bound_us {1e3 * b_ms:.3f} ({bound_by})", flush=True)
        r = records.setdefault(site.kernel, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                                 library_ms=0.0, max_abs_err=0.0,
                                                 launches=0))
        r["ms"] += site.count * ms
        r["plain_ms"] += site.count * plain_ms
        r["bound_ms"] += site.count * b_ms
        r["bound_by"] = bound_by
        r["library_ms"] = None if lib_ms is None else r["library_ms"] + site.count * lib_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["launches"] += site.count
        del x, vecs
    for k, r in records.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        print(f"kernels: {label} {k} sum: {r['launches']} launches ms {r['ms']:.5f} "
              f"plain_ms {r['plain_ms']:.5f} library_ms {lib} "
              f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return records


def phase_convert(device):
    pre, ckpts, save = (os.path.join(WORK, d) for d in ("pre", "ckpts", "results"))

    gen = Generator(generator=torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in gen.parameters())
    if n != N_PARAMS:
        raise AssertionError(f"generator has {n} parameters, expected {N_PARAMS}")
    sd = gen.state_dict()
    save_checkpoint(os.path.join(ckpts, "00001_state.npz"),
                    TrainState(g_params={"A2B": generator_params_to_jax(sd)}))
    rs = np.random.RandomState(0)
    mels = {}
    for sid in ("VCC2SF3", "VCC2TF1"):
        mels[sid] = [rs.randn(80, t).astype(np.float32) for t in UTTERANCE_FRAMES]
        save_speaker(pre, sid, mels[sid], rs.randn(80, 1).astype(np.float32),
                     (rs.rand(80, 1) + 0.5).astype(np.float32))

    reset_counts()
    convert_main(["--name", "smoke", "--save_dir", save, "--preprocessed_data_dir", pre,
                  "--ckpt_dir", ckpts, "--load_epoch", "1",
                  "--model_name", "generator_A2B", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k: KERNELS[k]["counter"].launches for k in PER_FORWARD}
    n_utt = len(UTTERANCE_FRAMES)
    want_launches = {k: PER_FORWARD[k] * n_utt for k in PER_FORWARD}
    routes, want_routes = route_counts(), main_routes(want_launches)
    print(f"convert: launches {launches} (expected {want_launches}); routes {routes} "
          f"(expected {want_routes})", flush=True)
    if launches != want_launches or routes != want_routes:
        raise AssertionError("the conversion did not run every kernel as expected")

    out_dir = os.path.join(save, "smoke", "converted_audio_1")
    outs = []
    for i, t in enumerate(UTTERANCE_FRAMES):
        y = np.load(os.path.join(out_dir, f"{i}-converted_VCC2SF3_to_VCC2TF1.npy"))
        if y.shape != (80, t) or not np.isfinite(y).all():
            raise AssertionError(f"utterance {i}: shape {y.shape}, finite {np.isfinite(y).all()}")
        outs.append(y)

    # The card's output against the CPU plain path on the same weights. At
    # random init ~20 chained norm layers amplify the rounding differences
    # of two conv libraries, so the bound is on the relative mean error
    # (the CPU tests see ~2.5e-6 against JAX at full width); a kernel fault
    # gives errors of order 1.
    i431 = UTTERANCE_FRAMES.index(431)
    gen.eval()
    ref = make_convert_fn(gen)(mels["VCC2SF3"][i431])
    diff = np.abs(outs[i431] - ref)
    rel = diff.mean() / np.abs(ref).mean()
    print(f"convert: 431-frame utterance, card vs CPU plain path: relative mean "
          f"error {rel:.3g} (bound 1e-3), max abs error {diff.max():.3g} (bound 1e-2)",
          flush=True)
    if not (rel < 1e-3 and diff.max() < 1e-2):
        raise AssertionError("the card's conversion disagrees with the CPU's")

    gpu = Generator(device=device)
    gpu.load_state_dict(sd, strict=True)
    convert = make_convert_fn(gpu.eval())
    for mel in mels["VCC2SF3"]:  # warm-up: one pass over every bucket
        convert(mel)
    lat = []
    for mel in mels["VCC2SF3"]:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            convert(mel)  # returns host numpy, so the device work is done
            runs.append(time.perf_counter() - t0)
        lat.append(float(np.median(runs)))
    audio_s = [t * HOP / SAMPLE_RATE for t in UTTERANCE_FRAMES]
    for t, a, l in zip(UTTERANCE_FRAMES, audio_s, lat):
        print(f"convert: {t} frames ({a:.3f} s audio): {1e3 * l:.3f} ms per utterance "
              f"(median of 5, host clock, H2D and D2H included)", flush=True)
    print(f"convert: {sum(audio_s) / sum(lat):.1f} audio-s/s over the 5 utterances",
          flush=True)
    profile(lambda: convert(mels["VCC2SF3"][i431]), lat[i431],
            f"{UTTERANCE_FRAMES[i431]}-frame conversion")
    reset_counts()
    with recording_sites() as sites:
        convert(mels["VCC2SF3"][i431])
    routes = route_counts()
    if site_counts(sites) != PER_FORWARD or routes != main_routes(PER_FORWARD):
        raise AssertionError(f"one conversion launched {site_counts(sites)}, routes {routes}")
    print(f"convert: one {UTTERANCE_FRAMES[i431]}-frame conversion: routes {routes}", flush=True)
    return sites, routes


# cuDNN's and cuBLAS's convolution and GEMM kernels, by name.
CONV_KERNELS = r"conv|xmma|gemm|cudnn|wgrad|dgrad|fprop|winograd|implicit"


def profile(fn, wall_s: float, what: str):
    """Where one call's time goes: device time by kernel from torch.profiler,
    grouped, against the unprofiled wall time. Returns the device-busy ms,
    or None where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # A user annotation (Optimizer.step#Adam.step) spans its kernels on
        # the device timeline; counting it would count them twice.
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.key, e.count, us if us is not None else e.self_cuda_time_total))
    busy_us = sum(r[2] for r in rows)
    if busy_us == 0:
        print(f"profile: {what}: the profiler recorded no device time: not measured")
        return None
    groups = {
        "the port's kernels": "|".join(profiler.KERNEL_NAMES.values()),
        "convolutions (cuDNN)": CONV_KERNELS,
        "Adam (foreach)": r"multi_tensor_apply|foreach",
        "collectives (NCCL)": COLLECTIVE_KERNELS,
    }
    sums = {g: [0.0, 0] for g in groups}
    sums["other (losses, casts, copies, elementwise)"] = [0.0, 0]
    for key, count, us in rows:
        g = next((g for g, pat in groups.items() if re.search(pat, key)),
                 "other (losses, casts, copies, elementwise)")
        sums[g][0] += us
        sums[g][1] += count
    print(f"profile: {what}: device busy {busy_us / 1e3:.3f} ms of {1e3 * wall_s:.3f} ms "
          f"wall ({100 * busy_us / 1e3 / (1e3 * wall_s):.1f} %), "
          f"{sum(r[1] for r in rows)} device ops", flush=True)
    for g, (us, count) in sums.items():
        print(f"profile:   {g}: {us / 1e3:.3f} ms ({100 * us / busy_us:.1f} % of busy) "
              f"in {count} launches")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"profile:   {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return busy_us / 1e3


# ---------------------------------------------------------------------------
# The audio path: preprocessing (K8) and decoding (K9)
# ---------------------------------------------------------------------------

# The kernels whose C entry reports a route (K1, K2, K3 and their
# backwards, K4, K6, K7), and their route counters by dtype. K5 has one
# route: its launches are its count. MAIN_ROUTE: the route every main-path
# launch must take (K6 and K7: 16-byte units, "vector"; the others: "bulk").
ROUTED = {**in_gate.ROUTES, "ps_in_swish": ps.ROUTES,
          "inv_shuffle": ps.SHUFFLE_ROUTES["inv_shuffle"],
          "shuffle": ps.SHUFFLE_ROUTES["shuffle"]}
MAIN_ROUTE = {"inv_shuffle": "vector", "shuffle": "vector"}


def reset_counts() -> None:
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    for by_dtype in ROUTED.values():
        for routes in by_dtype.values():
            for r in routes:
                routes[r] = 0


def route_counts() -> dict:
    """K1's, K2's, K3's, K4's, K6's and K7's launches since the counts were
    reset by the route they took, those taken at all ("in_glu/bulk",
    "ps_in_swish_bf16/stream", "inv_shuffle/vector")."""
    return {f"{entry_name(k, dtype)}/{r}": n for k, by_dtype in ROUTED.items()
            for dtype, routes in by_dtype.items() for r, n in routes.items() if n}


def main_routes(launches: dict) -> dict:
    """The route counts of a run that launched ``launches``: every K1, K2,
    K3 and K4 launch with its rows bulk-copied into shared memory, every K6
    and K7 launch on 16-byte units."""
    return {f"{k}/{MAIN_ROUTE.get(base_name(k), 'bulk')}": n for k, n in launches.items()
            if base_name(k) in ROUTED and n}


def check_shuffle_routes(what: str) -> dict:
    """Every K6 and K7 launch since the counts were reset, a CUDA graph's
    capture included (its replays repeat what it captured), took the
    vector route. Returns the counts."""
    shuffles = {k: n for k, n in counts().items()
                if base_name(k) in ("inv_shuffle", "shuffle") and n}
    routes = {r: n for r, n in route_counts().items()
              if base_name(r.split("/")[0]) in ("inv_shuffle", "shuffle")}
    print(f"{what}: K6/K7 launches by route {routes} (expected {main_routes(shuffles)})",
          flush=True)
    if not shuffles or routes != main_routes(shuffles):
        raise AssertionError(f"{what}: a K6 or K7 launch left the vector route: {routes}")
    return routes


def counts() -> dict:
    return {k: spec["counter"].launches for k, spec in KERNELS.items()}


@contextlib.contextmanager
def capturing(module, name: str):
    """Record every call of ``module.name`` made inside the block (args and
    kwargs, tensors cloned), passing it through unchanged."""
    real, calls = getattr(module, name), []

    def spy(*args, **kwargs):
        def keep(v):
            return v.clone() if isinstance(v, torch.Tensor) else v
        calls.append(([keep(a) for a in args], {k: keep(v) for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def synthetic_wav(frames: int, f0: float, rs) -> np.ndarray:
    """frames * 256 samples (so frames mel frames): a tone plus broadband
    noise whose level moves, so every mel bin carries energy."""
    t = np.arange(frames * HOP) / SAMPLE_RATE
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(6 * np.pi * t))
         + 0.25 * rs.randn(t.size) * (0.1 + np.abs(np.sin(2 * np.pi * 1.7 * t))))
    return x.astype(np.float32)


def phase_preprocess(device):
    """Audio in: the preprocess CLI on the card over 2 speakers x 5 wavs;
    K8 once per utterance; the same CLI on the CPU as the reference."""
    wavs, pre, pre_cpu = (os.path.join(WORK, d) for d in ("wavs", "audio_pre", "audio_pre_cpu"))
    rs = np.random.RandomState(2)
    for sid, f0 in SPEAKERS.items():
        os.makedirs(os.path.join(wavs, sid), exist_ok=True)
        for i, t in enumerate(UTTERANCE_FRAMES):
            write_wav(os.path.join(wavs, sid, f"{i:03d}.wav"), synthetic_wav(t, f0 + 7 * i, rs),
                      SAMPLE_RATE)
    args = ["--data_directory", wavs, "--speaker_ids", *SPEAKERS]
    reset_counts()
    with capturing(preprocess_cli, "log_mel_spectrogram_fused") as calls:
        t0 = time.perf_counter()
        preprocess_cli.main(args + ["--preprocessed_data_directory", pre, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    n_utt = len(SPEAKERS) * len(UTTERANCE_FRAMES)
    print(f"preprocess: CLI on the card {wall:.2f} s (wav reads and writes included); "
          f"launches {launches} (expected log_mel {n_utt}: one per utterance)", flush=True)
    if launches["log_mel"] != n_utt or sum(launches.values()) != n_utt:
        raise AssertionError("the preprocess run did not launch K8 once per utterance")

    preprocess_cli.main(args + ["--preprocessed_data_directory", pre_cpu, "--device", "cpu"])
    worst, worst_norm = 0.0, 0.0
    for sid in SPEAKERS:
        mels, mean, std = load_speaker(pre, sid)
        ref, rmean, rstd = load_speaker(pre_cpu, sid)
        if [m.shape for m in mels] != [(80, t) for t in UTTERANCE_FRAMES]:
            raise AssertionError(f"{sid}: shapes {[m.shape for m in mels]}")
        for m, r in zip(mels, ref):
            if not np.isfinite(m).all():
                raise AssertionError(f"{sid}: non-finite mels")
            worst = max(worst, float(np.abs((m * std + mean) - (r * rstd + rmean)).max()))
            worst_norm = max(worst_norm, float(np.abs(m - r).max()))
    print(f"preprocess: card vs CPU CLI: log-mel max abs error {worst:.3g} log10 units "
          f"(bound {MEL_TOL:g}); normalized mels {worst_norm:.3g}", flush=True)
    if worst > MEL_TOL:
        raise AssertionError("the card's preprocessing disagrees with the CPU's")

    mel_fn = preprocess_cli.make_mel_fn(device)
    audio = [synthetic_wav(t, 220.0, np.random.RandomState(t)) for t in UTTERANCE_FRAMES]
    for a in audio:  # warm-up, every bucket
        mel_fn(a)
    lat = []
    for a in audio:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            mel_fn(a)  # returns host numpy: the device work is done
            runs.append(time.perf_counter() - t0)
        lat.append(float(np.median(runs)))
    for t, l in zip(UTTERANCE_FRAMES, lat):
        print(f"preprocess: {t} frames: {1e3 * l:.3f} ms per utterance (median of 5, host "
              f"clock, host pad, H2D and D2H included)", flush=True)
    print(f"preprocess: {1e3 * float(np.mean(lat)):.3f} ms per utterance on average over "
          f"the 5 lengths", flush=True)
    return pre, launches["log_mel"], [c[0][0] for c in calls]


class NeuripsResnetBlock(torch.nn.Module):
    """melgan-neurips's ResnetBlock, its checkpoint's names."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        nn, weight_norm = torch.nn, torch.nn.utils.weight_norm
        self.block = nn.Sequential(nn.LeakyReLU(0.2), nn.ReflectionPad1d(dilation),
                                   weight_norm(nn.Conv1d(dim, dim, 3, dilation=dilation)),
                                   nn.LeakyReLU(0.2), weight_norm(nn.Conv1d(dim, dim, 1)))
        self.shortcut = weight_norm(nn.Conv1d(dim, dim, 1))

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


def neurips_vocoder(seed: int, gain: float = 1.5):
    """The melgan-neurips generator module (one nn.Sequential of weight-normed
    convs, the graph its torch.hub checkpoint holds) with random weights:
    torch's default init with every weight_g scaled by ``gain``, so a decode
    of normalized mels neither fades to a constant nor saturates the tanh."""
    nn, weight_norm = torch.nn, torch.nn.utils.weight_norm
    torch.manual_seed(seed)
    mult, ngf = 16, 32
    layers = [nn.ReflectionPad1d(3), weight_norm(nn.Conv1d(80, mult * ngf, 7))]
    for r in melgan.RATIOS:
        layers += [nn.LeakyReLU(0.2), weight_norm(nn.ConvTranspose1d(
            mult * ngf, mult * ngf // 2, 2 * r, stride=r, padding=r // 2 + r % 2,
            output_padding=r % 2))]
        layers += [NeuripsResnetBlock(mult * ngf // 2, 3 ** j) for j in range(3)]
        mult //= 2
    layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3), weight_norm(nn.Conv1d(ngf, 1, 7)),
               nn.Tanh()]
    model = nn.Sequential(*layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(gain)
    return model.eval()


def _run_cli(fn, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


def phase_decode(device, pre: str, ckpts: str):
    """Audio out: conversion with --vocoder_ckpt and --compute_mcd on the
    preprocessed speakers, then with --griffin_lim."""
    ref = neurips_vocoder(0)
    voc_path = os.path.join(WORK, "vocoder.pt")
    torch.save({f"model.{k}": v for k, v in ref.state_dict().items()}, voc_path)
    save = os.path.join(WORK, "decode_results")
    common = ["--save_dir", save, "--preprocessed_data_dir", pre, "--ckpt_dir", ckpts,
              "--load_epoch", "1", "--model_name", "generator_A2B", "--device", "cuda",
              "--compute_mcd"]
    n_utt = len(UTTERANCE_FRAMES)

    reset_counts()
    t0 = time.perf_counter()
    text = _run_cli(convert_main, ["--name", "vocoder", "--vocoder_ckpt", voc_path] + common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = {k: PER_FORWARD.get(k, 0) * n_utt for k in KERNELS}
    want["melgan_stack"] = 12 * n_utt
    lines = [ln for ln in text.splitlines() if ln.startswith(("wrote", "MCD", "F0"))]
    for ln in lines:
        print(f"decode: CLI: {ln}", flush=True)
    print(f"decode: CLI --vocoder_ckpt --compute_mcd on the card {wall:.2f} s; launches "
          f"{launches} (expected {want}: melgan_stack 12 per utterance)", flush=True)
    if launches != want:
        raise AssertionError("the decode run did not launch K9 12 times per utterance")
    if len(lines) != 4:
        raise AssertionError(f"the CLI printed {lines}")
    out_dir = os.path.join(save, "vocoder", "converted_audio_1")
    for i, t in enumerate(UTTERANCE_FRAMES):
        for kind in ("converted", "original"):
            wav, sr = read_wav(os.path.join(out_dir, f"{i}-{kind}_VCC2SF3_to_VCC2TF1.wav"))
            if wav.shape != (t * HOP,) or sr != SAMPLE_RATE or not np.isfinite(wav).all():
                raise AssertionError(f"{i}-{kind}: {wav.shape} at {sr} Hz")

    # The vocoder on the card against the CPU plain path and against the
    # melgan-neurips module itself, on the target's 431-frame utterance.
    vocoder = vocoder_mod.load_vocoder(voc_path, device)
    n = sum(p.numel() for p in vocoder.parameters())
    mels, mean, std = load_speaker(pre, "VCC2TF1")
    i431 = UTTERANCE_FRAMES.index(431)
    mel = mels[i431]
    got = melgan.decode_mel(vocoder, mel[None], mean, std)[0].cpu().numpy()
    cpu = melgan.decode_mel(vocoder_mod.load_vocoder(voc_path, "cpu"), mel[None], mean, std)[0].numpy()
    with torch.no_grad():
        module = ref.to(device)(torch.from_numpy(mel * std + mean)[None].to(device))
    module = module[0, 0].cpu().numpy()
    e_cpu, e_mod = float(np.abs(got - cpu).max()), float(np.abs(got - module).max())
    print(f"decode: vocoder {n:,} parameters (expected {N_PARAMS_VOCODER:,}); 431 frames -> "
          f"{got.size} samples, std {got.std():.4f}, peak {np.abs(got).max():.4f}; card vs "
          f"CPU plain path max abs error {e_cpu:.3g}, card vs the melgan-neurips module "
          f"{e_mod:.3g} (bound {WAV_TOL:g})", flush=True)
    if n != N_PARAMS_VOCODER or got.shape != (431 * HOP,) or max(e_cpu, e_mod) > WAV_TOL:
        raise AssertionError("the card's decode disagrees with its references")
    # Mels of 1-4 frames: at 1 frame the first stage (W = 8) is narrower
    # than its pad of 9, and K9 reflects the halo again, as jnp.pad does.
    cpu_vocoder = vocoder_mod.load_vocoder(voc_path, "cpu")
    for t in range(1, 5):
        reset_counts()
        short = melgan.decode_mel(vocoder, mel[None, :, :t], mean, std)[0].cpu().numpy()
        k9 = KERNELS["melgan_stack"]["counter"].launches
        e = float(np.abs(short - melgan.decode_mel(cpu_vocoder, mel[None, :, :t], mean,
                                                   std)[0].numpy()).max())
        print(f"decode: a {t}-frame mel -> {short.size} samples, card vs CPU max abs error "
              f"{e:.3g} (bound {WAV_TOL:g}); K9 calls {k9} (expected 4)", flush=True)
        if short.shape != (t * HOP,) or e > WAV_TOL or k9 != 4:
            raise AssertionError(f"the card's {t}-frame decode went wrong")

    src = load_speaker(pre, "VCC2SF3")
    for m in src[0]:  # warm-up, every length
        melgan.decode_mel(vocoder, m[None], src[1], src[2]).cpu()
    lat = []
    for m in src[0]:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            melgan.decode_mel(vocoder, m[None], src[1], src[2]).cpu()  # D2H waits for the card
            runs.append(time.perf_counter() - t0)
        lat.append(float(np.median(runs)))
    audio_s = [t * HOP / SAMPLE_RATE for t in UTTERANCE_FRAMES]
    for t, a, l in zip(UTTERANCE_FRAMES, audio_s, lat):
        print(f"decode: {t} frames ({a:.3f} s audio): {1e3 * l:.3f} ms per utterance "
              f"(median of 5, host clock, H2D and D2H included)", flush=True)
    print(f"decode: {sum(audio_s) / sum(lat):.1f} audio-s decoded per s over the 5 "
          f"utterances", flush=True)
    profile(lambda: melgan.decode_mel(vocoder, src[0][i431][None], src[1], src[2]).cpu(),
            lat[i431], f"{UTTERANCE_FRAMES[i431]}-frame MelGAN decode")
    with capturing(melgan, "melgan_resstack") as stage_calls:
        melgan.decode_mel(vocoder, src[0][i431][None], src[1], src[2])
    if len(stage_calls) != 4:
        raise AssertionError(f"one decode made {len(stage_calls)} K9 calls")

    reset_counts()
    t0 = time.perf_counter()
    text = _run_cli(convert_main, ["--name", "griffin_lim", "--griffin_lim",
                                   "--griffin_lim_iters", str(GRIFFIN_LIM_ITERS)] + common)
    wall = time.perf_counter() - t0
    gl_launches = counts()
    n_wavs = len([f for f in os.listdir(os.path.join(save, "griffin_lim", "converted_audio_1"))
                  if f.endswith(".wav")])
    for ln in text.splitlines():
        if ln.startswith(("MCD", "F0")):
            print(f"decode: Griffin-Lim CLI: {ln}", flush=True)
    print(f"decode: CLI --griffin_lim --griffin_lim_iters {GRIFFIN_LIM_ITERS} "
          f"--compute_mcd {wall:.2f} s (Griffin-Lim on the host); {n_wavs} wavs; launches "
          f"{gl_launches}", flush=True)
    want_gl = dict(want, melgan_stack=0)
    if gl_launches != want_gl or n_wavs != 2 * n_utt:
        raise AssertionError("the Griffin-Lim run went wrong")
    return voc_path, launches["melgan_stack"], stage_calls


def hifigan_v1_checkpoint(path: str, seed: int, gain: float = 1.5) -> dict:
    """A HiFi-GAN V1 generator checkpoint as jik876/hifi-gan writes one
    (``{"generator": state_dict}``, every conv weight-normed) with the
    benchmark's seeded weights at ``gain`` (``portbench/traffic.uniform_init``),
    so that a decode neither fades nor saturates its tanh. Returns the folded
    state_dict, which the plain reference takes."""
    from portbench import traffic
    from portbench.reference.hifigan import HiFiGAN

    ref = HiFiGAN(80, hifigan.V1)
    folded = traffic.uniform_init(ref, "", torch.Generator().manual_seed(seed), "cpu",
                                  weight_gain=gain)
    ref.load_state_dict(folded)
    for m in ref.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    torch.save({"generator": ref.state_dict()}, path)
    return folded


def phase_hifigan(device, pre: str, ckpts: str) -> None:
    """The second vocoder: the conversion CLI with a published-width HiFi-GAN
    V1 checkpoint, then a 517-frame decode held to the plain reference."""
    from portbench.reference.hifigan import HiFiGAN

    path = os.path.join(WORK, "hifigan_v1_generator")
    folded = hifigan_v1_checkpoint(path, 0)
    save = os.path.join(WORK, "decode_results")
    n_utt = len(UTTERANCE_FRAMES)
    reset_counts()
    before = dict(hifigan.CONVS)
    t0 = time.perf_counter()
    text = _run_cli(convert_main, ["--name", "hifigan", "--vocoder_ckpt", path, "--save_dir",
                                   save, "--preprocessed_data_dir", pre, "--ckpt_dir", ckpts,
                                   "--load_epoch", "1", "--device", "cuda", "--compute_mcd"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    convs = {k: hifigan.CONVS[k] - before[k] for k in hifigan.CONV_KINDS}
    decodes = 3 * n_utt  # converted, original and target, as with MelGAN
    want = {"pre": decodes, "up": 4 * decodes, "mrf": 72 * decodes, "post": decodes}
    for ln in text.splitlines():
        if ln.startswith(("wrote", "MCD", "F0", "ms an utterance")):
            print(f"hifigan: CLI: {ln}", flush=True)
    print(f"hifigan: CLI --vocoder_ckpt (HiFi-GAN V1) --compute_mcd on the card {wall:.2f} s; "
          f"convolutions {convs} (expected {want}); K9 launches "
          f"{KERNELS['melgan_stack']['counter'].launches} (expected 0)", flush=True)
    if convs != want or KERNELS["melgan_stack"]["counter"].launches:
        raise AssertionError("the HiFi-GAN decode run made other convolutions or launched K9")
    out_dir = os.path.join(save, "hifigan", "converted_audio_1")
    for i, t in enumerate(UTTERANCE_FRAMES):
        for kind in ("converted", "original"):
            wav, sr = read_wav(os.path.join(out_dir, f"{i}-{kind}_VCC2SF3_to_VCC2TF1.wav"))
            if wav.shape != (t * HOP,) or sr != SAMPLE_RATE or not np.isfinite(wav).all():
                raise AssertionError(f"hifigan {i}-{kind}: {wav.shape} at {sr} Hz")

    vocoder = vocoder_mod.load_vocoder(path, device)
    n = sum(p.numel() for p in vocoder.parameters())
    ref = HiFiGAN(80, hifigan.V1).to(device)
    ref.load_state_dict(folded)
    src = load_speaker(pre, "VCC2SF3")
    rs = np.random.RandomState(5)
    mel = rs.randn(80, 517).astype(np.float32)
    got = melgan.decode_mel(vocoder, mel[None], src[1], src[2])
    with torch.no_grad():
        x = torch.from_numpy(mel * src[2] + src[1])[None].to(device)
        want_wav = ref(x * hifigan.LN10)
    gap = float((got - want_wav).abs().max() / want_wav.abs().max())
    peak = float(got.abs().max())
    print(f"hifigan: V1 {n:,} parameters (expected 13,926,017); 517 frames -> {got.shape[1]} "
          f"samples, peak {peak:.4f}; card vs the plain reference on the card: "
          f"{gap:.3g} of the peak (bound {HIFIGAN_REL_TOL:g})", flush=True)
    if n != 13_926_017 or got.shape != (1, 517 * HOP) or gap > HIFIGAN_REL_TOL:
        raise AssertionError("the card's HiFi-GAN decode disagrees with the reference")
    lat = {}
    for t in UTTERANCE_FRAMES:
        m = mel[None, :, :t]
        melgan.decode_mel(vocoder, m, src[1], src[2]).cpu()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            melgan.decode_mel(vocoder, m, src[1], src[2]).cpu()
            runs.append(time.perf_counter() - t0)
        lat[t] = float(np.median(runs))
        print(f"hifigan: {t} frames ({t * HOP / SAMPLE_RATE:.3f} s audio): {1e3 * lat[t]:.3f} ms "
              f"per decode (median of 5, host clock, H2D and D2H included)", flush=True)
    print(f"hifigan: {sum(UTTERANCE_FRAMES) * HOP / SAMPLE_RATE / sum(lat.values()):.1f} "
          f"audio-s decoded per s over the 5 lengths", flush=True)
    profile(lambda: melgan.decode_mel(vocoder, mel[None], src[1], src[2]).cpu(),
            lat[517], "517-frame HiFi-GAN V1 decode")


def measure_log_mel(audio_inputs, device):
    """K8 on the padded audio of each bucket the preprocess run saw: error
    against the plain version, device times and the bound (the flops at the
    3xTF32 rate of the kernel's tensor-core products, with the f32 cores'
    bound and the achieved TFLOP/s beside it)."""
    per_bucket = {}
    for a in audio_inputs:
        per_bucket.setdefault(tuple(a.shape), [a, 0])[1] += 1
    r = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, simt_bound_ms=0.0, max_abs_err=0.0,
             gflop=0.0)
    for shape, (a, n) in sorted(per_bucket.items()):
        a = a.to(device)
        got = melspec.log_mel_spectrogram_fused(a, pad=False)
        want = melspec.log_mel_spectrogram_plain(a, pad=False)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if err > MEL_TOL:
            raise AssertionError(f"K8 at {shape}: max abs err {err:.3g} > {MEL_TOL}")
        B, L = shape
        T = got.shape[-1]
        flops = B * T * (2 * 2 * 1024 * 513 + 2 * 513 * 80)
        nbytes = 4 * (B * L + 2 * 1024 * 513 + 513 * 80 + B * 80 * T)
        t_ops, t_bytes = flops / F32_3XTF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        b_ms = 1e3 * max(t_ops, t_bytes)
        simt_ms = 1e3 * max(flops / F32_FLOPS_PER_S, t_bytes)
        ms = device_ms(lambda: melspec.log_mel_spectrogram_fused(a, pad=False))
        plain_ms = device_ms(lambda: melspec.log_mel_spectrogram_plain(a, pad=False))
        print(f"kernels: preprocess log_mel in {str(shape):16s} ({T} frames) x{n} max_abs_err "
              f"{err:.3g} (tol {MEL_TOL:g} log10 units) ms {ms:.5f} plain_ms {plain_ms:.5f} "
              f"library_ms null bound_us {1e3 * b_ms:.3f} "
              f"({'operations' if t_ops >= t_bytes else 'bytes'} at 3xTF32; f32-core "
              f"bound_us {1e3 * simt_ms:.3f}; {flops / 1e9:.3f} GFLOP, "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved)", flush=True)
        r["ms"] += n * ms
        r["plain_ms"] += n * plain_ms
        r["bound_ms"] += n * b_ms
        r["simt_bound_ms"] += n * simt_ms
        r["gflop"] += n * flops / 1e9
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernels: preprocess log_mel sum over the run's {len(audio_inputs)} calls: ms "
          f"{r['ms']:.5f} plain_ms {r['plain_ms']:.5f} bound_ms {r['bound_ms']:.5f} "
          f"(3xTF32; f32-core bound_ms {r['simt_bound_ms']:.5f}); {r['gflop']:.3f} GFLOP, "
          f"{r['gflop'] / r['ms']:.2f} TFLOP/s achieved", flush=True)
    return r


def measure_resstack(stage_calls, device):
    """K9 on the four stage inputs of one real 431-frame decode, in their
    dtype (the bf16 vocoder's in bf16): error against the plain version of
    that dtype, device times and the bound (bytes at the dtype's element
    size; flops in f32 at the 3xTF32 rate of the kernel's tensor-core
    products, with the f32 cores' bound printed beside it, and in bf16 at
    the dense bf16 tensor rate)."""
    r = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, simt_bound_ms=0.0, max_abs_err=0.0)
    for args, kwargs in stage_calls:
        x, blocks = args[0], args[1]
        emit, tail = kwargs.get("emit_lrelu", False), kwargs.get("tail")
        plain = melgan_stack.PLAIN[x.dtype]
        name = entry_name("melgan_stack", x.dtype)
        with torch.inference_mode():
            got = melgan_stack.melgan_resstack(x, blocks, emit, tail)
            want = plain(x, blocks, emit, tail)
            torch.cuda.synchronize()
        check_stage(got, want, f"{name} at {tuple(x.shape)}")
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        B, C, W = x.shape
        flops = B * W * (30 * C * C + (14 * C if tail is not None else 0))
        n_w = 3 * 5 * C * C + (7 * C if tail is not None else 0)
        n_b = 3 * 2 * C + (1 if tail is not None else 0)  # b1, bm, b7: f32
        nbytes = x.element_size() * (x.numel() + got.numel() + n_w) + 4 * n_b
        f32 = x.dtype == torch.float32
        rate = F32_3XTF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
        t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
        b_ms = 1e3 * max(t_ops, t_bytes)
        simt_ms = 1e3 * max(flops / F32_FLOPS_PER_S, t_bytes)
        simt = f" at 3xTF32; f32-core bound_us {1e3 * simt_ms:.3f}" if f32 else ""
        reps = 20 if x.numel() < (1 << 22) else 5
        with torch.inference_mode():
            ms = device_ms(lambda: melgan_stack.melgan_resstack(x, blocks, emit, tail), reps)
            plain_ms = device_ms(lambda: plain(x, blocks, emit, tail), reps)
        what = "tail" if tail is not None else ("emit_lrelu" if emit else "plain")
        tol = (f"tol {STAGE_TOL_BF16:g} of the scale" if x.dtype == torch.bfloat16 else
               f"tol {STAGE_TOL:g} of the scale + rtol {STAGE_TOL:g}")
        print(f"kernels: decode {name} in {str(tuple(x.shape)):18s} {what:10s} "
              f"max_abs_err {err:.3g} (output scale {scale:.3g}; {tol}) ms {ms:.5f} "
              f"plain_ms {plain_ms:.5f} library_ms null "
              f"bound_us {1e3 * b_ms:.3f} ({'operations' if t_ops >= t_bytes else 'bytes'}"
              f"{simt}; {flops / 1e9:.3f} GFLOP, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
              f"achieved)", flush=True)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["simt_bound_ms"] += simt_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    simt = f" (3xTF32; f32-core bound_ms {r['simt_bound_ms']:.5f})" if f32 else ""
    print(f"kernels: decode {name} sum over one 431-frame decode (4 calls): ms "
          f"{r['ms']:.5f} plain_ms {r['plain_ms']:.5f} bound_ms {r['bound_ms']:.5f}{simt}",
          flush=True)
    return r


def check_stage(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """K9's output against its plain version's, in their dtype's bound;
    returns the error over the output's scale."""
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        ok = got.dtype == want.dtype and err <= STAGE_TOL_BF16 * scale
    else:
        ok = torch.allclose(got, want, atol=STAGE_TOL * scale, rtol=STAGE_TOL)
    if not ok or got.shape != want.shape:
        raise AssertionError(f"K9 {what}: max abs err {err:.3g} (output scale {scale:.3g})")
    return err / scale


def _log_losses(path: str):
    rows = [line for line in open(path) if line.startswith("[epoch")]
    vals = [float(v) for line in rows for v in re.findall(r": (\S+)", line)
            if not v.startswith("(")]
    return rows, vals


def logged_losses(calls) -> list:
    """Each step's logged losses as host floats, from the recorded calls of
    ``TrainLogger.log_iter`` (the values it got, before its 5-decimal text)."""
    return [[row[k] for k in LOGGED_METRICS]
            for row in to_host([args[3] for args, _ in calls])]


def cli_losses(argv) -> np.ndarray:
    """The train CLI's logged losses, (steps, 7)."""
    with capturing(TrainLogger, "log_iter") as calls:
        train_main(argv)
    return np.array(logged_losses(calls))


def phase_train(device, vocoder_ckpt: str):
    pre, save = os.path.join(WORK, "train_pre"), os.path.join(WORK, "train_results")
    rs = np.random.RandomState(1)
    for sid in ("VCC2SF3", "VCC2TF1"):
        lens = rs.randint(128, 518, size=TRAIN_SPEAKER_UTTERANCES)
        save_speaker(pre, sid, [rs.randn(80, t).astype(np.float32) for t in lens],
                     rs.randn(80, 1).astype(np.float32),
                     (rs.rand(80, 1) + 0.5).astype(np.float32))
    args = ["--name", "smoke", "--save_dir", save, "--preprocessed_data_dir", pre,
            "--device", "cuda", "--batch_size", "1", "--num_frames", "64",
            "--epochs_per_save", "1", "--epochs_per_plot", "2", "--steps_per_print", "1",
            "--vocoder_ckpt", vocoder_ckpt]

    # The slice's main path: train through the CLI (--scan_epochs 1, the
    # default), then resume. Counts from 0 just before, read just after.
    reset_counts()
    with graph_accounting() as acct, capturing(TrainLogger, "log_iter") as graph_log:
        t0 = time.perf_counter()
        train_main(args + ["--num_epochs", "2"])
        t1 = time.perf_counter()
        train_main(args + ["--num_epochs", "3", "--continue_train"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = run_launches(acct)
    steps = 3 * TRAIN_SPEAKER_UTTERANCES
    # The plot at epoch 2: two conversions, each one generator forward, and
    # its four panels decoded by the vocoder, 4 K9 calls each.
    want = {k: 0 for k in KERNELS}
    want.update({k: steps * n + 2 * PER_FORWARD.get(k, 0) for k, n in per_step(1, 64).items()})
    want["melgan_stack"] = 16
    print(f"train: CLI (--scan_epochs 1), 2 epochs {t1 - t0:.1f} s, resumed to epoch 3 "
          f"{t2 - t1:.1f} s (state creation, captures, checkpoint writes and reads included); "
          f"launches {launches} (expected {want}: {steps} steps, 2 plot conversions, 4 panels "
          f"decoded); {accounting_line(acct)}", flush=True)
    if launches != want or acct["replays"] != steps - 2:
        raise AssertionError("the training run did not launch every kernel as expected")

    ckpts = os.path.join(save, "smoke", "ckpts")
    with np.load(os.path.join(ckpts, "00003_state.npz")) as z:
        step = int(z[".step"])
        n_keys = len(z.files)
    rows, vals = _log_losses(os.path.join(save, "smoke", "smoke.log"))
    print(f"train: 00003_state.npz holds step {step} ({n_keys} entries); "
          f"{len(rows)} logged steps, all {len(vals)} logged losses finite: "
          f"{bool(np.isfinite(vals).all())}; last line: {rows[-1].strip()}", flush=True)
    if step != steps or len(rows) != steps or not np.isfinite(vals).all():
        raise AssertionError("the resumed run did not continue the step counter, "
                             "or logged a non-finite loss")

    # The same 3 epochs a step at a time. cuDNN's default algorithms may sum
    # in another order from one run to the next: the first G update then
    # flips the sign of Adam's first step (lr * sign(g)) wherever a gradient
    # is within rounding of 0, and the D losses of step 1 on already see
    # generators 2 lr apart there. With cuDNN held to deterministic
    # algorithms both modes run the same sums on the same capturable Adam
    # (the trainer's Adam form follows the device, not the flag), and
    # differ only in how the step is issued: there the first 3 steps are
    # held to 1e-5.
    common = args + ["--epochs_per_save", "100", "--epochs_per_plot", "100"]
    ref = cli_losses(common + ["--num_epochs", "3", "--scan_epochs", "0", "--name", "eager"])
    got = np.array(logged_losses(graph_log))
    rel = np.abs(got - ref) / np.abs(ref)
    again = cli_losses(common + ["--num_epochs", "1", "--scan_epochs", "0", "--name", "again"])
    rel_again = np.abs(again - ref[:len(again)]) / np.abs(ref[:len(again)])
    print(f"train: --scan_epochs 1 against 0, {len(ref)} steps, cuDNN's default algorithms: "
          f"largest relative difference of the logged losses {rel[:1].max():.3g} at step 1, "
          f"{rel[:3].max():.3g} over steps 1-3, {rel.max():.3g} over the whole run; two runs "
          f"with --scan_epochs 0 differ by {rel_again[:1].max():.3g} at step 1, "
          f"{rel_again[:3].max():.3g} over steps 1-3, {rel_again.max():.3g} over "
          f"{len(again)} steps", flush=True)
    torch.backends.cudnn.deterministic = True
    try:
        det = [cli_losses(common + ["--num_epochs", "1", "--scan_epochs", str(scan),
                                    "--name", f"deterministic{scan}"]) for scan in (1, 0)]
    finally:
        torch.backends.cudnn.deterministic = False
    rel_det = np.abs(det[0] - det[1]) / np.abs(det[1])
    print(f"train: --scan_epochs 1 against 0 with deterministic cuDNN, {len(det[1])} steps: "
          f"logged losses of steps 1-3 within {rel_det[:3].max():.3g} relative (bound 1e-5), "
          f"{rel_det.max():.3g} over the run", flush=True)
    if got.shape != ref.shape or det[0].shape != det[1].shape or rel_det[:3].max() > 1e-5:
        raise AssertionError("the graph run's losses disagree with the eager run's")
    return launches, pre, args, got, det


def phase_train_bf16(device, pre: str, args: list, f32_losses: np.ndarray):
    """The slice's main path in bf16: phase_train's CLI run (``args``) with
    --dtype bfloat16, 2 epochs as graph replays, then resumed to 3. Every
    captured step launches the bf16 entries of K1-K5 alone, and so do the
    run's eager first steps (its totals); the plot's two conversions run
    the f32 entries, as the JAX trainer converts in f32. g and d losses
    within BF16_LOSS_RTOL of the f32 run's at every step. The checkpoint
    holds f32 arrays and the conversion CLI reads it on the card. Then one
    epoch with --fused_norms 0, which launches no kernel. Returns the run's
    launches."""
    save = args[args.index("--save_dir") + 1]
    argv = args + ["--name", "smoke_bf16", "--dtype", "bfloat16"]
    reset_counts()
    with graph_accounting() as acct, capturing(TrainLogger, "log_iter") as log:
        t0 = time.perf_counter()
        train_main(argv + ["--num_epochs", "2"])
        t1 = time.perf_counter()
        train_main(argv + ["--num_epochs", "3", "--continue_train"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = run_launches(acct)
    steps = 3 * TRAIN_SPEAKER_UTTERANCES
    step_want = per_step(1, 64, torch.bfloat16)
    want = {k: 0 for k in KERNELS}
    want.update({k: steps * n for k, n in step_want.items()})
    want.update({k: 2 * n for k, n in PER_FORWARD.items()})  # the plot's f32 conversions
    want["melgan_stack"] = 16
    captured = {k: acct["captures"] * n for k, n in step_want.items()}
    print(f"train bf16: CLI --dtype bfloat16 (--scan_epochs 1), 2 epochs {t1 - t0:.1f} s, "
          f"resumed to epoch 3 {t2 - t1:.1f} s; launches {launches} (expected {want}: "
          f"{steps} steps on the bf16 entries, 2 f32 plot conversions, 4 panels decoded); "
          f"{accounting_line(acct)}", flush=True)
    if launches != want or acct["at_capture"] != captured or acct["replays"] != steps - 2:
        raise AssertionError("the bf16 run did not launch the bf16 entries alone")

    got = np.array(logged_losses(log))
    if got.shape != f32_losses.shape or not np.isfinite(got).all():
        raise AssertionError(f"bf16 losses {got.shape}, finite {np.isfinite(got).all()}")
    rel = np.abs(got - f32_losses) / np.abs(f32_losses)
    gaps = {k: float(rel[:, i].max()) for i, k in enumerate(LOGGED_METRICS)}
    ig, idl = LOGGED_METRICS.index("g_loss"), LOGGED_METRICS.index("d_loss")
    print(f"train bf16: {len(got)} steps, every logged loss finite; largest relative gap to "
          f"the f32 run's losses at the same steps: " + ", ".join(
              f"{k} {v:.4g}" for k, v in gaps.items())
          + f" (g_loss and d_loss bound {BF16_LOSS_RTOL}); step 1 g_loss bf16 "
          f"{got[0, ig]:.5f} f32 {f32_losses[0, ig]:.5f}, last d_loss bf16 {got[-1, idl]:.5f} "
          f"f32 {f32_losses[-1, idl]:.5f}", flush=True)
    if max(gaps["g_loss"], gaps["d_loss"]) >= BF16_LOSS_RTOL:
        raise AssertionError("the bf16 losses left the f32 run's band")

    ckpts = os.path.join(save, "smoke_bf16", "ckpts")
    with np.load(os.path.join(ckpts, "00003_state.npz")) as z:
        kinds = {str(z[k].dtype) for k in z.files if z[k].dtype.kind == "f"}
        step = int(z[".step"])
    reset_counts()
    convert_main(["--name", "smoke_bf16_convert", "--save_dir", save, "--preprocessed_data_dir",
                  pre, "--ckpt_dir", ckpts, "--load_epoch", "3", "--device", "cuda"])
    out_dir = os.path.join(save, "smoke_bf16_convert", "converted_audio_3")
    outs = [np.load(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))
            if "-converted_" in f and f.endswith(".npy")]
    convert_launches = {k: n for k, n in counts().items() if n}
    print(f"train bf16: 00003_state.npz holds step {step}, float arrays {sorted(kinds)}; the "
          f"conversion CLI on the card read it: {len(outs)} utterances, all finite "
          f"{all(np.isfinite(o).all() for o in outs)}, launches {convert_launches}", flush=True)
    if kinds != {"float32"} or step != steps or len(outs) != TRAIN_SPEAKER_UTTERANCES \
            or not all(np.isfinite(o).all() for o in outs) \
            or set(convert_launches) != set(PER_FORWARD):
        raise AssertionError("the bf16 run's checkpoint is not the f32 one the CLI reads")

    # --fused_norms 0: the plain versions on the card, the JAX package's
    # XLA path; nothing launches a kernel.
    reset_counts()
    with graph_accounting() as acct, capturing(TrainLogger, "log_iter") as log:
        train_main(argv + ["--name", "smoke_plain", "--fused_norms", "0", "--num_epochs", "1",
                           "--epochs_per_save", "100", "--epochs_per_plot", "100"])
        torch.cuda.synchronize()
    plain_launches = run_launches(acct)
    plain = np.array(logged_losses(log))
    n = len(plain)
    gap = np.abs(plain - got[:n]) / np.abs(got[:n])
    print(f"train bf16: --fused_norms 0, one epoch of {n} steps ({acct['replays']} replayed): "
          f"launches {plain_launches} (none expected); losses finite "
          f"{bool(np.isfinite(plain).all())}; largest relative gap to the kernels' bf16 run "
          f"g_loss {gap[:, ig].max():.4g}, d_loss {gap[:, idl].max():.4g}", flush=True)
    if any(plain_launches.values()) or n != TRAIN_SPEAKER_UTTERANCES \
            or not np.isfinite(plain).all():
        raise AssertionError("--fused_norms 0 launched a kernel or went wrong")
    return launches


def train_setup(pre: str, batch: int, frames: int, device, dtype=None, precision=None):
    banks = [MelBank.from_list(load_speaker(pre, sid)[0], frames, device)
             for sid in ("VCC2SF3", "VCC2TF1")]
    sched = ScheduleConfig(n_samples=len(banks[0]), batch_size=batch)
    cfg = TrainConfig(schedule=sched, num_frames=frames, dtype=dtype, precision=precision)
    return cfg, banks


def config_name(cfg: TrainConfig) -> str:
    if cfg.dtype == torch.bfloat16:
        return "bf16"
    return "TF32" if cfg.precision == "tensorfloat32" else "f32"


def moment_errors(got: dict, want: dict, prefix: str) -> dict:
    """Per leaf of Adam's first moment under ``prefix``, ||got - want|| over
    the leaf's own norm or, for a bias, the largest norm of its layer's
    leaves: a conv bias ahead of an InstanceNorm has zero gradient in exact
    arithmetic, so its computed value is rounding noise at the scale of the
    gradients that flow through that layer."""
    keys = [k for k in want if k.startswith(prefix)]
    norms = {k: float(np.linalg.norm(want[k])) for k in keys}
    layer_of = {k: k.rsplit("/", 1)[0] for k in keys}
    layer = {}
    for k in keys:
        layer[layer_of[k]] = max(layer.get(layer_of[k], 0.0), norms[k])
    scale = {k: layer[layer_of[k]] if k.endswith("/bias") else norms[k] for k in keys}
    return {k: float(np.linalg.norm(got[k] - want[k])) / max(scale[k], 1e-30) for k in keys}


def phase_cross_step(pre: str, device) -> None:
    """One step on the card against the same step on the CPU plain path,
    from the same state and batch. Losses within a relative 1e-4. Adam's
    first moments after this first step are (1 - b1) times the gradients:
    per leaf within a relative norm of MOMENT_BOUND (``moment_errors``). The
    params are checked only against the Adam step quantum, |delta| <= 2 lr
    per element, a guard that no gradient can exceed: Adam's first step is
    close to lr * sign(g), so one rounding difference can flip the sign of
    a near-zero gradient and move the two params 2 lr apart (1 % margin
    for the params' f32 rounding)."""
    cfg, banks = train_setup(pre, 1, 64, device)
    cpu = create_train_state(cfg, 0, "cpu")
    for name, model in cpu.d.items():
        n = sum(p.numel() for p in model.parameters())
        n_live = sum(p.numel() for p in model.live_parameters())
        if (n, n_live) != (N_PARAMS_D, N_PARAMS_D_LIVE):
            raise AssertionError(f"discriminator {name}: {n} / {n_live} parameters")
    if any(sum(p.numel() for p in g.parameters()) != N_PARAMS for g in cpu.g.values()):
        raise AssertionError("a generator of the training state has the wrong size")
    gpu = train_state_from_jax(train_state_to_jax(cpu), create_train_state(cfg, 1, device))
    batch = sample_batch(step_generator(0, 0, device), *banks, 1, 64, 25)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    _, m_cpu = step(cpu, {k: v.cpu() for k, v in batch.items()})
    t1 = time.perf_counter()
    _, m_gpu = step(gpu, batch)
    torch.cuda.synchronize()
    worst = 0.0
    for k in m_cpu:
        a, b = float(m_gpu[k]), float(m_cpu[k])
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"cross step: {k} card {a} vs CPU {b}")
    flat_cpu, flat_gpu = train_state_to_jax(cpu), train_state_to_jax(gpu)
    for side, lr, prefix in (("g", cfg.schedule.generator_lr, ".g_opt/0/.mu/"),
                             ("d", cfg.schedule.discriminator_lr,
                              ".d_opt/.inner_state/0/.mu/")):
        errs = moment_errors(flat_gpu, flat_cpu, prefix)
        leaf = max(errs, key=errs.get)
        print(f"train: cross step {side.upper()} Adam first moments ({len(errs)} leaves): "
              f"worst relative norm error {errs[leaf]:.3g} at {leaf} "
              f"(bound {MOMENT_BOUND[side]:g}); "
              f"median {float(np.median(list(errs.values()))):.3g}", flush=True)
        if errs[leaf] > MOMENT_BOUND[side]:
            raise AssertionError(f"cross step: {side} gradients disagree at {leaf}")
        keys = [k for k in flat_cpu if k.startswith(f".{side}_params/")]
        d = max(float(np.abs(flat_gpu[k] - flat_cpu[k]).max()) for k in keys)
        n_over = sum(int((np.abs(flat_gpu[k] - flat_cpu[k]) > 1e-3 * lr).sum()) for k in keys)
        print(f"train: cross step {side.upper()} params: max |card - CPU| {d:.3g} = "
              f"{d / lr:.3g} lr (guard 2.02 lr); {n_over} of "
              f"{sum(flat_cpu[k].size for k in keys)} elements differ by over 1e-3 lr",
              flush=True)
        if d > 2.02 * lr:
            raise AssertionError(f"cross step: {side} params beyond the Adam quantum")
    print(f"train: cross step losses: worst relative difference {worst:.3g} (bound 1e-4); "
          f"g_loss card {float(m_gpu['g_loss']):.6f} CPU {float(m_cpu['g_loss']):.6f}; "
          f"the CPU step took {t1 - t0:.1f} s", flush=True)


def phase_step_timing(pre: str, device, batch: int, frames: int, graph_spans: int = 0,
                      dtype=None, precision=None, eager: bool = True):
    """ms/step of the step function at one size, in ``dtype`` (None: f32)
    at ``precision`` (``--precision``; None keeps TF32 off). With ``eager``,
    a step at a time: the median of the steps after the warm-up steps (20
    after 5 at batch 1, 5 after 2 at batch 32), host clock around each step
    ending in a synchronize; the launch counts of one step and its kernel
    sites, as recorded, peak memory and a profile. With ``graph_spans``,
    the same steps as CUDA-graph replays (``step_timing_graphed``). The
    config's precision holds for the phase; TF32 is restored after."""
    cfg, banks = train_setup(pre, batch, frames, device, dtype, precision)
    with precision_scope(cfg.precision):
        launches = sites = eager_ms = None
        if eager:
            launches, sites, eager_ms = step_timing(cfg, banks, device, batch, frames)
        if graph_spans:
            step_timing_graphed(cfg, banks, device, batch, frames, graph_spans, eager_ms)
    return launches, sites


# The median ms/step of each config a step at a time: {(config_name, batch,
# frames): ms}, as step_timing measured it.
STEP_MS = {}


def step_timing(cfg, banks, device, batch: int, frames: int):
    warm, timed = (5, 20) if batch == 1 else (2, 5)
    name = config_name(cfg)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    batches = [sample_batch(step_generator(0, i, device), *banks, batch, frames, 25)
               for i in range(warm + timed + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times[warm:]))
    STEP_MS[(name, batch, frames)] = ms
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reset_counts()
    with recording_sites() as sites:
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
    launches = {k: n for k, n in counts().items() if n}
    want = per_step(batch, frames, cfg.dtype or torch.float32)
    audio_s = batch * frames * HOP / SAMPLE_RATE
    print(f"train: {name} step at batch {batch} x {frames} frames (pair_forwards "
          f"{cfg.pair_forwards_resolved()}): {ms:.3f} ms/step (median of {timed} after {warm} "
          f"warm-up, host clock; min {1e3 * min(times[warm:]):.3f}, max "
          f"{1e3 * max(times[warm:]):.3f}), {audio_s / (ms / 1e3):.2f} audio-s trained per s, "
          f"peak memory {peak:.2f} GiB; launches in one step {launches} "
          f"(expected {want}); losses g {float(m['g_loss']):.4f} "
          f"d {float(m['d_loss']):.4f}", flush=True)
    routes = route_counts()
    print(f"train: {name} step at batch {batch} x {frames}: routes in one step {routes} "
          f"(expected {main_routes(want)})", flush=True)
    if launches != want or site_counts(sites) != launches or routes != main_routes(want):
        raise AssertionError(f"one step at batch {batch} x {frames} launched {launches}, "
                             f"recorded {site_counts(sites)}, routes {routes}")
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"non-finite metrics at batch {batch}: {m}")
    profile(lambda: step(state, batches[0]), ms / 1e3,
            f"one {name} training step at batch {batch} x {frames}")
    del state, batches
    torch.cuda.empty_cache()
    return {**launches, **routes}, sites, ms


def step_timing_graphed(cfg, banks, device, batch: int, frames: int, spans: int,
                        eager_ms=None) -> None:
    """ms/step with each step a CUDA-graph replay (--scan_epochs 1's
    runner): spans of steps (20 at batch 1, 2 at batch 32) with no host
    synchronisation inside, each timed as its wall time (host clock, ending
    in a synchronize) over its steps; the median span. Before that, the
    first 4 steps one at a time: the batches drawn inside the replays
    against the eager sampler's, bit for bit. Then the launches per
    replayed step, and a profile of 5 replayed steps (1 at batch 32)."""
    state = create_train_state(cfg, 0, device, capturable=True)
    update = make_update(cfg)
    runner = StepRunner(cfg, lambda step: update, *banks, 0, batch, frames, 25)
    equal = []
    n = 20 if batch == 1 else 2
    with graph_accounting() as acct:
        for step in range(4):  # step 0 runs eagerly and captures; 1-3 replay
            runner.run(state, 1)
            want = sample_batch(step_generator(0, step, device), *banks, batch, frames, 25)
            equal.append(all(torch.equal(runner.batch[k], v) for k, v in want.items()))
        runner.run(state, n)
        torch.cuda.synchronize()
    name = config_name(cfg)
    want = per_step(batch, frames, cfg.dtype or torch.float32)
    print(f"train: {name} {batch} x {frames} graph replays: batches of steps 0-3 (step 0 eager, "
          f"1-3 replayed) bit-equal to sample_batch(step_generator(0, step)): {equal}",
          flush=True)
    if not all(equal):
        raise AssertionError("a replay drew another batch than the eager sampler")
    replayed = {k: v // acct["replays"] for k, v in acct["replayed"].items() if v}
    walls = []
    for _ in range(spans):
        t0 = time.perf_counter()
        rows = runner.run(state, n)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n)
    ms = 1e3 * float(np.median(walls))
    finite = bool(torch.isfinite(rows).all())
    audio_s = batch * frames * HOP / SAMPLE_RATE
    against = "" if eager_ms is None else f" against {eager_ms:.3f} a step at a time"
    print(f"train: {name} step at batch {batch} x {frames} as CUDA-graph replays "
          f"(--scan_epochs 1): "
          f"{ms:.3f} ms/step (median of {spans} spans of {n} steps, each span's wall time "
          f"over its steps, one synchronize at its end; spans {[round(1e3 * w, 3) for w in walls]})"
          f"{against}, {audio_s / (ms / 1e3):.2f} audio-s trained per s; launches per "
          f"replayed step {replayed} (expected {want}); losses finite {finite}", flush=True)
    if replayed != want or not finite:
        raise AssertionError(f"the replayed steps at {batch} x {frames} went wrong")
    k = 5 if batch == 1 else 1
    profile(lambda: runner.run(state, k), ms * k / 1e3,
            f"{k} replayed {name} training steps at batch {batch} x {frames}")
    del state, runner
    torch.cuda.empty_cache()


def phase_long_crops(pre: str, device):
    """Long crops: the train CLI at 192 frames for one epoch, where each
    step's upSample2 backwards take the split route (K6) and its upSample1
    backwards K5; then a 1 x 320 step, where both split: its time, its
    sites, and the split route against K5 at one upSample2 site. Returns the
    run's launches, the 1 x 320 step's sites, that site's times, and the
    launches per step as run: the CLI run's over its steps at 1 x 192, the
    timed step's at 1 x 320."""
    save = os.path.join(WORK, "long_results")
    n_steps = min(len(MelBank.from_list(load_speaker(pre, sid)[0], 192)) for sid in SPEAKERS)
    reset_counts()
    with graph_accounting() as acct:
        t0 = time.perf_counter()
        train_main(["--name", "long", "--save_dir", save, "--preprocessed_data_dir", pre,
                    "--device", "cuda", "--batch_size", "1", "--num_frames", "192",
                    "--num_epochs", "1", "--epochs_per_save", "100",
                    "--epochs_per_plot", "100", "--steps_per_print", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = run_launches(acct)
    want = {k: n_steps * per_step(1, 192).get(k, 0) for k in KERNELS}
    print(f"long crops: CLI --num_frames 192, one epoch of {n_steps} steps (the utterances "
          f"of at least 192 frames) {wall:.1f} s; launches {launches} (expected {want}: K5 "
          f"3 and K6 3 a step); {accounting_line(acct)}", flush=True)
    if launches != want:
        raise AssertionError("the long-crop run did not launch K5 and K6 as expected")
    check_shuffle_routes("long crops: CLI --num_frames 192")
    rows, vals = _log_losses(os.path.join(save, "long", "long.log"))
    if len(rows) != n_steps or not np.isfinite(vals).all():
        raise AssertionError("the long-crop run logged a non-finite loss")

    kept, real = [], ps.pixel_shuffle_in_swish_backward_split

    def keep_first_upsample2(x, dy, *vecs):
        if not kept and x.shape[1] == 512:
            kept.append([t.clone() for t in (x, dy, *vecs)])
        return real(x, dy, *vecs)

    ps.pixel_shuffle_in_swish_backward_split = keep_first_upsample2
    try:
        step_launches, sites = phase_step_timing(pre, device, 1, 320)
    finally:
        ps.pixel_shuffle_in_swish_backward_split = real
    x, dy, s, b = kept[0]
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    split = ps.pixel_shuffle_in_swish_backward_split(x, dy, s, b)
    fused = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    torch.cuda.synchronize()
    errs = []
    for got, ref, what in zip(split, fused, ("dx", "dscale", "dbias")):
        scale = ref.abs().max().item()
        errs.append(f"{what} {(got - ref).abs().max().item():.3g} (scale {scale:.3g})")
        if not torch.allclose(got, ref, atol=SPLIT_TOL * scale, rtol=0):
            raise AssertionError(f"split route against K5 at {tuple(x.shape)}: {errs[-1]}")
    reps = 5
    split_ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward_split(x, dy, s, b), reps)
    fused_ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv),
                         reps)
    print(f"long crops: split route against K5 at the 1 x 320 step's upSample2 site x "
          f"{tuple(x.shape)}: max abs err {', '.join(errs)} (bound {SPLIT_TOL:g} of each "
          f"output's scale); device ms split route {split_ms:.5f} (K6 and the eager "
          f"gradient) against K5 {fused_ms:.5f} (CUDA-graph replay)", flush=True)
    times = {"split_ms": split_ms, "fused_ms": fused_ms, "site": list(x.shape)}
    del kept, x, dy
    per = {"1x192": {k: n // n_steps for k, n in launches.items()}, "1x320": step_launches}
    return launches, sites, times, per


def phase_long_crops_bf16(pre: str, device):
    """bf16 long crops: the train CLI at --num_frames 320 with --dtype
    bfloat16 for one epoch. At 2 bytes an element upSample2's per-sample
    block is past the budget and upSample1's within it, so each step runs 3
    bf16 K6 (the split route) and 3 bf16 K5, as per_step predicts; then one
    1 x 320 bf16 step, its time and its sites. Returns the run's launches,
    the step's sites, and its launches per step at 1 x 320 as run."""
    save = os.path.join(WORK, "long_results")
    n_steps = min(len(MelBank.from_list(load_speaker(pre, sid)[0], 320)) for sid in SPEAKERS)
    reset_counts()
    with graph_accounting() as acct:
        t0 = time.perf_counter()
        train_main(["--name", "long_bf16", "--save_dir", save, "--preprocessed_data_dir", pre,
                    "--device", "cuda", "--batch_size", "1", "--num_frames", "320",
                    "--dtype", "bfloat16", "--num_epochs", "1", "--epochs_per_save", "100",
                    "--epochs_per_plot", "100", "--steps_per_print", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = run_launches(acct)
    step_want = per_step(1, 320, torch.bfloat16)
    want = {k: n_steps * step_want.get(k, 0) for k in KERNELS}
    print(f"long crops bf16: CLI --num_frames 320 --dtype bfloat16, one epoch of {n_steps} "
          f"steps {wall:.1f} s; launches {launches} (expected {want}: per step {step_want}); "
          f"{accounting_line(acct)}", flush=True)
    if launches != want:
        raise AssertionError("the bf16 long-crop run did not launch K5 and K6 as expected")
    check_shuffle_routes("long crops bf16: CLI --num_frames 320")
    rows, vals = _log_losses(os.path.join(save, "long_bf16", "long_bf16.log"))
    if len(rows) != n_steps or not np.isfinite(vals).all():
        raise AssertionError("the bf16 long-crop run logged a non-finite loss")
    step_launches, sites = phase_step_timing(pre, device, 1, 320, dtype=torch.bfloat16)
    return launches, sites, {"1x320": step_launches}


# ---------------------------------------------------------------------------
# The benchmark's config 5: a training step and the in-loop vocoder decode
# ---------------------------------------------------------------------------

class StepAndDecode:
    """The update with ``with_eval_fake``, then the vocoder's decode of
    ``fake_B_eval`` (no denormalization, as bench.py:98-105), as one update
    function for ``StepRunner`` or ``as_train_step``. ``wav`` is the last
    call's waveform: in a CUDA graph, the graph's own tensor, which each
    replay overwrites; ``fake`` its input."""

    def __init__(self, cfg: TrainConfig, vocoder, with_identity: bool = True):
        self.update = make_update(cfg, with_identity, with_eval_fake=True)
        self.vocoder = vocoder
        self.wav = self.fake = None

    def __call__(self, state, batch, lam_id):
        metrics = self.update(state, batch, lam_id)
        self.fake = metrics.pop("fake_B_eval")
        with torch.no_grad():
            self.wav = self.vocoder(self.fake)
        return metrics


def eval_decode_want(batch: int, frames: int, dtype) -> dict:
    """Launches of one step+decode: the step's, and 4 K9 calls (13 device
    launches: 3 blocks a stage, and the tail on the last) of the vocoder's
    dtype."""
    return dict(per_step(batch, frames, dtype), **{entry_name("melgan_stack", dtype): 4})


def check_waveform(wav: torch.Tensor, batch: int, frames: int, dtype, what: str) -> str:
    w = wav.float()
    finite = bool(torch.isfinite(w).all())
    peak = w.abs().max().item()
    if wav.dtype != dtype or wav.shape != (batch, frames * HOP) or not finite or peak > 1.0:
        raise AssertionError(f"eval decode: {what}: waveform {wav.dtype} {tuple(wav.shape)}, "
                             f"finite {finite}, peak {peak}")
    return (f"waveform {tuple(wav.shape)} {str(wav.dtype).removeprefix('torch.')}, finite, "
            f"in [{w.min().item():.4f}, {w.max().item():.4f}], std {w.std().item():.4f}")


def check_stage_calls(fn, what: str) -> str:
    """Run ``fn`` once, eagerly, recording its K9 calls; each against the
    plain version of its dtype."""
    with capturing(melgan, "melgan_resstack") as calls:
        fn()
        torch.cuda.synchronize()
    worst = 0.0
    for args, kwargs in calls:
        with torch.inference_mode():
            got = melgan_stack.melgan_resstack(*args, **kwargs)
            want = melgan_stack.PLAIN[args[0].dtype](*args, **kwargs)
        worst = max(worst, check_stage(got, want, f"{what} at {tuple(args[0].shape)}"))
    if len(calls) != 4:
        raise AssertionError(f"eval decode: {what}: {len(calls)} K9 calls")
    return f"its 4 K9 calls against the plain version: worst error {worst:.3g} of the scale"


def decode_share(vocoder, fake, busy_ms) -> str:
    """The decode's device time alone (a CUDA graph of decodes of the
    step's conversion) over the step+decode's device-busy time."""
    with torch.no_grad():
        dec = device_ms(lambda: vocoder(fake), 5, 3)
    if busy_ms is None:
        return f"decode alone {dec:.3f} ms of device time; share not measured"
    return (f"decode alone {dec:.3f} ms of device time, {100 * dec / busy_ms:.1f} % of the "
            f"step+decode's {busy_ms:.3f} ms busy")


def phase_eval_decode(pre: str, audio_pre: str, device, vocoder_ckpt: str):
    """Config 5 on the card. Returns the bf16 K9 launches of the main run
    (bf16 1 x 64 as graph replays) and the four K9 calls of a 431-frame
    bf16 decode, for the kernels phase."""
    bf16, f32 = torch.bfloat16, torch.float32
    vocoders = {f32: vocoder_mod.load_vocoder(vocoder_ckpt, device),
                bf16: melgan.MelGANGenerator(device=device, dtype=bf16)}
    vocoders[bf16].load_state_dict(vocoders[f32].state_dict())
    launches = eval_decode_graphed(pre, device, vocoders[bf16], bf16, spans=3, n=10)
    eval_decode_eager(pre, device, vocoders[bf16], bf16, 1, 64)
    eval_decode_eager(pre, device, vocoders[bf16], bf16, 32, 128)
    eval_decode_graphed(pre, device, vocoders[f32], f32, spans=2, n=10)

    mels, mean, std = load_speaker(audio_pre, "VCC2TF1")
    mel = mels[UTTERANCE_FRAMES.index(431)]
    with capturing(melgan, "melgan_resstack") as stage_calls:
        melgan.decode_mel(vocoders[bf16], mel[None], mean, std)
    if len(stage_calls) != 4 or any(a[0].dtype != bf16 for a, _ in stage_calls):
        raise AssertionError("the bf16 431-frame decode did not make 4 bf16 K9 calls")
    return launches, stage_calls


def eval_decode_graphed(pre, device, vocoder, dtype, spans: int, n: int) -> int:
    """Step+decode at 1 x 64 as CUDA-graph replays: ``spans`` spans of
    ``n`` steps after 2 (step 0 eager, then captured; step 1 replayed).
    Returns the K9 launches of the run, replays counted."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    cfg, banks = train_setup(pre, 1, 64, device, None if dtype == torch.float32 else dtype)
    state = create_train_state(cfg, 0, device, capturable=True)
    fns = {wi: StepAndDecode(cfg, vocoder, wi) for wi in (True, False)}
    runner = StepRunner(cfg, lambda step: fns[identity_lambda(cfg.schedule, step) > 0],
                        *banks, 0, 1, 64, 25)
    reset_counts()
    walls = []
    with graph_accounting() as acct:
        runner.run(state, 2)
        torch.cuda.synchronize()
        for _ in range(spans):
            t0 = time.perf_counter()
            rows = runner.run(state, n)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0) / n)
    launches = run_launches(acct)
    steps = 2 + spans * n
    want = eval_decode_want(1, 64, dtype)
    replayed = {k: v // acct["replays"] for k, v in acct["replayed"].items() if v}
    k9 = entry_name("melgan_stack", dtype)
    ms = float(np.median(walls))
    fn = fns[True]
    wave = check_waveform(fn.wav, 1, 64, dtype, f"{name} 1 x 64 replays")
    audio_s = 64 * HOP / SAMPLE_RATE
    print(f"eval decode: {name} step+decode at 1 x 64 as CUDA-graph replays: {ms:.3f} ms "
          f"(median of {spans} spans of {n}, each span's wall over its steps; spans "
          f"{[round(w, 3) for w in walls]}, spread {max(walls) - min(walls):.3f}), "
          f"{audio_s / (ms / 1e3):.2f} audio-s trained and decoded per s; launches per "
          f"replayed step+decode {replayed} (expected {want}: {k9} 4 calls, 13 device "
          f"launches); {k9} in the run {launches[k9]} over {steps} steps; "
          f"{accounting_line(acct)}; losses finite {bool(torch.isfinite(rows).all())}; "
          f"{wave}", flush=True)
    if replayed != want or launches[k9] != 4 * steps or acct["captures"] != 1 \
            or not torch.isfinite(rows).all():
        raise AssertionError(f"eval decode: the {name} replays went wrong")
    busy = profile(lambda: runner.run(state, 3), 3 * ms / 1e3,
                   f"3 replayed {name} step+decodes at 1 x 64")
    print(f"eval decode: {name} 1 x 64 replays: "
          f"{decode_share(vocoder, fn.fake, None if busy is None else busy / 3)}", flush=True)
    step = as_train_step(cfg, fns[True])
    print(f"eval decode: {name} 1 x 64: one more step+decode, eagerly: "
          f"{check_stage_calls(lambda: step(state, runner.batch), name)}", flush=True)
    del state, runner, fns
    torch.cuda.empty_cache()
    return launches[k9]


def eval_decode_eager(pre, device, vocoder, dtype, batch: int, frames: int) -> None:
    """Step+decode a step at a time: the median of the steps after the
    warm-up ones (10 after 3 at batch 1, 3 after 2 at batch 32), host clock
    around each step ending in a synchronize; launches of one more, and a
    profile."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    warm, timed = (3, 10) if batch == 1 else (2, 3)
    cfg, banks = train_setup(pre, batch, frames, device, None if dtype == torch.float32 else dtype)
    state = create_train_state(cfg, 0, device)
    fn = StepAndDecode(cfg, vocoder)
    step = as_train_step(cfg, fn)
    batches = [sample_batch(step_generator(0, i, device), *banks, batch, frames, 25)
               for i in range(warm + timed + 1)]
    times = []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times[warm:]))
    reset_counts()
    state, m = step(state, batches[-1])
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    want = eval_decode_want(batch, frames, dtype)
    wave = check_waveform(fn.wav, batch, frames, dtype, f"{name} {batch} x {frames}")
    audio_s = batch * frames * HOP / SAMPLE_RATE
    print(f"eval decode: {name} step+decode at {batch} x {frames}, a step at a time: "
          f"{ms:.3f} ms (median of {timed} after {warm} warm-up, host clock; min "
          f"{min(times[warm:]):.3f}, max {max(times[warm:]):.3f}), "
          f"{audio_s / (ms / 1e3):.2f} audio-s trained and decoded per s; launches in one "
          f"{launches} (expected {want}); losses g {float(m['g_loss']):.4f} d "
          f"{float(m['d_loss']):.4f}; {wave}", flush=True)
    if launches != want or not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"eval decode: the {name} {batch} x {frames} step+decode "
                             f"launched {launches}")
    busy = profile(lambda: step(state, batches[0]), ms / 1e3,
                   f"one {name} step+decode at {batch} x {frames}")
    print(f"eval decode: {name} {batch} x {frames} a step at a time: "
          f"{decode_share(vocoder, fn.fake, busy)}; "
          f"{check_stage_calls(lambda: step(state, batches[1]), name)}", flush=True)
    del state, batches, fn
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Data parallel: --distributed at a world of one card
# ---------------------------------------------------------------------------

# NCCL's kernels: its ring and tree reductions (ncclDevKernel_*), and its
# one-rank reduction (onerank.cu), which a premultiplied sum runs on a world
# of one (parallel/mesh.py).
COLLECTIVE_KERNELS = r"nccl|onerank"
# The bf16 wire against the f32 plain run, steps 1-3 (deterministic cuDNN):
# the first step's G losses precede every gradient (1e-5, as the f32 wire);
# every later loss follows an update whose gradients were rounded to bf16 on
# the wire, which moves Adam's steps only where a gradient is within rounding
# of 0 (the port's CPU tests hold losses after an update at 1e-3).
DIST_BF16_RTOL = 1e-3
G_LOSSES = ("g_loss", "g_adv_loss", "g_cycle_loss", "g_identity_loss")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(world: int = 1, rank: int = 0, port: int = 0):
    """torchrun's environment for one process of ``world`` on card 0, a
    free port unless one is given; the caller's restored after."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port or free_port()))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def collective_time(fn, k: int):
    """(NCCL kernels, their device ms) in ``fn``'s run, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and re.search(COLLECTIVE_KERNELS, e.key):
            n += e.count
            us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return n, us / 1e3


def phase_distributed(pre: str, device, args: list, det: list) -> None:
    """The train CLI with --distributed on a world of this one card (NCCL,
    torchrun's environment set here), with deterministic cuDNN, one epoch,
    on an f32 and a bf16 gradient wire, --scan_epochs 1 and 0: launches
    per step as the plain run's, the losses against phase_train's
    deterministic plain runs (``det``, scan 1 and 0): f32 wire steps 1-3
    within 1e-5, the bf16 wire within DIST_BF16_RTOL. Then, outside the
    CLI, bf16 graph replays at 1 x 64 and 32 x 128 with and without the
    sync, in turns: the NCCL kernels inside each replayed graph, seen by the
    profiler (3 collectives a step: the G bucket, the D bucket, the
    metrics), their device ms, ms/step of both. Then two gloo ranks on the
    one card, eager, against the one-process batch-2 run."""
    steps = TRAIN_SPEAKER_UTTERANCES
    common = args + ["--num_epochs", "1", "--epochs_per_save", "1", "--epochs_per_plot", "100",
                     "--distributed"]
    want = {k: 0 for k in KERNELS}
    want.update({k: steps * n for k, n in per_step(1, 64).items()})
    torch.backends.cudnn.deterministic = True
    try:
        for wire in ("float32", "bfloat16"):
            for scan in (1, 0):
                name = f"dist_{wire}_{scan}"
                with torchrun_env():
                    reset_counts()
                    with graph_accounting() as acct:
                        losses = cli_losses(common + ["--name", name, "--scan_epochs", str(scan),
                                                      "--grad_allreduce_dtype", wire])
                        torch.cuda.synchronize()
                    launches = run_launches(acct)
                ref = det[0] if scan else det[1]
                rel = np.abs(losses - ref) / np.abs(ref)
                ckpt = os.path.join(args[args.index("--save_dir") + 1], name, "ckpts",
                                    "00001_state.npz")
                g_cols = [LOGGED_METRICS.index(k) for k in G_LOSSES]
                print(f"distributed: CLI --distributed, world 1 over NCCL, {wire} wire, "
                      f"--scan_epochs {scan}, deterministic cuDNN, {steps} steps: launches "
                      f"{launches} (expected {want}, the plain run's per step); "
                      f"{accounting_line(acct)}; logged losses against the plain run's: steps "
                      f"1-3 within {rel[:3].max():.3g} relative (step 1 G losses "
                      f"{rel[0, g_cols].max():.3g}), {rel.max():.3g} over the run; "
                      f"checkpoint written by rank 0: {os.path.exists(ckpt)}", flush=True)
                bound = 1e-5 if wire == "float32" else DIST_BF16_RTOL
                if launches != want or (scan and acct["replays"] != steps - 1) \
                        or losses.shape != ref.shape or not np.isfinite(losses).all() \
                        or rel[:3].max() > bound or rel[0, g_cols].max() > 1e-5 \
                        or not os.path.exists(ckpt):
                    raise AssertionError(f"the --distributed run ({wire} wire, --scan_epochs "
                                         f"{scan}) is not the plain run")
    finally:
        torch.backends.cudnn.deterministic = False

    for batch, frames, spans in ((1, 64, 3), (32, 128, 2)):
        dist_replays(pre, device, batch, frames, spans)
    dist_gloo_two_ranks(pre, args)


def dist_replays(pre: str, device, batch: int, frames: int, spans: int) -> None:
    """bf16 steps as CUDA-graph replays with and without the sync hooks of a
    world of one, in turns, spans of 20 steps (2 at 32 x 128); the launches
    per replayed step of both; the NCCL kernels in 5 replays (1 at 32 x
    128) of the synced graph and their device ms."""
    cfg, banks = train_setup(pre, batch, frames, device, torch.bfloat16)
    n = 20 if batch == 1 else 2
    with torchrun_env():
        created = initialize("cuda")
        try:
            grad_sync, metric_sync = explicit_sync_fns("float32")
            runs = {}
            for name, sync in (("plain", {}),
                               ("distributed", {"grad_sync": grad_sync,
                                                "metric_sync": metric_sync})):
                state = create_train_state(cfg, 0, device, capturable=True)
                update = make_update(cfg, **sync)
                runner = StepRunner(cfg, lambda step, u=update: u, *banks, 0, batch, frames, 25)
                with graph_accounting() as acct:
                    runner.run(state, 4)  # step 0 eager, then captured; 1-3 replayed
                    torch.cuda.synchronize()
                runs[name] = (state, runner, {k: v // acct["replays"]
                                              for k, v in acct["replayed"].items() if v})
            walls = {name: [] for name in runs}
            for i in range(spans):
                for name in (("plain", "distributed") if i % 2 == 0
                             else ("distributed", "plain")):
                    state, runner, _ = runs[name]
                    t0 = time.perf_counter()
                    rows = runner.run(state, n)
                    torch.cuda.synchronize()
                    walls[name].append(1e3 * (time.perf_counter() - t0) / n)
                    if not bool(torch.isfinite(rows).all()):
                        raise AssertionError(f"{name} replays at {batch} x {frames}: "
                                             "non-finite losses")
            state, runner, launches = runs["distributed"]
            k = 5 if batch == 1 else 1
            n_coll, coll_ms = collective_time(lambda: runner.run(state, k), k)
            g, d = state.g_params(), state.d_params()
            n_bytes = wire_bytes(g, None) + wire_bytes(d, None) + 4 * len(METRICS)
            med = {name: float(np.median(w)) for name, w in walls.items()}
            print(f"distributed: bf16 {batch} x {frames} as CUDA-graph replays, world 1, f32 "
                  f"wire: with the sync {med['distributed']:.3f} ms/step (spans "
                  f"{[round(w, 3) for w in walls['distributed']]}), without "
                  f"{med['plain']:.3f} ms/step (spans {[round(w, 3) for w in walls['plain']]}); "
                  f"{n_coll / k:g} NCCL kernels a replayed step (expected 3: the G bucket of "
                  f"{sum(p.numel() for p in g)} values, the D bucket of "
                  f"{sum(p.numel() for p in d)}, {len(METRICS)} metrics; {n_bytes} bytes on "
                  f"the wire a step), their device time {coll_ms / k:.4f} ms a step; launches "
                  f"per replayed step with the sync {launches} and without "
                  f"{runs['plain'][2]}", flush=True)
            if n_coll != 3 * k or launches != runs["plain"][2] \
                    or launches != per_step(batch, frames, torch.bfloat16):
                raise AssertionError(f"the synced graph at {batch} x {frames} does not hold "
                                     "its collectives or launches other kernels")
            profile(lambda: runner.run(state, k), med["distributed"] * k / 1e3,
                    f"{k} replayed synced bf16 steps at {batch} x {frames}")
        finally:
            finalize(created)
    del runs, state, runner
    torch.cuda.empty_cache()


GLOO_STEPS = TRAIN_SPEAKER_UTTERANCES // 2


def gloo_argv(pre: str, args: list, name: str) -> list:
    return args + ["--name", name, "--batch_size", "2", "--scan_epochs", "0",
                   "--num_epochs", "1", "--epochs_per_save", "1", "--epochs_per_plot", "100",
                   "--preprocessed_data_dir", pre]


def gloo_worker(rank: int, port: int, pre: str, args: list, out: str) -> None:
    """One of two gloo ranks sharing card 0 (``--gloo_worker``): the train
    CLI with --distributed, eager, deterministic cuDNN; its logged losses
    into ``out``."""
    torch.backends.cudnn.deterministic = True
    with torchrun_env(2, rank, port):
        created = initialize("cuda", backend="gloo")
        try:
            losses = cli_losses(gloo_argv(pre, args, "gloo2") + ["--distributed"])
        finally:
            finalize(created)
    np.save(out, losses)


def dist_gloo_two_ranks(pre: str, args: list) -> None:
    """Two gloo ranks on the one card (gloo carries CUDA tensors through the
    host), eager, batch 2 split one row a rank, against the one-process
    batch-2 run, both with deterministic cuDNN: the first step's G losses
    within 1e-5, every loss of the epoch within DIST_BF16_RTOL (the two sum
    in another order, which moves Adam only where a gradient is within
    rounding of 0)."""
    port = free_port()
    outs = [os.path.join(WORK, f"gloo_rank{r}.npy") for r in range(2)]
    logs = [os.path.join(WORK, f"gloo_rank{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gloo_worker", str(r), str(port),
                 pre, json.dumps(args), outs[r]], stdout=log, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        for r in range(2):
            with open(logs[r]) as f:
                print(f"distributed: gloo rank {r}'s output:\n{f.read()[-4000:]}", flush=True)
        raise AssertionError(f"the two gloo ranks exited {rcs}")
    wall = time.perf_counter() - t0
    two = np.load(outs[0])
    torch.backends.cudnn.deterministic = True
    try:
        one = cli_losses(gloo_argv(pre, args, "gloo1"))
    finally:
        torch.backends.cudnn.deterministic = False
    rel = np.abs(two - one) / np.abs(one)
    g_cols = [LOGGED_METRICS.index(k) for k in G_LOSSES]
    print(f"distributed: two gloo ranks on the one card, eager, batch 2 (a row a rank), "
          f"{len(two)} steps in {wall:.1f} s (process start included), against one process "
          f"at batch 2: step 1 G losses within {rel[0, g_cols].max():.3g} relative (bound "
          f"1e-5), every loss within {rel.max():.3g} (bound {DIST_BF16_RTOL:g}); rank 1 "
          f"logged the same losses: {bool(np.array_equal(np.load(outs[1]), two))}", flush=True)
    if two.shape != one.shape or len(two) != GLOO_STEPS or rel[0, g_cols].max() > 1e-5 \
            or rel.max() > DIST_BF16_RTOL or not np.array_equal(np.load(outs[1]), two):
        raise AssertionError("two gloo ranks disagree with one process")


# ---------------------------------------------------------------------------
# obs: the profiler's trace and step timer, and the NaN localizer, on the card
# ---------------------------------------------------------------------------

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
# A K2 row of this value overflows the f32 sum of its statistics: the mean
# is inf, the row's output NaN, in the kernel and its plain version alike.
OVERFLOW = 3e38


def trace_counts(log_dir: str):
    """(device events, {kernel: launches} by profiler.KERNEL_NAMES, cuDNN/cuBLAS
    kernels, the kernel names) of the one trace written under log_dir."""
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
               if f.endswith(".pt.trace.json")]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_EVENTS]
    names = [e["name"] for e in device if e["cat"] == "kernel"]
    per = {k: sum(bool(re.search(p, n)) for n in names) for k, p in profiler.KERNEL_NAMES.items()}
    convs = sum(bool(re.search(CONV_KERNELS, n)) for n in names)
    return len(device), {k: n for k, n in per.items() if n}, convs, names


def phase_obs(pre: str, device) -> None:
    """(a) obs.profiler.trace around 3 f32 1 x 64 steps, a step at a time:
    the trace's device events, its kernels by name against the launch
    counts, a cuDNN convolution; (b) obs.profiler.timed_steps over 20 chained
    steps beside phase_step_timing's median; (c) utils.debug.nan_debug_mode:
    one f32 and one bf16 step through the trainer with --scan_epochs 1 (a
    step at a time inside the mode), every launch's output checked; the
    mode's cost on a step; a K2 launch's own NaN named after its entry; a
    NaN made in a CUDA backward."""
    cfg, banks = train_setup(pre, 1, 64, device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    batches = [sample_batch(step_generator(0, i, device), *banks, 1, 64, 25) for i in range(24)]
    state, _ = step(state, batches[0])  # warm-up: cuDNN's algorithm choice, kernel loads
    torch.cuda.synchronize()

    log_dir = os.path.join(WORK, "trace")
    reset_counts()
    with profiler.trace(log_dir):
        for b in batches[1:4]:
            state, m = step(state, b)
    launched = {k: n for k, n in counts().items() if n}
    n_device, per, convs, names = trace_counts(log_dir)
    want = {k: 3 * n for k, n in per_step(1, 64).items()}
    print(f"obs: trace of 3 f32 1 x 64 steps: {n_device} device events, {len(names)} kernels; "
          f"the port's kernels by name {per} (launched {launched}, expected {want}); "
          f"cuDNN/cuBLAS kernels {convs}", flush=True)
    if n_device == 0 or launched != want or convs == 0 or per != launched:
        unnamed = sorted({n[:120] for n in names if "staged" in n or "ps_in" in n})
        raise AssertionError(f"the trace does not name the step's kernels: {unnamed[:8]}")

    state, per_s = profiler.timed_steps(step, state, batches[4:24])
    eager = STEP_MS.get(("f32", 1, 64))
    print(f"obs: timed_steps over 20 chained f32 1 x 64 steps: {1e3 * per_s:.3f} ms/step "
          f"(one float() of the smallest key's loss at the end); the step timing's median, "
          f"a step at a time: {eager:.3f} ms/step", flush=True)

    # The mode's cost: 3 steps outside it, 3 inside, each ending in a synchronize.
    walls = {}
    for inside in (False, True):
        times = []
        for b in batches[4:7]:
            t0 = time.perf_counter()
            with debug.nan_debug_mode() if inside else contextlib.nullcontext():
                state, m = step(state, b)
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[inside] = 1e3 * float(np.median(times))
    print(f"obs: nan_debug_mode on an f32 1 x 64 step: {walls[True]:.3f} ms against "
          f"{walls[False]:.3f} outside it (median of 3, host clock ending in a synchronize)",
          flush=True)
    del state, batches
    torch.cuda.empty_cache()

    # One step of each dtype through the trainer inside the mode.
    one = os.path.join(WORK, "nan_pre")
    for sid in ("VCC2SF3", "VCC2TF1"):
        mels, mean, std = load_speaker(pre, sid)
        save_speaker(one, sid, mels[:1], mean, std)
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(TrainerArgs(
            name=f"nan_{dtype}", save_dir=os.path.join(WORK, "nan_results"),
            preprocessed_data_dir=one, num_epochs=1, epochs_per_save=100,
            epochs_per_plot=100, steps_per_print=1, dtype=dtype, scan_epochs=True,
            async_save=False, device="cuda"))
        reset_counts()
        checked = []
        real_check = debug.check_kernel_outputs

        def check(symbol, *outputs):
            if debug.nan_debug_active():
                checked.append(symbol)
            real_check(symbol, *outputs)

        debug.check_kernel_outputs = check
        t0 = time.perf_counter()
        try:
            with debug.nan_debug_mode():
                trainer.train()
            torch.cuda.synchronize()
        finally:
            debug.check_kernel_outputs = real_check
        wall = time.perf_counter() - t0
        launched = {k: n for k, n in counts().items() if n}
        checked = len(checked)
        want = per_step(1, 64, getattr(torch, dtype))
        runner = trainer._runner
        print(f"obs: nan_debug_mode, one {dtype} 1 x 64 step through the trainer with "
              f"--scan_epochs 1: {wall:.1f} s (logger set-up included); step {trainer.state.step}; "
              f"replays {runner.replays}, graph captured {runner.graph is not None}; launches "
              f"{launched} (expected {want}); kernel outputs checked {checked}", flush=True)
        if trainer.state.step != 1 or runner.replays or runner.graph is not None \
                or launched != want or checked != sum(launched.values()):
            raise AssertionError(f"the {dtype} step under nan_debug_mode went wrong")

    # A K2 launch on finite input that the kernel itself turns into NaN.
    x = torch.randn(1, 8, 64, device=device)
    x[0, 3] = OVERFLOW
    s, b = torch.ones(8, device=device), torch.zeros(8, device=device)
    plain = in_gate.instance_norm_plain(x, s, b)
    kernel = in_gate.instance_norm(x, s, b)
    nan_rows = [int(torch.isnan(t[0]).any(-1).nonzero().flatten()[0]) if torch.isnan(t).any()
                else None for t in (plain, kernel)]
    try:
        with debug.nan_debug_mode():
            in_gate.instance_norm(x, s, b)
        named = None
    except FloatingPointError as e:
        named = str(e)
    print(f"obs: a K2 row of {OVERFLOW:g} (finite input): first NaN row of the plain version "
          f"{nan_rows[0]}, of the kernel {nan_rows[1]}; under nan_debug_mode: {named!r}",
          flush=True)
    if nan_rows != [3, 3] or named is None or not named.endswith("CUDA kernel in_forward"):
        raise AssertionError("K2's own NaN was not named after its entry")

    # A NaN made in the backward, on autograd's device thread.
    z = torch.zeros(3, device=device, requires_grad=True)
    try:
        with debug.nan_debug_mode():
            torch.linalg.norm(z).backward()
        named = None
    except FloatingPointError as e:
        named = str(e)
    print(f"obs: the gradient of the norm of zeros(3) on the card under nan_debug_mode: "
          f"{named!r}", flush=True)
    if named is None:
        raise AssertionError("a NaN made in a CUDA backward did not raise")


# ---------------------------------------------------------------------------
# pairwise: the launcher over three speakers (BASELINE config 4 at N = 3)
# ---------------------------------------------------------------------------

PAIR_SPEAKERS = ("VCC2SF3", "VCC2TF1", "VCC2SM3")
PAIR_UTTERANCES = 4


def phase_pairwise(device) -> None:
    """benchmarks/pairwise_run.py:35-80 with the port's modules: 3 synthetic
    speakers of 4 utterances, preprocessed on the card (K8), the launcher for
    host 0 of 1 at the published width (one train CLI process a pair, each
    one epoch), then each pair's checkpoint converted by the conversion CLI
    on the card; the dry runs of hosts 0 and 1 of 2 split the 3 pairs."""
    wavs, pre, save = (os.path.join(WORK, "pairwise", d) for d in ("wavs", "pre", "results"))
    make_corpus(wavs, speakers={s: DEFAULT_SPEAKERS[s] for s in PAIR_SPEAKERS},
                n_utts=PAIR_UTTERANCES, seed=2)
    reset_counts()
    mel_fn = preprocess_cli.make_mel_fn(device)
    kept = [preprocess_cli.preprocess_speaker(wavs, pre, sid, mel_fn, device)
            for sid in PAIR_SPEAKERS]
    k8 = melspec.LOG_MEL_KERNEL.launches
    print(f"pairwise: preprocessed {dict(zip(PAIR_SPEAKERS, kept))} utterances on the card, "
          f"{k8} K8 launches", flush=True)
    if kept != [PAIR_UTTERANCES] * 3 or k8 != 3 * PAIR_UTTERANCES:
        raise AssertionError("the pairwise corpus was not preprocessed on the card")

    pairs = launch_pairwise.pair_jobs(PAIR_SPEAKERS)
    base = ["--preprocessed_data_dir", pre, "--speaker_ids", *PAIR_SPEAKERS, "--save_dir", save]
    shards = []
    for host in (0, 1):
        out = _run_cli(launch_pairwise.main,
                       base + ["--host_index", str(host), "--num_hosts", "2", "--dry_run"])
        shards.append([tuple(line.split("--speaker_A_id ")[1].split()[0:3:2])
                       for line in out.splitlines() if "--speaker_A_id" in line])
    print(f"pairwise: --dry_run, hosts 0 and 1 of 2: {shards}", flush=True)
    if set(shards[0]) & set(shards[1]) or sorted(shards[0] + shards[1]) != pairs:
        raise AssertionError("the two hosts' shards do not partition the pairs")

    # Each job a train CLI process on the card, its output in a log; the
    # children import the package from this checkout.
    walls, logs = [], []

    def timed_run(cmd, **kwargs):
        logs.append(os.path.join(WORK, "pairwise", f"job{len(logs)}.log"))
        t0 = time.perf_counter()
        with open(logs[-1], "w") as log:
            try:
                return subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, **kwargs)
            except subprocess.CalledProcessError:
                with open(logs[-1]) as f:
                    print(f"pairwise: job {len(logs)}'s output:\n{f.read()[-4000:]}", flush=True)
                raise
            finally:
                walls.append(time.perf_counter() - t0)

    saved_path = os.environ.get("PYTHONPATH")
    launch_pairwise.subprocess = types.SimpleNamespace(run=timed_run)
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, saved_path) if p)
    torch.cuda.empty_cache()
    try:
        printed = _run_cli(launch_pairwise.main, base + [
            "--host_index", "0", "--num_hosts", "1", "--", "--num_epochs", "1",
            "--batch_size", "1", "--epochs_per_save", "1", "--epochs_per_plot", "100000",
            "--steps_per_print", "1"])
    finally:
        launch_pairwise.subprocess = subprocess
        if saved_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_path
    print(f"pairwise: launcher, host 0 of 1: {printed.splitlines()[0]}; each job's wall "
          f"(process start, state creation, {PAIR_UTTERANCES} steps as CUDA-graph replays "
          f"after the first, checkpoint write): {[round(w, 1) for w in walls]} s", flush=True)

    for a, b in pairs:
        name = f"mask_cyclegan_vc_{a}_{b}"
        ckpt_dir = os.path.join(save, name, "ckpts")
        with open(logs[pairs.index((a, b))]) as f:
            last = [line for line in f.read().splitlines() if "g_loss" in line][-1:]
        with open(os.path.join(save, name, f"{name}.log")) as f:
            epoch = [line for line in f.read().splitlines() if "epoch 1 done" in line]
        if not os.path.exists(os.path.join(ckpt_dir, "00001_state.npz")):
            raise AssertionError(f"no checkpoint for the pair {a}<->{b}")
        reset_counts()
        t0 = time.perf_counter()
        _run_cli(convert_main, ["--name", name, "--save_dir", save, "--preprocessed_data_dir",
                                pre, "--speaker_A_id", a, "--speaker_B_id", b, "--ckpt_dir",
                                ckpt_dir, "--load_epoch", "1", "--device", "cuda"])
        wall = time.perf_counter() - t0
        launched = {k: n for k, n in counts().items() if n}
        src = load_speaker(pre, a)[0]
        outs = [np.load(os.path.join(save, name, "converted_audio_1",
                                     f"{i}-converted_{a}_to_{b}.npy")) for i in range(len(src))]
        ok = all(o.shape == m.shape and np.isfinite(o).all() for o, m in zip(outs, src))
        want = {k: len(src) * n for k, n in PER_FORWARD.items()}
        print(f"pairwise: {a}<->{b}: 00001_state.npz; its last logged step {last}; "
              f"{epoch} (the train log's time of the epoch, its checkpoint write started); the "
              f"conversion CLI on the card converted {len(outs)} utterances of "
              f"{[m.shape[1] for m in src]} frames in {wall:.1f} s, finite and of the input's "
              f"shape: {ok}; launches {launched} (expected {want})", flush=True)
        if not ok or len(outs) != PAIR_UTTERANCES or launched != want:
            raise AssertionError(f"the pair {a}<->{b} did not convert on the card")


def measure_shuffles(sites, device):
    """K6 on every inverse-shuffle site, and K7 at the transposed shape, in
    the site's dtype: exact against their plain versions, on the vector
    route (16-byte units), with times and the bound (two element sizes an
    element, no arithmetic)."""
    gen = torch.Generator(device=device).manual_seed(3)
    records = {}
    for site in (s for s in sites.values() if base_name(s.kernel) == "inv_shuffle"):
        B, C, H2, W2 = site.shape
        dtype = dtype_of(site.kernel)
        for name, shape in (("inv_shuffle", site.shape), ("shuffle", (B, 4 * C, H2 // 2, W2 // 2))):
            name = entry_name(name, dtype)
            spec = KERNELS[name]
            t = torch.randn(shape, device=device, generator=gen).to(dtype)
            before = route_counts()
            got, want = spec["fn"](t), spec["plain"](t)
            torch.cuda.synchronize()
            route = " ".join(k.split("/")[1] for k, n in route_counts().items()
                             if n > before.get(k, 0))
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at {shape}: max abs err {err:.3g}, not exact")
            if route != "vector":
                raise AssertionError(f"{name} at {shape} took the {route} route, not vector")
            ms = device_ms(lambda: spec["fn"](t), 10)
            plain_ms = device_ms(lambda: spec["plain"](t), 10)
            lib_ms = device_ms(lambda: spec["library"](t), 10)
            if got.dtype != dtype:
                raise AssertionError(f"{name} returned {got.dtype} for {dtype}")
            nbytes = 2 * t.element_size() * t.numel()
            b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            print(f"kernels: train 1x320/step {name:16s} in {str(shape):22s} x{site.count} "
                  f"route {route} max_abs_err {err:.3g} (exact) ms {ms:.5f} "
                  f"plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} "
                  f"bound_us {1e3 * b_ms:.3f} (bytes; "
                  f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s achieved)", flush=True)
            r = records.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                              bound_ms=0.0, max_abs_err=0.0, bound_by="bytes",
                                              launches=0))
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms)):
                r[k] += site.count * v
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["launches"] += site.count
            del t, got, want
    for k, r in records.items():
        print(f"kernels: train 1x320/step {k} sum: {r['launches']} sites ms {r['ms']:.5f} "
              f"plain_ms {r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
              f"bound_ms {r['bound_ms']:.5f} (bytes)", flush=True)
    return records


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo_worker":
        rank, port, pre, args, out = sys.argv[2:7]
        gloo_worker(int(rank), int(port), pre, json.loads(args), out)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU", file=sys.stderr)
        return 1
    # The CPU references (the preprocess CLI on the CPU, the CPU decode and
    # step) run on one intra-op thread: with several, the first call of an
    # elementwise op in a process put one thread's rows ~1e-4 relative off
    # in 1 of 64 fresh processes (the plain frontend's sqrt; never on one
    # thread: scripts/preprocess_flake_probe.py --first_call).
    torch.set_num_threads(1)
    smi = nvidia_smi()
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
          f"nvidia-smi: {smi}", flush=True)
    device = resolve_device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    start = last = time.perf_counter()

    def took(what: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"time: {what} {now - last:.1f} s (script {now - start:.1f} s)", flush=True)
        last = now

    t0 = time.perf_counter()
    logs = cuda_lib.build(["in_gate", "ps_in_swish", "melspec", "melgan_stack",
                           "pixel_shuffle"])
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    took("build")
    audio_pre, log_mel_launches, mel_inputs = phase_preprocess(device)
    took("preprocess")
    convert_sites, convert_routes = phase_convert(device)
    took("convert")
    vocoder_ckpt, stack_launches, stage_calls = phase_decode(
        device, audio_pre, os.path.join(WORK, "ckpts"))
    took("decode")
    phase_hifigan(device, audio_pre, os.path.join(WORK, "ckpts"))
    took("hifigan")
    launches, pre, train_args, f32_losses, det_losses = phase_train(device, vocoder_ckpt)
    took("train")
    launches.update({k: n for k, n in phase_train_bf16(device, pre, train_args, f32_losses)
                     .items() if k.endswith("_bf16")})
    took("train bf16")
    phase_cross_step(pre, device)
    took("cross step")
    per_step1, sites1 = phase_step_timing(pre, device, 1, 64, graph_spans=3)
    per_step32, sites32 = phase_step_timing(pre, device, 32, 128, graph_spans=2)
    took("f32 step timing")
    bf16 = torch.bfloat16
    bf16_step1, bf16_sites1 = phase_step_timing(pre, device, 1, 64, 3, dtype=bf16)
    bf16_step32, bf16_sites32 = phase_step_timing(pre, device, 32, 128, 2, dtype=bf16)
    per_step1.update(bf16_step1)
    per_step32.update(bf16_step32)
    took("bf16 step timing")
    # TF32: 1 x 64 as graph replays only, 32 x 128 a step at a time only.
    phase_step_timing(pre, device, 1, 64, 3, precision="tensorfloat32", eager=False)
    phase_step_timing(pre, device, 32, 128, precision="tensorfloat32")
    took("TF32 step timing")
    long_launches, sites320, split_times, long_per = phase_long_crops(pre, device)
    took("long crops")
    bf16_long_launches, bf16_sites320, bf16_long_per = phase_long_crops_bf16(pre, device)
    long_launches.update({k: n for k, n in bf16_long_launches.items() if k.endswith("_bf16")})
    took("long crops bf16")
    eval_launches, bf16_stage_calls = phase_eval_decode(pre, audio_pre, device, vocoder_ckpt)
    took("eval decode")
    phase_distributed(pre, device, train_args, det_losses)
    took("distributed")
    phase_obs(pre, device)
    took("obs")
    phase_pairwise(device)
    took("pairwise")

    measure_sites(convert_sites, device, "convert/forward")
    step1 = measure_sites(sites1, device, "train 1x64/step")
    step32 = measure_sites(sites32, device, "train 32x128/step")
    step1.update(measure_sites(bf16_sites1, device, "train bf16 1x64/step"))
    step32.update(measure_sites(bf16_sites32, device, "train bf16 32x128/step"))
    shuffles = measure_shuffles(sites320, device)
    shuffles.update(measure_shuffles(bf16_sites320, device))
    audio = {"log_mel": (measure_log_mel(mel_inputs, device), log_mel_launches),
             "melgan_stack": (measure_resstack(stage_calls, device), stack_launches),
             "melgan_stack_bf16": (measure_resstack(bf16_stage_calls, device), eval_launches)}
    took("kernels")

    # K1-K5 and K1-K3's backwards, f32 then bf16: launches, the main path's
    # CLI run (phase_train, phase_train_bf16); ms, plain_ms, library_ms and
    # bound_ms summed over one 1 x 64 step's sites, with the 32 x 128 step's
    # beside them.
    kernels = []
    for k in (*NORM_KERNELS, *(f"{k}_bf16" for k in NORM_KERNELS)):
        spec, r = KERNELS[k], step1[k]
        kernels.append({
            "name": k, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[k],
            "launches_per_step": per_step1[k], "launches_per_step_32x128": per_step32[k],
            "max_abs_err": max(r["max_abs_err"], step32[k]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ms_32x128": step32[k]["ms"], "bound_ms_32x128": step32[k]["bound_ms"]})
        if base_name(k) in ROUTED:
            # K1's, K2's, K3's and K4's launches by route in one eager step
            # at each size and (K1, K2, K4) in one 431-frame conversion: all
            # bulk-copied (K5 has one route).
            kernels[-1].update({
                f"routes_per_step{size}": {r: n for r, n in per.items()
                                           if r.startswith(f"{k}/")}
                for size, per in (("", per_step1), ("_32x128", per_step32))})
            if k in PER_FORWARD:
                kernels[-1]["routes_per_conversion"] = {
                    r: n for r, n in convert_routes.items() if r.startswith(f"{k}/")}
    # K6, K7: ms, plain_ms, library_ms and bound_ms summed over the 1 x 320
    # step's K6 sites (K7 at the transposed shapes): six in f32, three in
    # bf16; launches: the long-crop runs' (K7 is on no path: K6's gradient,
    # launched only by the kernels phase and the card tests); launches per
    # step at each size its dtype ran (f32 1 x 192 and 1 x 320, bf16 1 x 320).
    per_size = {torch.float32: long_per, torch.bfloat16: bf16_long_per}
    for k in ("inv_shuffle", "shuffle", "inv_shuffle_bf16", "shuffle_bf16"):
        r = shuffles[k]
        kernels.append({
            "name": k, "route": "cuda", "source": KERNELS[k]["source"],
            "replaces": KERNELS[k]["replaces"], "launches": long_launches[k],
            **{f"launches_per_step_{size}": counts.get(k, 0)
               for size, counts in per_size[dtype_of(k)].items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # K8: ms, plain_ms and bound_ms summed over the preprocess run's calls;
    # K9: over the four calls of one 431-frame decode (bf16: the bf16
    # vocoder's). launches: the preprocess run's, the decode run's and, for
    # bf16 K9, the bf16 1 x 64 step+decode replays' counts.
    for k, (r, n) in audio.items():
        kernels.append({
            "name": k, "route": "cuda", "source": KERNELS[k]["source"],
            "replaces": KERNELS[k]["replaces"], "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels, "split_route_1x320_upsample2": split_times}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
