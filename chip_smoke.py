#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of the repository:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. env      torch and CUDA versions, the card's name and power limit.
2. build    nvcc builds every kernel source in csrc/, all at once.
3. convert  the conversion CLI (cli/test.py main, --device cuda) on a
            full-width generator with seeded random weights, written as a
            JAX-layout checkpoint, over 5 synthetic utterances; the launch
            counts of the run, the output held against the CPU plain path,
            and the per-utterance latency.
4. train    the train CLI (cli/train.py main, --device cuda) at full width
            on two synthetic speakers, 2 epochs then resumed to 3; the
            launch counts of the run; one step on the card held against the
            same step on the CPU (losses and Adam's first moments, the
            gradients' image); ms/step and audio-seconds trained per second
            at batch 1 x 64 and 32 x 128 with each step's launch counts,
            peak memory and a profiler breakdown.
5. kernels  each kernel against its plain PyTorch version on the card, with
            its time, the plain version's, the library call's where one
            exists, and its bound, at every call site recorded in one
            431-frame conversion (unmasked and with the call's lengths) and
            in one training step at each size (unmasked and with lengths
            one frame short). The fused backward is also held against
            autograd through the plain forward.

The last three lines are the kernels' JSON record, the card as nvidia-smi
names it, and {"ok": true, "device": {...}}. Working files go to
build/chip_smoke/ (listed in .gitignore).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.cli.test import main as convert_main
from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.cli.train import main as train_main
from maskcyclegan_vc_tpu_torch.data.dataset import (
    MelBank,
    load_speaker,
    sample_batch,
    save_speaker,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.io.checkpoint import save_checkpoint
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    generator_params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.ops import cuda_lib, in_gate, ps
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import make_train_step
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
TOL = dict(atol=1e-5, rtol=1e-5)  # kernel vs plain, f32: reduction order only
N_PARAMS = 24_537_729
N_PARAMS_D, N_PARAMS_D_LIVE = 16_691_713, 6_202_881
HOP, SAMPLE_RATE = 256, 22050
UTTERANCE_FRAMES = (173, 260, 345, 431, 517)  # 2-6 s, VCC2018-like
PER_FORWARD = {"in_glu": 8, "in": 8, "ps_in_swish": 2}
# One training step at batch 1 (pair_forwards on, identity on): 6 G
# forwards, 3 with grad, and 8 D forwards; at batch 32 (pair_forwards
# off): 10 G forwards, 6 with grad, and 12 D forwards.
PER_STEP = {1: {"in_glu": 48, "in": 48, "in_swish": 24, "ps_in_swish": 12,
                "ps_in_swish_bwd": 6},
            32: {"in_glu": 80, "in": 80, "in_swish": 36, "ps_in_swish": 20,
                 "ps_in_swish_bwd": 12}}
TRAIN_SPEAKER_UTTERANCES = 8
# Card vs CPU, per leaf of Adam's first moment after one step
# (phase_cross_step): G's gradients differ by summation order amplified by
# the chained norms (median 1.8e-5, worst 6.1e-4 measured on an H100); D's
# also see fakes from generators that already differ by the sign flips of
# near-zero gradients (median 6.8e-4, worst 1.6e-3). A faulty kernel or
# backward gives O(1).
MOMENT_BOUND = {"g": 5e-3, "d": 1e-2}


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
    the ones the real call graph produces."""
    kernel_names = {in_gate.IN_GLU_KERNEL.symbol: "in_glu", in_gate.IN_KERNEL.symbol: "in",
                    in_gate.IN_SWISH_KERNEL.symbol: "in_swish"}
    sites = {}

    def record(kernel, x, lengths):
        if x.device.type == "cuda":
            lens = None if lengths is None else tuple(lengths.tolist())
            key = (kernel, tuple(x.shape), lens)
            sites.setdefault(key, Site(*key, 0)).count += 1

    launch_rows, forward, backward = (in_gate._launch_rows, ps._forward,
                                      ps.pixel_shuffle_in_swish_backward)

    def rec_launch_rows(kernel, x, vecs, lengths, out_channels):
        record(kernel_names[kernel.symbol], x, lengths)
        return launch_rows(kernel, x, vecs, lengths, out_channels)

    def rec_forward(x, scale, bias, lengths=None, stats=False):
        record("ps_in_swish", x, lengths)
        return forward(x, scale, bias, lengths, stats)

    def rec_backward(x, dy, *args):
        record("ps_in_swish_bwd", x, None)
        return backward(x, dy, *args)

    in_gate._launch_rows, ps._forward = rec_launch_rows, rec_forward
    ps.pixel_shuffle_in_swish_backward = rec_backward
    try:
        yield sites
    finally:
        in_gate._launch_rows, ps._forward = launch_rows, forward
        ps.pixel_shuffle_in_swish_backward = backward


def site_counts(sites) -> dict:
    counts = {}
    for s in sites.values():
        counts[s.kernel] = counts.get(s.kernel, 0) + s.count
    return counts


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
}


def out_shape(kernel: str, shape: tuple) -> tuple:
    if kernel == "in_glu":
        return (shape[0], shape[1] // 2) + shape[2:]
    if kernel == "ps_in_swish":
        return (shape[0], shape[1] // 4, 2 * shape[2], 2 * shape[3])
    return shape


def bound_ms(kernel: str, shape: tuple, n_vecs: int):
    """The least time for the work: each input read once, each output
    written once, over the memory rate; or the flops over the f32 rate.
    The fused backward reads x and dy and writes dx (three tensors of x's
    size) plus the per-sample statistics in and dscale, dbias out."""
    n_in = int(np.prod(shape))
    C = out_shape(kernel, shape)[1]
    if kernel == "ps_in_swish_bwd":
        n_out, C = n_in, C // 4
        nbytes = 4 * (3 * n_in + n_vecs * C + 4 * shape[0] * C)
    else:
        n_out = int(np.prod(out_shape(kernel, shape)))
        nbytes = 4 * (n_in + n_out + n_vecs * C)
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
    if site.kernel == "ps_in_swish_bwd":
        C = site.shape[1] // 4
    x = torch.randn(site.shape, device=device, generator=gen) * 2.0 + 0.5
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
    full = site.shape[-1] * (2 if site.kernel == "ps_in_swish" else 1)
    return torch.full((site.shape[0],), full - 1, dtype=torch.int32, device=device)


def check_forward(site: Site, x, vecs, device):
    """max abs err of the kernel against its plain version, unmasked and
    with the site's lengths; for K4 also its statistics output."""
    spec = KERNELS[site.kernel]
    lengths = site_lengths(site, device)
    err = 0.0
    checks = [(spec["fn"](x, *vecs, lens), spec["plain"](x, *vecs, lens), f"lengths={lens}")
              for lens in (None, lengths)]
    if site.kernel == "ps_in_swish":
        _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, *vecs)
        want_mean, want_inv = ps.pixel_shuffle_stats_plain(x)
        checks += [(mean, want_mean, "mean"), (inv, want_inv, "inv")]
    for got, want, what in checks:
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not torch.allclose(got, want, **TOL):
            raise AssertionError(f"{site.kernel} at {site.shape} {what}: "
                                 f"max abs err {e:.3g} > {TOL}")
        err = max(err, e)
    return err, lengths


def check_backward(site: Site, x, vecs, device, gen):
    """K5 against its plain version and against autograd through the plain
    forward. dx: atol = rtol = 1e-5. dscale and dbias sum n = 4HW terms per
    (sample, channel) and again over the batch, in another order than the
    plain version (up to 10,240 terms at 128 frames): f32 summation error
    grows with the sum of the terms' magnitudes, so they are held to 1e-5
    of that sum (with 4|dy| standing for |dz * xhat|)."""
    s, b = vecs
    B, C4, H, W = site.shape
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device, generator=gen)
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    got = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    auto = torch.autograd.grad(ps.pixel_shuffle_in_swish_plain(xr, sr, br), (xr, sr, br), dy)
    torch.cuda.synchronize()
    bound = 4e-5 * F.pixel_unshuffle(dy, 2).reshape(B, C4 // 4, -1).abs().sum((0, 2))
    err, worst = 0.0, 0.0
    for ref, what in ((want, "plain"), (auto, "autograd")):
        e = (got[0] - ref[0]).abs().max().item()
        if not torch.allclose(got[0], ref[0], **TOL):
            raise AssertionError(f"K5 dx at {site.shape} vs {what}: "
                                 f"max abs err {e:.3g} > {TOL}")
        err = max(err, e)
        for i in (1, 2):
            ratio = ((got[i] - ref[i]).abs() / bound).max().item()
            if ratio > 1.0:
                raise AssertionError(f"K5 d{'scale' if i == 1 else 'bias'} at {site.shape} "
                                     f"vs {what}: {ratio:.3g} of the summation bound")
            worst = max(worst, ratio)
    return err, worst, (x, dy, s, b, mean, inv)


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
        if site.kernel == "ps_in_swish_bwd":
            err, ratio, args = check_backward(site, x, vecs, device, gen)
            ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward(*args), reps)
            plain_ms = device_ms(lambda: ps.pixel_shuffle_in_swish_backward_plain(*args), reps)
            eager_ms = call_ms(lambda: ps.pixel_shuffle_in_swish_backward(*args))
            lib_ms = None
            extra = f"dscale/dbias at {ratio:.3g} of their summation bound "
        else:
            err, lengths = check_forward(site, x, vecs, device)
            ms = device_ms(lambda: spec["fn"](x, *vecs), reps)
            ms_masked = device_ms(lambda: spec["fn"](x, *vecs, lengths), reps)
            plain_ms = device_ms(lambda: spec["plain"](x, *vecs), reps)
            lib_ms = (device_ms(lambda: spec["library"](x, *vecs), reps)
                      if spec["library"] else None)
            eager_ms = call_ms(lambda: spec["fn"](x, *vecs))
        b_ms, bound_by = bound_ms(site.kernel, site.shape, spec["n_vecs"])
        masked = "" if site.lengths is None else f"lengths {list(site.lengths)} "
        print(f"kernels: {label} {site.kernel:15s} in {str(site.shape):22s} {masked}"
              f"x{site.count} max_abs_err {err:.3g} (tol atol=rtol=1e-5) {extra}"
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

    for spec in KERNELS.values():
        spec["counter"].launches = 0
    convert_main(["--name", "smoke", "--save_dir", save, "--preprocessed_data_dir", pre,
                  "--ckpt_dir", ckpts, "--load_epoch", "1",
                  "--model_name", "generator_A2B", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k: KERNELS[k]["counter"].launches for k in PER_FORWARD}
    n_utt = len(UTTERANCE_FRAMES)
    want_launches = {k: PER_FORWARD[k] * n_utt for k in PER_FORWARD}
    print(f"convert: launches {launches} (expected {want_launches})", flush=True)
    if launches != want_launches:
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
    with recording_sites() as sites:
        convert(mels["VCC2SF3"][i431])
    if site_counts(sites) != PER_FORWARD:
        raise AssertionError(f"one conversion launched {site_counts(sites)}")
    return sites


def profile(fn, wall_s: float, what: str) -> None:
    """Where one call's time goes: device time by kernel from torch.profiler,
    grouped, against the unprofiled wall time."""
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
        return
    groups = {
        "the port's kernels": r"in_kernel|ps_in_swish",
        "convolutions (cuDNN)": r"conv|xmma|gemm|cudnn|wgrad|dgrad|fprop|winograd|implicit",
        "Adam (foreach)": r"multi_tensor_apply|foreach",
    }
    sums = {g: [0.0, 0] for g in groups}
    sums["other (eager IN backwards, losses, copies, elementwise)"] = [0.0, 0]
    for key, count, us in rows:
        g = next((g for g, pat in groups.items() if re.search(pat, key)),
                 "other (eager IN backwards, losses, copies, elementwise)")
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


def _log_losses(path: str):
    rows = [line for line in open(path) if line.startswith("[epoch")]
    vals = [float(v) for line in rows for v in re.findall(r": (\S+)", line)
            if not v.startswith("(")]
    return rows, vals


def phase_train(device):
    pre, save = os.path.join(WORK, "train_pre"), os.path.join(WORK, "train_results")
    rs = np.random.RandomState(1)
    for sid in ("VCC2SF3", "VCC2TF1"):
        lens = rs.randint(128, 518, size=TRAIN_SPEAKER_UTTERANCES)
        save_speaker(pre, sid, [rs.randn(80, t).astype(np.float32) for t in lens],
                     rs.randn(80, 1).astype(np.float32),
                     (rs.rand(80, 1) + 0.5).astype(np.float32))
    args = ["--name", "smoke", "--save_dir", save, "--preprocessed_data_dir", pre,
            "--device", "cuda", "--batch_size", "1", "--num_frames", "64",
            "--epochs_per_save", "1", "--epochs_per_plot", "2", "--steps_per_print", "1"]

    # The slice's main path: train through the CLI, then resume. Counts
    # from 0 just before, read just after.
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    t0 = time.perf_counter()
    train_main(args + ["--num_epochs", "2"])
    t1 = time.perf_counter()
    train_main(args + ["--num_epochs", "3", "--continue_train"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: spec["counter"].launches for k, spec in KERNELS.items()}
    steps = 3 * TRAIN_SPEAKER_UTTERANCES
    # Plots at epoch 2: two conversions, each one generator forward.
    want = {k: steps * n + 2 * PER_FORWARD.get(k, 0) for k, n in PER_STEP[1].items()}
    print(f"train: CLI, 2 epochs {t1 - t0:.1f} s, resumed to epoch 3 {t2 - t1:.1f} s "
          f"(state creation, checkpoint writes and reads included); launches {launches} "
          f"(expected {want}: {steps} steps and 2 plot conversions)", flush=True)
    if launches != want:
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
    return launches, pre


def train_setup(pre: str, batch: int, frames: int, device):
    banks = [MelBank.from_list(load_speaker(pre, sid)[0], frames, device)
             for sid in ("VCC2SF3", "VCC2TF1")]
    sched = ScheduleConfig(n_samples=len(banks[0]), batch_size=batch)
    cfg = TrainConfig(schedule=sched, num_frames=frames)
    return cfg, banks


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


def phase_step_timing(pre: str, device, batch: int, frames: int):
    """ms/step of the step function at one size: the median of 20 steps
    after 5 warm-up steps, host clock around each step ending in a
    synchronize. The launch counts of one step and its kernel sites, as
    recorded, peak memory and a profile."""
    cfg, banks = train_setup(pre, batch, frames, device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    batches = [sample_batch(step_generator(0, i, device), *banks, batch, frames, 25)
               for i in range(26)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(25):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times[5:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    with recording_sites() as sites:
        state, m = step(state, batches[25])
        torch.cuda.synchronize()
    launches = {k: spec["counter"].launches for k, spec in KERNELS.items()}
    audio_s = batch * frames * HOP / SAMPLE_RATE
    print(f"train: step at batch {batch} x {frames} frames (pair_forwards "
          f"{cfg.pair_forwards_resolved()}): {ms:.3f} ms/step (median of 20 after 5 "
          f"warm-up, host clock; min {1e3 * min(times[5:]):.3f}, max "
          f"{1e3 * max(times[5:]):.3f}), {audio_s / (ms / 1e3):.2f} audio-s trained per s, "
          f"peak memory {peak:.2f} GiB; launches in one step {launches} "
          f"(expected {PER_STEP[batch]}); losses g {float(m['g_loss']):.4f} "
          f"d {float(m['d_loss']):.4f}", flush=True)
    if launches != PER_STEP[batch] or site_counts(sites) != launches:
        raise AssertionError(f"one step at batch {batch} launched {launches}, "
                             f"recorded {site_counts(sites)}")
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"non-finite metrics at batch {batch}: {m}")
    profile(lambda: step(state, batches[0]), ms / 1e3,
            f"one training step at batch {batch} x {frames}")
    del state, batches
    torch.cuda.empty_cache()
    return launches, sites


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
          f"nvidia-smi: {smi}", flush=True)
    device = resolve_device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)

    t0 = time.perf_counter()
    logs = cuda_lib.build(["in_gate", "ps_in_swish"])
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    convert_sites = phase_convert(device)
    launches, pre = phase_train(device)
    phase_cross_step(pre, device)
    per_step1, sites1 = phase_step_timing(pre, device, 1, 64)
    per_step32, sites32 = phase_step_timing(pre, device, 32, 128)

    t0 = time.perf_counter()
    measure_sites(convert_sites, device, "convert/forward")
    step1 = measure_sites(sites1, device, "train 1x64/step")
    step32 = measure_sites(sites32, device, "train 32x128/step")
    print(f"kernels: phase took {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    for k, spec in KERNELS.items():
        r = step1[k]
        kernels.append({
            "name": k, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[k],
            "launches_per_step": per_step1[k], "launches_per_step_32x128": per_step32[k],
            "max_abs_err": max(r["max_abs_err"], step32[k]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ms_32x128": step32[k]["ms"], "bound_ms_32x128": step32[k]["bound_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
