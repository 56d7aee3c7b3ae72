#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of the repository:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. env      torch and CUDA versions, the card's name and power limit.
2. build    nvcc builds every kernel source in csrc/, all at once.
3. kernels  each kernel against its plain PyTorch version on the card, at
            the full-width generator's shapes for a 448-frame bucket,
            unmasked and with lengths for a 431-frame utterance; its time,
            the plain version's, the library call's where one exists, and
            its memory bound.
4. convert  the conversion CLI (cli/test.py main, --device cuda) on a
            full-width generator with seeded random weights, written as a
            JAX-layout checkpoint, over 5 synthetic utterances; the launch
            counts of the run, the output held against the CPU plain path,
            and the per-utterance latency.

The last three lines are the kernels' JSON record, the card as nvidia-smi
names it, and {"ok": true, "device": {...}}. Working files go to
build/chip_smoke/ (listed in .gitignore).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.cli.test import main as convert_main
from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker
from maskcyclegan_vc_tpu_torch.io.checkpoint import save_checkpoint
from maskcyclegan_vc_tpu_torch.io.jax_params import generator_params_to_jax
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.models.generator import strided_len
from maskcyclegan_vc_tpu_torch.ops import cuda_lib, in_gate, ps
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
TOL = dict(atol=1e-5, rtol=1e-5)  # kernel vs plain, f32: reduction order only
N_PARAMS = 24_537_729
HOP, SAMPLE_RATE = 256, 22050
UTTERANCE_FRAMES = (173, 260, 345, 431, 517)  # 2-6 s, VCC2018-like
PER_FORWARD = {"in_glu": 8, "in": 8, "ps_in_swish": 2}


@dataclasses.dataclass
class TrainState:
    """The JAX trainer's checkpoint root: its field gives the ``.g_params``
    key prefix of a checkpoint that trainer writes."""
    g_params: dict


@dataclasses.dataclass
class Site:
    kernel: str        # key of KERNELS
    name: str          # call site in the generator
    shape: tuple       # kernel input
    length: int        # valid frames on the kernel's time axis
    count: int         # calls per forward


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sites_for_bucket(T: int, t: int, R: int = 256, M: int = 80, blocks: int = 6):
    """The kernels' call sites in one forward of a T-frame bucket that holds
    a t-frame utterance, with the valid length each receives."""
    l1 = strided_len(t)
    l2 = strided_len(l1)
    return [
        Site("in_glu", "downSample1", (1, 2 * R, M // 2, T // 2), l1, 1),
        Site("in_glu", "downSample2", (1, 2 * R, M // 4, T // 4), l2, 1),
        Site("in_glu", "residual conv1d_layer", (1, 4 * R, T // 4), l2, blocks),
        Site("in", "conv2dto1dLayer_tfan", (1, R, T // 4), l2, 1),
        Site("in", "residual conv1d_out_layer", (1, R, T // 4), l2, blocks),
        Site("in", "conv1dto2dLayer_tfan", (1, (M // 4) * R, T // 4), l2, 1),
        Site("ps_in_swish", "upSample1", (1, 4 * R, M // 4, T // 4), min(2 * l2, T // 2), 1),
        Site("ps_in_swish", "upSample2", (1, 2 * R, M // 2, T // 2), min(4 * l2, T), 1),
    ]


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
    "ps_in_swish": dict(
        counter=ps.PS_IN_SWISH_KERNEL, fn=ps.pixel_shuffle_in_swish,
        plain=ps.pixel_shuffle_in_swish_plain, library=None, n_vecs=2,
        source="maskcyclegan_vc_tpu_torch/csrc/ps_in_swish.cu",
        replaces="maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:344 (subpixel_in_swish :371)",
        flops_per_out=10),
}


def out_shape(kernel: str, shape: tuple) -> tuple:
    if kernel == "in_glu":
        return (shape[0], shape[1] // 2) + shape[2:]
    if kernel == "ps_in_swish":
        return (shape[0], shape[1] // 4, 2 * shape[2], 2 * shape[3])
    return shape


def bound_ms(kernel: str, shape: tuple, n_vecs: int):
    """The least time for the work: each input read once, each output
    written once, over the memory rate; or the flops over the f32 rate."""
    out = out_shape(kernel, shape)
    n_in, n_out = int(np.prod(shape)), int(np.prod(out))
    nbytes = 4 * (n_in + n_out + n_vecs * out[1])
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
    mostly is when the next layer reads it at batch 1."""
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


def phase_kernels(device):
    gen = torch.Generator(device=device).manual_seed(0)
    records = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       max_abs_err=0.0, masked_ms=0.0, eager_ms=0.0) for k in KERNELS}
    for site in sites_for_bucket(448, 431):
        spec = KERNELS[site.kernel]
        C = out_shape(site.kernel, site.shape)[1]
        x = torch.randn(site.shape, device=device, generator=gen) * 2.0 + 0.5
        vecs = []
        for i in range(spec["n_vecs"]):
            v = torch.rand(C, device=device, generator=gen)
            vecs.append(v + 0.5 if i % 2 == 0 else v * 2.0 - 1.0)
        lengths = torch.tensor([site.length], dtype=torch.int32, device=device)
        err = 0.0
        for lens in (None, lengths):
            got = spec["fn"](x, *vecs, lens)
            want = spec["plain"](x, *vecs, lens)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not torch.allclose(got, want, **TOL):
                raise AssertionError(f"{site.kernel} at {site.name} {site.shape} "
                                     f"lengths={lens}: max abs err {e:.3g} > {TOL}")
            err = max(err, e)
        ms = device_ms(lambda: spec["fn"](x, *vecs))
        ms_masked = device_ms(lambda: spec["fn"](x, *vecs, lengths))
        plain_ms = device_ms(lambda: spec["plain"](x, *vecs))
        lib_ms = device_ms(lambda: spec["library"](x, *vecs)) if spec["library"] else None
        eager_ms = call_ms(lambda: spec["fn"](x, *vecs))
        b_ms, bound_by = bound_ms(site.kernel, site.shape, spec["n_vecs"])
        print(f"kernels: {site.kernel:11s} {site.name:26s} in {str(site.shape):22s} "
              f"x{site.count} max_abs_err {err:.3g} (tol atol=rtol=1e-5) "
              f"ms {ms:.5f} masked_ms {ms_masked:.5f} eager_call_ms {eager_ms:.5f} "
              f"plain_ms {plain_ms:.5f} "
              f"library_ms {'null' if lib_ms is None else f'{lib_ms:.5f}'} "
              f"bound_us {1e3 * b_ms:.3f} ({bound_by})", flush=True)
        r = records[site.kernel]
        r["ms"] += site.count * ms
        r["masked_ms"] += site.count * ms_masked
        r["eager_ms"] += site.count * eager_ms
        r["plain_ms"] += site.count * plain_ms
        r["bound_ms"] += site.count * b_ms
        r["bound_by"] = bound_by
        r["library_ms"] = None if lib_ms is None else r["library_ms"] + site.count * lib_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
    for k, r in records.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        print(f"kernels: {k} per forward: ms {r['ms']:.5f} masked_ms {r['masked_ms']:.5f} "
              f"eager_call_ms {r['eager_ms']:.5f} plain_ms {r['plain_ms']:.5f} library_ms {lib} "
              f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return records


def phase_convert(device):
    shutil.rmtree(WORK, ignore_errors=True)
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
    launches = {k: spec["counter"].launches for k, spec in KERNELS.items()}
    n_utt = len(UTTERANCE_FRAMES)
    want_launches = {k: PER_FORWARD[k] * n_utt for k in KERNELS}
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
    profile_conversion(convert, mels["VCC2SF3"][i431], lat[i431])
    return launches


def profile_conversion(convert, mel, wall_s: float) -> None:
    """Where one conversion's time goes: device time by kernel from
    torch.profiler, against the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        convert(mel)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.key, e.count, us if us is not None else e.self_cuda_time_total))
    busy_us = sum(r[2] for r in rows)
    if busy_us == 0:
        print("profile: the profiler recorded no device time: not measured")
        return
    ours = [r for r in rows if "in_kernel" in r[0] or "ps_in_swish_kernel" in r[0]]
    print(f"profile: {mel.shape[1]}-frame conversion: device busy {busy_us / 1e3:.3f} ms "
          f"of {1e3 * wall_s:.3f} ms wall ({100 * busy_us / 1e3 / (1e3 * wall_s):.1f} %), "
          f"{sum(r[1] for r in rows)} device ops; the port's kernels "
          f"{sum(r[2] for r in ours) / 1e3:.3f} ms in {sum(r[1] for r in ours)} launches",
          flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"profile:   {us / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
          f"nvidia-smi: {smi}", flush=True)
    device = resolve_device("cuda")

    t0 = time.perf_counter()
    logs = cuda_lib.build(["in_gate", "ps_in_swish"])
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    records = phase_kernels(device)
    launches = phase_convert(device)

    kernels = []
    for k, spec in KERNELS.items():
        r = records[k]
        kernels.append({
            "name": k, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
