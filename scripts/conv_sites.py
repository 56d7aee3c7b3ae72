#!/usr/bin/env python3
"""Each conv problem of one training step, by pass, with the kernels cuDNN
runs for it and their device ms, under cuDNN's heuristics and under its
autotuner.

One eager step of the package in this checkout (``make_train_step``, the
identity variant) runs on two synthetic speakers under a dispatch mode that
records every ``aten.convolution`` (the forward) and
``aten.convolution_backward`` (dgrad where it asks for the input's
gradient, wgrad where it asks for the weight's), each with the model's
sites it serves (``ops/layers.conv_with``'s module). A problem is what cuDNN
keys its plans by: input shape and strides, weight shape, stride, padding,
dilation, groups and dtype. Then each problem's passes run alone, on random
operands of the recorded shapes and strides: once to warm (under the
autotuner, that call times the candidates: its seconds are the tuning's
cost), then ``--reps`` times under ``torch.profiler``, which gives each
kernel's name and device time. cuDNN keeps one plan a problem for the life
of a process, whichever mode met it first, so each mode runs in a process
of its own: the heuristics, then the autotuner (``utils.device.
autotune_scope``) at each ``--limits`` value of its ``AUTOTUNE_ENGINES``,
``torch.backends.cudnn.benchmark_limit`` (0: every engine).

    python3 scripts/conv_sites.py [--dtype bfloat16] [--batch 32] [--frames 128]
        [--reps 5] [--limits 5 10 0] [--label NAME] [--out_dir DIR]

It times the autotuner in either dtype, whichever ``autotunes`` lets the
training steps use.

It prints one table row a problem and pass (calls a step; each mode's
kernels with their ms a call) sorted by the heuristics' ms a step, then
each mode's sum over the step (ms), of it the layout transforms
(``nchwToNhwc``, ``nhwcToNchw``) and the kernels that the benchmark's
convolution group does not name, and the tuning's seconds, and writes all
of it as JSON under ``--out_dir`` (``runs/conv_sites/``). On the CPU (``--device
cpu``, for a rehearsal at a small width) it records the problems and runs
each pass once; every time reads "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from maskcyclegan_vc_tpu_torch.data.dataset import (  # noqa: E402
    MelBank,
    sample_batch,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.models import generator as generator_mod  # noqa: E402
from maskcyclegan_vc_tpu_torch.ops import layers  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.step import make_train_step  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils import device as device_mod  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import (  # noqa: E402
    autotune_scope,
    precision_scope,
    resolve_device,
)
from portbench.names import CONV_KERNELS  # noqa: E402

PASSES = ("forward", "dgrad", "wgrad")
TRANSFORMS = r"nchwToNhwc|nhwcToNchw"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def problem_key(x, weight, stride, padding, dilation, groups) -> str:
    return json.dumps([list(x.shape), list(x.stride()), list(weight.shape), list(stride),
                       list(padding), list(dilation), int(groups), str(x.dtype)[6:]])


class Recorder(TorchDispatchMode):
    """Every convolution and convolution backward: {problem: its record}."""

    def __init__(self):
        super().__init__()
        self.site = None
        self.problems = {}

    def _entry(self, x, w, stride, padding, dilation, groups, y_shape):
        key = problem_key(x, w, stride, padding, dilation, groups)
        if key not in self.problems:
            self.problems[key] = {"sites": [], "forward": 0, "dgrad": 0, "wgrad": 0,
                                  "grad_stride": None, "y_shape": list(y_shape)}
        return self.problems[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, padding, dilation, _, _, groups = args
            entry = self._entry(x, w, stride, padding, dilation, groups, out.shape)
            entry["forward"] += 1
            if self.site and self.site not in entry["sites"]:
                entry["sites"].append(self.site)
            self.site = None
        elif func is torch.ops.aten.convolution_backward.default:
            gy, x, w, _, stride, padding, dilation, _, _, groups, mask = args
            entry = self._entry(x, w, stride, padding, dilation, groups, gy.shape)
            entry["dgrad"] += int(mask[0])
            entry["wgrad"] += int(mask[1])
            entry["grad_stride"] = entry["grad_stride"] or list(gy.stride())
        return out


def record_step(device, dtype, batch: int, frames: int, n_mels: int, channels: int):
    """The conv problems of one eager step at full width (or ``channels``)."""
    rs = np.random.RandomState(0)
    banks = [MelBank.from_list([rs.randn(n_mels, int(t)).astype(np.float32)
                                for t in rs.randint(173, 518, 8)], frames, device)
             for _ in range(2)]
    cfg = TrainConfig(schedule=ScheduleConfig(n_samples=8, batch_size=batch), n_mels=n_mels,
                      num_frames=frames, residual_channels=channels, dtype=dtype)
    state = create_train_state(cfg, 0, device)
    names = {}
    for side, models in (("G", state.g), ("D", state.d)):
        for model in models.values():
            names.update({id(m): f"{side}.{n}" for n, m in model.named_modules()})
    rec = Recorder()
    real = layers.conv_with

    def named(module, x, weight, bias):
        rec.site = names.get(id(module))
        return real(module, x, weight, bias)

    layers.conv_with = generator_mod.conv_with = named
    try:
        with rec:
            make_train_step(cfg)(state, sample_batch(step_generator(0, 0, device), *banks,
                                                     batch, frames, 25))
    finally:
        layers.conv_with = generator_mod.conv_with = real
    return rec.problems


def operands(key: str, entry: dict, device):
    x_shape, x_stride, w_shape, stride, padding, dilation, groups, dtype = json.loads(key)
    dt = getattr(torch, dtype)

    def rand(shape, strides=None):
        t = (torch.empty_strided(shape, strides, dtype=dt, device=device) if strides
             else torch.empty(shape, dtype=dt, device=device))
        return t.normal_()

    x, w = rand(x_shape, x_stride), rand(w_shape)
    b = torch.zeros(w_shape[0], dtype=dt, device=device)
    gy = rand(entry["y_shape"], entry["grad_stride"])
    zeros = [0] * len(stride)
    conv = torch.ops.aten.convolution
    back = torch.ops.aten.convolution_backward
    return {
        "forward": lambda: conv(x, w, b, stride, padding, dilation, False, zeros, groups),
        "dgrad": lambda: back(gy, x, w, [w_shape[0]], stride, padding, dilation, False, zeros,
                              groups, [True, False, False]),
        "wgrad": lambda: back(gy, x, w, [w_shape[0]], stride, padding, dilation, False, zeros,
                              groups, [False, True, False]),
    }


def kernels_of(fn, reps: int) -> dict:
    """{kernel name: device ms a call} over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        out[e.key] += (us if us is not None else e.self_cuda_time_total) / 1e3 / reps
    return dict(out)


def time_mode(problems: dict, device, mode: str, limit, reps: int) -> dict:
    """Each problem's passes in this process: {key: {pass: {"kernels": ..,
    "ms": .., "warm_s": ..}}}. ``mode`` is "heuristics" or "autotune"."""
    cuda = device.type == "cuda"
    if limit is not None:
        device_mod.AUTOTUNE_ENGINES = limit
    out = {}
    with autotune_scope(mode == "autotune"):
        for key, entry in problems.items():
            fns = operands(key, entry, device)
            out[key] = {}
            for p in PASSES:
                if not entry[p]:
                    continue
                t0 = time.perf_counter()
                fns[p]()
                if cuda:
                    torch.cuda.synchronize()
                warm = time.perf_counter() - t0
                ks = kernels_of(fns[p], reps) if cuda else {}
                out[key][p] = {"kernels": ks, "ms": sum(ks.values()) if cuda else None,
                               "warm_s": warm}
    return out


def short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:56]


def summary(problems: dict, timed: dict) -> dict:
    """The mode's ms a step: all, the layout transforms', and those of
    kernels that ``portbench/names.CONV_KERNELS`` does not name (which
    ``train.conv_ms_per_step`` reads as eager ops); the first calls' s."""
    sums = {"ms_a_step": 0.0, "transforms_ms_a_step": 0.0, "unnamed_ms_a_step": 0.0}
    warm, measured = 0.0, True
    for key, passes in timed.items():
        for p, t in passes.items():
            calls = problems[key][p]
            warm += t["warm_s"]
            if t["ms"] is None:
                measured = False
                continue
            for k, ms in t["kernels"].items():
                sums["ms_a_step"] += calls * ms
                if re.search(TRANSFORMS, k):
                    sums["transforms_ms_a_step"] += calls * ms
                if not re.search(CONV_KERNELS, k):
                    sums["unnamed_ms_a_step"] += calls * ms
    out = {k: v if measured else None for k, v in sums.items()}
    out["warm_s"] = warm
    return out


def cell(t) -> str:
    if t is None:
        return ""
    if t["ms"] is None:
        return "not measured"
    ks = sorted(t["kernels"].items(), key=lambda kv: -kv[1])
    return "; ".join(f"{short(k)} {ms:.4f}" for k, ms in ks)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--n_mels", type=int, default=80)
    ap.add_argument("--residual_channels", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--limits", type=int, nargs="*", default=[device_mod.AUTOTUNE_ENGINES])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--label", default="")
    ap.add_argument("--out_dir", default=os.path.join(ROOT, "runs", "conv_sites"))
    # A child: time every problem of --problems in one mode, write --out.
    ap.add_argument("--problems", help=argparse.SUPPRESS)
    ap.add_argument("--mode", help=argparse.SUPPRESS)
    ap.add_argument("--limit", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    device = resolve_device(a.device)

    if a.problems:
        with open(a.problems) as f:
            problems = json.load(f)
        with open(a.out, "w") as f:
            json.dump(time_mode(problems, device, a.mode, a.limit, a.reps), f)
        return

    dtype = None if a.dtype == "float32" else DTYPES[a.dtype]
    with precision_scope(None):
        problems = record_step(device, dtype, a.batch, a.frames, a.n_mels, a.residual_channels)
    card = (torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
    print(f"{len(problems)} conv problems in one {a.dtype} {a.batch} x {a.frames} step "
          f"(R {a.residual_channels}) on {card}", flush=True)
    modes = [("heuristics", None)] + [(f"autotune limit {n}", n) for n in a.limits]
    timed = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problems.json")
        with open(path, "w") as f:
            json.dump(problems, f)
        for i, (mode, limit) in enumerate(modes):
            out = os.path.join(tmp, f"{i}.json")
            argv = [sys.executable, os.path.abspath(__file__), "--problems", path,
                    "--mode", mode.split()[0], "--out", out, "--reps", str(a.reps),
                    "--device", a.device]
            if limit is not None:
                argv += ["--limit", str(limit)]
            subprocess.run(argv, check=True)
            with open(out) as f:
                timed[mode] = json.load(f)
    base = timed["heuristics"]
    rows = []
    for key, entry in problems.items():
        for p in PASSES:
            if entry[p]:
                ms = base[key][p]["ms"]
                rows.append((-(ms or 0.0) * entry[p], key, p))
    rows.sort()
    print("| problem (x, w, stride, pad, dilation) | sites | pass | calls a step | "
          + " | ".join(f"{m}: kernels, ms a call" for m in timed) + " |")
    print("|---" * (4 + len(timed)) + "|")
    for _, key, p in rows:
        x_shape, _, w_shape, stride, padding, dilation, _, _ = json.loads(key)
        entry = problems[key]
        sites = ", ".join(entry["sites"][:3]) + (" ..." if len(entry["sites"]) > 3 else "")
        print(f"| {x_shape} {w_shape} s{stride} p{padding} d{dilation} | {sites} | {p} | "
              f"{entry[p]} | " + " | ".join(cell(t[key].get(p)) for t in timed.values()) + " |")
    sums = {mode: summary(problems, t) for mode, t in timed.items()}
    for mode, s in sums.items():
        ms = {k: "not measured" if v is None else f"{v:.3f} ms" for k, v in s.items()}
        print(f"{mode}: convolutions {ms['ms_a_step']} a step, of it layout transforms "
              f"{ms['transforms_ms_a_step']}, kernels names.CONV_KERNELS does not name "
              f"{ms['unnamed_ms_a_step']}; first calls (the tuning, under the autotuner) "
              f"{s['warm_s']:.2f} s")
    os.makedirs(a.out_dir, exist_ok=True)
    name = f"{a.dtype}_{a.batch}x{a.frames}{'_' + a.label if a.label else ''}.json"
    with open(os.path.join(a.out_dir, name), "w") as f:
        json.dump({"card": card, "dtype": a.dtype, "batch": a.batch, "frames": a.frames,
                   "problems": problems, "timed": timed, "sums": sums}, f)
    print(json.dumps({"label": a.label, "card": card, "dtype": a.dtype,
                      "shape": [a.batch, a.frames], "sums": sums}))


if __name__ == "__main__":
    main()
