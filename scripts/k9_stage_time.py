#!/usr/bin/env python3
"""Time K9's f32 or bf16 entry on the four stages of a 431-frame decode, on one card.

Calls ``ops.melgan_stack.melgan_resstack`` of the package in this checkout
(weight packing included, as ``chip_smoke.py`` times it) on batch 1,
C x W = 256 x 3448, 128 x 27584, 64 x 55168, 32 x 110336 (emit_lrelu on
the first three stages, the tail on the last; ``--batch`` and ``--frames``
give other decodes, e.g. 32 x 128, the in-loop decode of config 5), with seeded random weights
at the card tests' scales, and x as the card tests make it or, with
``--offset``, shifted by that much. ``--dtype bfloat16`` casts x and the
weights to bf16, as the bf16 vocoder passes them, and runs the bf16 entry.
Each output is held against the plain version of its dtype (f32: 1e-4 of
the output's scale plus rtol 1e-4; bf16: two bf16 roundings of the scale,
as ``chip_smoke.py``) and its error printed. Times are device times of CUDA-graph replays of 5
calls, each stage's the median of ``--rounds``. To compare two versions of
the kernel, run each checkout's copy of this script in turns within one
chip call (A, B, B, A) and compare the medians:

    python3 scripts/k9_stage_time.py [--label NAME] [--rounds 5] [--offset 0]
        [--dtype {float32,bfloat16}] [--batch 1] [--frames 431]

The last line is one JSON object with the label, per-stage ms and errors,
and their sum.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.ops import melgan_stack  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

# Each stage's channels and its width per mel frame (the up-convs' 8, 8, 2, 2).
STAGES = [(256, 8), (128, 64), (64, 128), (32, 256)]
STAGE_TOL = 1e-4
STAGE_TOL_BF16 = 2 * 2 ** -7
# The bound's rate: f32 as 3xTF32 (three TF32 products per flop at 495
# TFLOP/s), bf16 at the dense bf16 tensor rate; H100 SXM.
FLOPS_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}


def stage_inputs(B: int, C: int, W: int, device, seed: int):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=device, generator=g) * scale

    blocks = [{"conv1.weight": rnd(C, C, 3, scale=(3 * C) ** -0.5), "conv1.bias": rnd(C, scale=0.1),
               "conv2.weight": rnd(C, C, 1, scale=C ** -0.5), "conv2.bias": rnd(C, scale=0.1),
               "shortcut.weight": rnd(C, C, 1, scale=C ** -0.5),
               "shortcut.bias": rnd(C, scale=0.1)} for _ in range(3)]
    tail = (rnd(1, C, 7, scale=(7 * C) ** -0.5), rnd(1, scale=0.1))
    return rnd(B, C, W), blocks, tail


def graph_ms(fn, reps: int = 5, replays: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=431)
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("k9_stage_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    stages, ok = [], True
    with torch.inference_mode():
        for i, (C, per_frame) in enumerate(STAGES):
            B, W = args.batch, args.frames * per_frame
            x, blocks, tail = stage_inputs(B, C, W, device, C + W)
            x = (x + args.offset).to(dtype)
            blocks = [{k: v.to(dtype) for k, v in b.items()} for b in blocks]
            tail = tuple(t.to(dtype) for t in tail) if i == len(STAGES) - 1 else None

            def call(x=x, blocks=blocks, tail=tail):
                return melgan_stack.melgan_resstack(x, blocks, emit_lrelu=tail is None, tail=tail)

            got = call()
            want = melgan_stack.PLAIN[dtype](x, blocks, emit_lrelu=tail is None, tail=tail)
            torch.cuda.synchronize()
            got, want = got.float(), want.float()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            if dtype == torch.bfloat16:
                good = err <= STAGE_TOL_BF16 * scale
            else:
                good = torch.allclose(got, want, atol=STAGE_TOL * scale, rtol=STAGE_TOL)
            ok &= good
            times = [graph_ms(call) for _ in range(args.rounds)]
            ms = float(np.median(times))
            flops = B * W * (30 * C * C + (14 * C if tail is not None else 0))
            bound = 1e3 * flops / FLOPS_PER_S[dtype]
            print(f"{args.label} {args.dtype} B {B} C {C} W {W}: max abs err {err:.3g} (scale "
                  f"{scale:.3g}, {err / scale:.3g} of it) {'ok' if good else 'FAILED'}; ms "
                  f"{ms:.5f} (rounds {[round(t, 5) for t in times]}) "
                  f"{flops / ms / 1e9:.2f} TFLOP/s; bound_ms {bound:.5f}", flush=True)
            stages.append(dict(B=B, C=C, W=W, ms=ms, max_abs_err=err, scale=scale, bound_ms=bound))
    total = sum(s["ms"] for s in stages)
    print(f"{args.label} {args.dtype}: sum over one {args.batch} x {args.frames}-frame decode "
          f"{total:.5f} ms; "
          f"card: {smi}")
    print(json.dumps({"label": args.label, "dtype": args.dtype, "batch": args.batch,
                      "frames": args.frames, "offset": args.offset,
                      "ok": bool(ok), "ms": total, "stages": stages}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
