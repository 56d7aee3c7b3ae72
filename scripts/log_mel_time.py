#!/usr/bin/env python3
"""Time K8 (the fused mel frontend) on one card at the preprocess run's buckets.

Calls ``ops.melspec.log_mel_spectrogram_fused`` of the package in this
checkout on pre-padded audio (``pad=False``) of the five buckets that
``chip_smoke.py``'s preprocess run sends it: utterances of 173, 260, 345,
431 and 517 frames, bucketed to 192, 320, 384, 448 and 576 frames at batch
1, two calls each (two speakers). Inputs are seeded noise at the card
tests' scale. Each bucket's output is held against the plain version
(``log_mel_spectrogram_plain``, a true-f32 matrix product) within 5e-5
log10 units and its error printed. Times are device times of CUDA-graph
replays of 20 calls, the median of ``--rounds``. The bound is the flops
over the 3xTF32 rate of the tensor cores (495 / 3 TFLOP/s, H100 SXM) with
the f32 cores' bound (67 TFLOP/s) beside it; the bytes (audio in, mels
out, the constants) take far less at 3.35 TB/s.

To compare two versions of the kernel, unpack each checkout into a
directory that ``.gitignore`` lists (``git archive``), copy this script
into the scripts/ of a checkout that predates it, and run each checkout's
copy in turns within one chip call (A, B, B, A):

    python3 scripts/log_mel_time.py [--label NAME] [--rounds 5]

The last line is one JSON object with the label, each bucket's ms and the
sum over the run's 10 calls, both bounds and the worst error.
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

from maskcyclegan_vc_tpu_torch.ops import melspec  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
F32_3XTF32_FLOPS_PER_S = 495e12 / 3  # H100 SXM, dense TF32, three products per f32 one
BUCKETS = (192, 320, 384, 448, 576)  # frames; two calls each in the preprocess run
CALLS = 2
MEL_TOL = 5e-5


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
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


def bounds_ms(T: int, L: int):
    """(3xTF32 bound, f32-core bound, GFLOP) of one call at batch 1."""
    flops = T * (2 * 2 * 1024 * 513 + 2 * 513 * 80)
    t_bytes = 4 * (L + 2 * 1024 * 513 + 513 * 80 + 80 * T) / HBM_BYTES_PER_S
    return (1e3 * max(flops / F32_3XTF32_FLOPS_PER_S, t_bytes),
            1e3 * max(flops / F32_FLOPS_PER_S, t_bytes), flops / 1e9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("log_mel_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    fn = melspec.log_mel_spectrogram_fused
    total = dict(ms=0.0, bound_ms=0.0, f32_bound_ms=0.0, gflop=0.0, max_abs_err=0.0)
    buckets, ok = {}, True
    for T in BUCKETS:
        L = 1024 + 256 * (T - 1)
        g = torch.Generator(device=device).manual_seed(T)
        audio = torch.randn((1, L), device=device, generator=g) * 0.3
        with torch.inference_mode():
            got = fn(audio, pad=False)
            want = melspec.log_mel_spectrogram_plain(audio, pad=False)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            times = [graph_ms(lambda: fn(audio, pad=False)) for _ in range(args.rounds)]
        ok &= err <= MEL_TOL
        ms = float(np.median(times))
        bnd, f32_bnd, gflop = bounds_ms(T, L)
        print(f"{args.label} log_mel (1, {L}) {T} frames x{CALLS}: ms {ms:.5f} (rounds "
              f"{[round(t, 5) for t in times]}) bound_ms {bnd:.5f} at 3xTF32 "
              f"({100 * bnd / ms:.1f} % of it), f32-core bound_ms {f32_bnd:.5f}; "
              f"{gflop / ms:.2f} TFLOP/s; max abs err {err:.3g} "
              f"{'ok' if err <= MEL_TOL else 'FAILED'}", flush=True)
        buckets[T] = dict(ms=ms, bound_ms=bnd, f32_bound_ms=f32_bnd, max_abs_err=err)
        total["ms"] += CALLS * ms
        total["bound_ms"] += CALLS * bnd
        total["f32_bound_ms"] += CALLS * f32_bnd
        total["gflop"] += CALLS * gflop
        total["max_abs_err"] = max(total["max_abs_err"], err)
    print(f"{args.label} log_mel over the preprocess run's {CALLS * len(BUCKETS)} calls: ms "
          f"{total['ms']:.5f} bound_ms {total['bound_ms']:.5f} at 3xTF32 "
          f"({100 * total['bound_ms'] / total['ms']:.1f} % of it), f32-core bound_ms "
          f"{total['f32_bound_ms']:.5f}; {total['gflop']:.3f} GFLOP, "
          f"{total['gflop'] / total['ms']:.2f} TFLOP/s; card: {smi}")
    print(json.dumps({"label": args.label, "ok": bool(ok), "card": smi, "buckets": buckets,
                      "sum": total}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
