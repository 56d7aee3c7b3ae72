#!/usr/bin/env python3
"""Time K4 and K5 (pixel shuffle + InstanceNorm + swish, forward and fused backward) on one card.

Calls ``ops.ps`` of the package in this checkout, in f32 and bf16, at the
call sites of one training step at 32 x 128 and at 1 x 64 (as
``chip_smoke.py`` records them: the upSample1 and upSample2 inputs of each
generator forward, with their counts per step) and of one 431-frame
conversion (masked, its lengths). Inputs are seeded at the card tests'
scales. Each site's output is held against the plain version of its dtype
(f32: atol = rtol = 1e-5; bf16: one bf16 rounding, K5's dx two) and its
error printed. Times are device times of CUDA-graph replays of 20 calls (5
where the input passes 4 Mi elements), the median of ``--rounds``; a
site's share is its bound over its time. The bound is ``chip_smoke.py``'s:
each input read once and each output written once over 3.35 TB/s (H100
SXM). Where the checkout's ``ops.ps`` counts K4's routes (``ROUTES``),
each K4 site's route is printed too (K5 has one route, the bulk copy). To compare two versions of the kernels, run each checkout's
copy of this script in turns within one chip call (A, B, B, A):

    python3 scripts/ps_in_swish_time.py [--label NAME] [--rounds 5]

The last line is one JSON object with the label and, per size, kernel and
dtype, the summed ms, bound and the worst error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.ops import ps  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# (kernel, x shape, lengths or None, calls) per size, as chip_smoke.py
# records them: upSample1 is (B, 1024, 20, W), upSample2 (B, 512, 40, 2W).
SITES = {
    "32x128": [("k4", (32, 1024, 20, 32), None, 10), ("k4", (32, 512, 40, 64), None, 10),
               ("k5", (32, 1024, 20, 32), None, 6), ("k5", (32, 512, 40, 64), None, 6)],
    "1x64": [("k4", (2, 1024, 20, 16), None, 2), ("k4", (2, 512, 40, 32), None, 2),
             ("k4", (3, 1024, 20, 16), None, 1), ("k4", (3, 512, 40, 32), None, 1),
             ("k4", (1, 1024, 20, 16), None, 3), ("k4", (1, 512, 40, 32), None, 3),
             *[("k5", (B, C4, H, W), None, 1) for B in (1, 2, 3)
               for C4, H, W in ((1024, 20, 16), (512, 40, 32))]],
    "convert431": [("k4", (1, 1024, 20, 112), (216,), 1), ("k4", (1, 512, 40, 224), (432,), 1)],
}
TOL = dict(atol=1e-5, rtol=1e-5)


def graph_ms(fn, reps: int, replays: int = 5) -> float:
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


def bound_ms(kernel: str, shape, esize: int) -> float:
    B, C4, H, W = shape
    n, C = B * C4 * H * W, C4 // 4
    if kernel == "k4":
        nbytes = 2 * esize * n + 4 * 2 * C
    else:  # x and dy read, dx written; scale, bias in, mean, inv in, dscale, dbias out
        nbytes = 3 * esize * n + 4 * (2 * C + 4 * B * C)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def k5_dx_ok(x, dy, s, b, mean, inv, got, want) -> bool:
    """dx within chip_smoke.k5_dx_bound of the plain version."""
    if x.dtype != torch.bfloat16:
        return bool(torch.allclose(got, want, **TOL))
    B, C4, H, W = x.shape
    xs = x.float().reshape(B, C4 // 4, -1)
    a = s[None, :, None] * inv[..., None]
    z = xs * a + (b[None, :, None] - mean[..., None] * a)
    sg = torch.sigmoid(z)
    dys = F.pixel_unshuffle(dy.float(), 2).reshape(xs.shape)
    a_dz = (a * dys * (sg + z * sg * (1 - sg))).reshape(x.shape)
    bound = 1e-5 + 2 ** -6 * torch.maximum(want.float().abs(), a_dz.abs())
    return bool(((got.float() - want.float()).abs() <= bound).all())


def run_site(kernel, shape, lengths, dtype, device, rounds, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    B, C4, H, W = shape
    C = C4 // 4
    x = (torch.randn(shape, device=device, generator=g) * 2.0 + 0.5).to(dtype)
    s = torch.rand(C, device=device, generator=g) + 0.5
    b = torch.rand(C, device=device, generator=g) * 2.0 - 1.0
    reps = 20 if x.numel() < (1 << 22) else 5
    routes = getattr(ps, "ROUTES", None)
    if kernel == "k4":
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                         device=device)
        before = dict(routes[dtype]) if routes else None
        got = ps.pixel_shuffle_in_swish(x, s, b, lens)
        where = ("n/a" if routes is None else
                 " ".join(r for r, n in routes[dtype].items() if n > before[r]))
        want = ps.pixel_shuffle_in_swish_plain(x, s, b, lens)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL if dtype == torch.float32 else dict(atol=1e-5, rtol=2 ** -7)
        ok = bool(torch.allclose(got.float(), want.float(), **tol))
        times = [graph_ms(lambda: ps.pixel_shuffle_in_swish(x, s, b, lens), reps)
                 for _ in range(rounds)]
    else:
        dy = torch.randn((B, C, 2 * H, 2 * W), device=device, generator=g).to(dtype)
        _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
        got = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
        want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs().max().item()
        ok = k5_dx_ok(x, dy, s, b, mean, inv, got[0], want[0])
        times = [graph_ms(lambda: ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv),
                          reps) for _ in range(rounds)]
        where = "n/a" if routes is None else "bulk"
    return float(np.median(times)), times, err, ok, where


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ps_in_swish_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    sums, all_ok = {}, True
    for size, sites in SITES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for i, (kernel, shape, lengths, calls) in enumerate(sites):
                ms, times, err, ok, where = run_site(kernel, shape, lengths, dtype, device,
                                                     args.rounds, i)
                bnd = bound_ms(kernel, shape, torch.finfo(dtype).bits // 8)
                all_ok &= ok
                dname = "bf16" if dtype == torch.bfloat16 else "f32"
                print(f"{args.label} {size} {kernel} {dname} {shape} "
                      f"{'' if lengths is None else f'lengths {list(lengths)} '}x{calls}: "
                      f"ms {ms:.5f} (rounds {[round(t, 5) for t in times]}) bound_ms "
                      f"{bnd:.5f}, {100 * bnd / ms:.1f} % of it; route {where}; max abs err "
                      f"{err:.3g} {'ok' if ok else 'FAILED'}", flush=True)
                r = sums.setdefault(f"{size} {kernel} {dname}",
                                    dict(ms=0.0, bound_ms=0.0, calls=0, max_abs_err=0.0))
                r["ms"] += calls * ms
                r["bound_ms"] += calls * bnd
                r["calls"] += calls
                r["max_abs_err"] = max(r["max_abs_err"], err)
    for k, r in sums.items():
        print(f"{args.label} {k}: {r['calls']} calls ms {r['ms']:.5f} bound_ms "
              f"{r['bound_ms']:.5f}, {100 * r['bound_ms'] / r['ms']:.1f} % of it; card: {smi}")
    print(json.dumps({"label": args.label, "ok": bool(all_ok), "sums": sums}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
