#!/usr/bin/env python3
"""Time K1, K2 and K3 (InstanceNorm + GLU gate, InstanceNorm, InstanceNorm + swish) on one card.

With ``--backward``, their backwards instead, at the sites of a training
step's forwards with grad: the checkout's ``instance_norm*_backward``
(where it has them; the fused kernel on the card) beside the plain
formulas (``*_backward_plain``, or the autograd Function's eager backward
of a checkout that predates them), each timed as above; the bound is x and
dy read and dx written once, plus the vectors and the (B, C) partials.

Calls ``ops.in_gate`` of the package in this checkout, in f32 and bf16, at
the call sites of one training step at 32 x 128 and at 1 x 64 (K1 and K2:
the generator's downSample1, downSample2, residual and 2d/1d-bridge
norms, 8 each a forward; K3: the discriminator's downSample1-3, 3 a
forward; with their counts per step) and of one 431-frame conversion in
its 448-frame bucket (masked, its lengths). Inputs are seeded at the card
tests' scales. Each site's output is held against the plain version of its
dtype (f32: atol = rtol = 1e-5; bf16: one bf16 rounding) and its error
printed, with the route each entry reports (``ROUTES``, where the
checkout's ``ops.in_gate`` counts it). Times are device times of
CUDA-graph replays of 20 calls (5 where the input passes 4 Mi elements),
the median of ``--rounds``; a site's share is its bound over its time. The
bound is ``chip_smoke.py``'s: each input read once and each output written
once over 3.35 TB/s (H100 SXM), or the flops over 67 TFLOP/s, whichever is
larger. In an A/B call against a checkout that changed one of the three
kernels, the other two are the control: their code is the same on both
sides, so a gap in them is the call's noise.

To compare two versions of the kernels, unpack each checkout into a
directory that ``.gitignore`` lists (``git archive``), copy this script
into the scripts/ of a checkout that predates it, and run each checkout's
copy in turns within one chip call (A, B, B, A):

    python3 scripts/in_gate_time.py [--label NAME] [--rounds 5] [--sizes 32x128 1x64 convert431]
    python3 scripts/in_gate_time.py --backward [--label NAME] [--sizes 32x128 1x64]

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.ops import in_gate  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
# Per output element, as chip_smoke.KERNELS counts them.
FLOPS_PER_OUT = {"k1": 17, "k2": 6, "k3": 10}
FNS = {"k1": (in_gate.instance_norm_glu, in_gate.instance_norm_glu_plain, 2, "in_glu"),
       "k2": (in_gate.instance_norm, in_gate.instance_norm_plain, 1, "in"),
       "k3": (in_gate.instance_norm_swish, in_gate.instance_norm_swish_plain, 1, "in_swish")}


def _g_sites(B, W, calls, lengths=None):
    """K1 and K2 inputs of one generator forward at batch B and W frames
    after the first convolution's stride (downSample1 input W, the rest
    W / 2), ``calls`` such forwards; lengths: valid frames of downSample1
    and of the rest."""
    l1, l2 = (None, None) if lengths is None else ((lengths[0],), (lengths[1],))
    w = W // 2
    return [("k1", (B, 512, 40, W), l1, calls), ("k1", (B, 512, 20, w), l2, calls),
            ("k1", (B, 1024, w), l2, 6 * calls),
            ("k2", (B, 256, w), l2, 7 * calls), ("k2", (B, 5120, w), l2, calls)]


def _d_sites(B, W, calls):
    """K3 inputs of one discriminator forward at batch B and T = 2W frames."""
    return [("k3", (B, 256, 40, W), None, calls), ("k3", (B, 512, 20, W // 2), None, calls),
            ("k3", (B, 1024, 10, W // 4), None, calls)]


# (kernel, x shape, lengths or None, calls) per size. 32 x 128: 10 G
# forwards and 12 D forwards at batch 32; 1 x 64 (pair_forwards): G
# forwards at batch 2 (twice), 3 (once) and 1 (three times), D forwards at
# batch 1 (four) and 2 (four); the 431-frame conversion: one G forward at
# batch 1, 216 and 108 valid frames.
SITES = {
    "32x128": _g_sites(32, 64, 10) + _d_sites(32, 64, 12),
    "1x64": (_g_sites(2, 32, 2) + _g_sites(3, 32, 1) + _g_sites(1, 32, 3)
             + _d_sites(1, 32, 4) + _d_sites(2, 32, 4)),
    "convert431": _g_sites(1, 224, 1, (216, 108)),
}
# The backwards' sites: the forwards with grad. 32 x 128: 6 of the 10 G
# forwards and all 12 D forwards at batch 32; 1 x 64: G forwards with grad at
# batch 2, 3 and 1 (once each), D forwards at batch 1 (four) and 2 (four).
BWD_SITES = {
    "32x128": _g_sites(32, 64, 6) + _d_sites(32, 64, 12),
    "1x64": (_g_sites(2, 32, 1) + _g_sites(3, 32, 1) + _g_sites(1, 32, 1)
             + _d_sites(1, 32, 4) + _d_sites(2, 32, 4)),
}
BWD_FNS = {"k1": "instance_norm_glu", "k2": "instance_norm", "k3": "instance_norm_swish"}
TOL = dict(atol=1e-5, rtol=1e-5)
ONE_BF16 = dict(atol=1e-5, rtol=2 ** -7)


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
    arrays = FNS[kernel][2]
    n_in = int(np.prod(shape))
    n_out, C = n_in // arrays, shape[1] // arrays
    t_bytes = (esize * (n_in + n_out) + 4 * 2 * arrays * C) / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_OUT[kernel] * n_out / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops)


def run_site(kernel, shape, lengths, dtype, device, rounds, seed):
    fn, plain, arrays, name = FNS[kernel]
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[1] // arrays
    x = (torch.randn(shape, device=device, generator=g) * 2.0 + 0.5).to(dtype)
    vecs = [torch.rand(C, device=device, generator=g) + 0.5 for _ in range(2 * arrays)]
    lens = None if lengths is None else torch.tensor(lengths * shape[0], dtype=torch.int32,
                                                     device=device)
    reps = 20 if x.numel() < (1 << 22) else 5
    routes = getattr(in_gate, "ROUTES", {}).get(name)
    before = None if routes is None else dict(routes[dtype])
    got = fn(x, *vecs, lens)
    where = ("n/a" if routes is None else
             " ".join(r for r, n in routes[dtype].items() if n > before[r]))
    want = plain(x, *vecs, lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(),
                             **(TOL if dtype == torch.float32 else ONE_BF16)))
    times = [graph_ms(lambda: fn(x, *vecs, lens), reps) for _ in range(rounds)]
    return float(np.median(times)), times, err, ok, where


def backward_fns(kernel):
    """(fused or None, plain) backward of ``kernel`` in this checkout: each
    (x, dy, *vecs) -> (dx, dscale, dbias, ...)."""
    name = BWD_FNS[kernel]
    fused = getattr(in_gate, f"{name}_backward", None)
    plain = getattr(in_gate, f"{name}_backward_plain", None)
    if plain is None:  # a checkout older than the fused backward: its Function's eager one
        fn = FNS[kernel][0]

        def plain(x, dy, *vecs):
            xr = x.detach().requires_grad_()
            vr = [v.detach().requires_grad_() for v in vecs]
            with torch.enable_grad():
                return torch.autograd.grad(fn(xr, *vr), [xr, *vr], dy)
    return fused, plain


def backward_bound_ms(kernel: str, shape, esize: int) -> float:
    arrays = FNS[kernel][2]
    n_x = int(np.prod(shape))
    C = shape[1] // arrays
    nbytes = esize * (2 * n_x + n_x // arrays) + 4 * (2 * arrays * C + 2 * arrays * shape[0] * C)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def run_backward_site(kernel, shape, dtype, device, rounds, seed):
    """(fused ms or None, plain ms, worst dx error or None, ok, route)."""
    fused, plain = backward_fns(kernel)
    arrays = FNS[kernel][2]
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[1] // arrays
    x = (torch.randn(shape, device=device, generator=g) * 2.0 + 0.5).to(dtype)
    vecs = [torch.rand(C, device=device, generator=g) + (0.5 if i % 2 == 0 else -0.5)
            for i in range(2 * arrays)]
    dy = torch.randn((shape[0], C) + tuple(shape[2:]), device=device, generator=g).to(dtype)
    reps = 20 if x.numel() < (1 << 22) else 5
    plain_ms = float(np.median([graph_ms(lambda: plain(x, dy, *vecs), reps)
                                for _ in range(rounds)]))
    if fused is None:
        return None, plain_ms, None, True, "n/a"
    routes = in_gate.ROUTES[f"{FNS[kernel][3]}_bwd"][dtype]
    before = dict(routes)
    got, want = fused(x, dy, *vecs), plain(x, dy, *vecs)
    torch.cuda.synchronize()
    where = " ".join(r for r, n in routes.items() if n > before[r])
    err = (got[0].float() - want[0].float()).abs().max().item()
    ok = bool(torch.allclose(got[0].float(), want[0].float(),
                             **(TOL if dtype == torch.float32 else ONE_BF16)))
    ms = float(np.median([graph_ms(lambda: fused(x, dy, *vecs), reps) for _ in range(rounds)]))
    return ms, plain_ms, err, ok, where


def main_backward(args, device, smi) -> int:
    sums, all_ok = {}, True
    for size in args.sizes:
        for dtype in (torch.float32, torch.bfloat16):
            for i, (kernel, shape, _, calls) in enumerate(BWD_SITES[size]):
                ms, plain_ms, err, ok, where = run_backward_site(kernel, shape, dtype, device,
                                                                 args.rounds, i)
                bnd = backward_bound_ms(kernel, shape, torch.finfo(dtype).bits // 8)
                all_ok &= ok
                dname = "bf16" if dtype == torch.bfloat16 else "f32"
                fused = "n/a" if ms is None else f"{ms:.5f} ({100 * bnd / ms:.1f} % of the bound)"
                print(f"{args.label} backward {size} {kernel} {dname} {shape} x{calls}: ms "
                      f"{fused} plain_ms {plain_ms:.5f} bound_ms {bnd:.5f}; route {where}; "
                      f"max abs err {'n/a' if err is None else f'{err:.3g}'} "
                      f"{'ok' if ok else 'FAILED'}", flush=True)
                r = sums.setdefault(f"backward {size} {kernel} {dname}",
                                    dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, calls=0))
                r["ms"] = None if ms is None else r["ms"] + calls * ms
                r["plain_ms"] += calls * plain_ms
                r["bound_ms"] += calls * bnd
                r["calls"] += calls
    for k, r in sums.items():
        fused = "n/a" if r["ms"] is None else f"{r['ms']:.5f}"
        print(f"{args.label} {k}: {r['calls']} calls ms {fused} plain_ms {r['plain_ms']:.5f} "
              f"bound_ms {r['bound_ms']:.5f}; card: {smi}")
    print(json.dumps({"label": args.label, "ok": bool(all_ok), "sums": sums}))
    return 0 if all_ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sizes", nargs="+", default=None, choices=list(SITES))
    ap.add_argument("--backward", action="store_true",
                    help="time the backwards at the sites of the forwards with grad")
    args = ap.parse_args()
    args.sizes = args.sizes or list(BWD_SITES if args.backward else SITES)
    if args.backward and not set(args.sizes) <= set(BWD_SITES):
        ap.error(f"--backward takes the sizes {list(BWD_SITES)}")
    if not torch.cuda.is_available():
        print("in_gate_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    if args.backward:
        return main_backward(args, device, smi)
    sums, all_ok = {}, True
    for size in args.sizes:
        for dtype in (torch.float32, torch.bfloat16):
            for i, (kernel, shape, lengths, calls) in enumerate(SITES[size]):
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
