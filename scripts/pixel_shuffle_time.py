#!/usr/bin/env python3
"""Time K6 and K7 (the inverse shuffle and the shuffle) on one card.

Calls ``ops.ps`` of the package in this checkout, in f32 and bf16, at the
inverse-shuffle sites of a training step at 1 x 320 and at 1 x 192 as
``chip_smoke.py`` records them (dy (B, C, 2H, 2W) of upSample2 and, in f32
at 1 x 320, of upSample1, one call each at B = 1, 3 and 2): K6 on dy and K7
on the transposed shape (B, 4C, H, W). bf16 splits upSample2 only from 273
frames, so its 1 x 192 sites are on no path; they are timed all the same.
Inputs are seeded noise. Each output is held against the plain version
(``F.pixel_unshuffle``, ``F.pixel_shuffle``) bit for bit. Times are device
times of CUDA-graph replays of 20 calls, the median of ``--rounds``, the
library call's (the same ``F`` function) beside them; a site's share is its
bound over its time. The bound is ``chip_smoke.py``'s: one read and one
write of every element over 3.35 TB/s (H100 SXM). Where the checkout's
``ops.ps`` counts K6's and K7's routes (``SHUFFLE_ROUTES``), each site's
route is printed too.

``--variants`` also builds copies of this checkout's ``csrc/pixel_shuffle.cu``
under ``build/pixel_shuffle_variants/``, each with one change, and times
their entries at the same sites (exact against the plain version as well):
``units2`` (two units a thread, all four loads before the stores), ``nc``
(loads through the read-only data path, ``__ldg``), ``cs`` (loads marked
evict-first, ``__ldcs``), ``block128`` and ``block512`` (threads a block).
The package itself is not changed. To compare two versions of the kernels,
run each checkout's copy of this script in turns within one chip call (A,
B, B, A):

    python3 scripts/pixel_shuffle_time.py [--label NAME] [--rounds 5] [--variants ...]

The last line is one JSON object with the label and, per size, kernel,
dtype and build, the summed ms, library ms, bound and the worst error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from maskcyclegan_vc_tpu_torch.ops import cuda_lib, ps  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dy shapes (B, C, 2H, 2W) by step size, with the dtypes whose step
# launches K6 there.
SITES = {
    "1x320": [((B, 128, 80, 320), ("f32", "bf16")) for B in (1, 3, 2)]
    + [((B, 256, 40, 160), ("f32",)) for B in (1, 3, 2)],
    "1x192": [((B, 128, 80, 192), ("f32", "bf16")) for B in (1, 3, 2)],
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
COPY = os.path.join(ROOT, "build", "pixel_shuffle_variants")
LOAD_HELPERS = '''template <typename T>
__device__ __forceinline__ T load_variant(const T* p) { return LOAD(p); }
__device__ __forceinline__ Words2 load_variant(const Words2* p) {
  return {LOAD(&p->a), LOAD(&p->b)};
}

'''
# (text in csrc/pixel_shuffle.cu, the text to put there) by variant
VARIANTS = {
    "units2": [("constexpr int kUnits = 1;", "constexpr int kUnits = 2;")],
    "block128": [("constexpr int kBlockThreads = 256;", "constexpr int kBlockThreads = 128;")],
    "block512": [("constexpr int kBlockThreads = 256;", "constexpr int kBlockThreads = 512;")],
}
for _name, _load in (("nc", "__ldg"), ("cs", "__ldcs")):
    VARIANTS[_name] = [
        ("// This thread's shuffled row R", LOAD_HELPERS.replace("LOAD", _load)
         + "// This thread's shuffled row R"),
        ("if (u < nU) s[k] = src[u];", "if (u < nU) s[k] = load_variant(src + u);"),
        ("e[k] = src0[u];", "e[k] = load_variant(src0 + u);"),
        ("o[k] = src1[u];", "o[k] = load_variant(src1 + u);"),
    ]


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


def build_variant(name: str) -> ctypes.CDLL:
    src = open(os.path.join(cuda_lib.CSRC, "pixel_shuffle.cu")).read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once in pixel_shuffle.cu")
        src = src.replace(old, new)
    os.makedirs(COPY, exist_ok=True)
    cu, so = os.path.join(COPY, f"{name}.cu"), os.path.join(COPY, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    for sym in ("inverse_pixel_shuffle_forward", "pixel_shuffle_forward"):
        for suffix in ("", "_bf16"):
            fn = getattr(lib, sym + suffix)
            fn.argtypes = [cuda_lib.PTR, cuda_lib.PTR] + [cuda_lib.INT] * 4 + [cuda_lib.PTR] * 2
            fn.restype = cuda_lib.INT
    return lib


def variant_fn(lib, kernel: str):
    """The variant's entry as a function of the input, as ``ops.ps`` calls
    the package's, and the route it reports."""
    route = ctypes.c_int()

    def call(t):
        B, C, H, W = t.shape
        if kernel == "inv_shuffle":
            B, C, H, W = B, C, H // 2, W // 2
            out = torch.empty((B, 4 * C, H, W), device=t.device, dtype=t.dtype)
            sym = "inverse_pixel_shuffle_forward"
        else:
            C = C // 4
            out = torch.empty((B, C, 2 * H, 2 * W), device=t.device, dtype=t.dtype)
            sym = "pixel_shuffle_forward"
        fn = getattr(lib, sym + ("_bf16" if t.dtype == torch.bfloat16 else ""))
        code = fn(t.data_ptr(), out.data_ptr(), B, C, H, W, ctypes.addressof(route),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{sym}: CUDA error {code}")
        return out

    return call, route


def package_fn(kernel: str):
    fn = ps.inverse_pixel_shuffle if kernel == "inv_shuffle" else ps.pixel_shuffle
    routes = getattr(ps, "SHUFFLE_ROUTES", None)
    return fn, routes


def run_site(build, kernel, t, rounds):
    if build == "as-is":
        fn, routes = package_fn(kernel)
        before = None if routes is None else dict(routes[kernel][t.dtype])
        got = fn(t)
        where = ("n/a" if routes is None else
                 " ".join(r for r, n in routes[kernel][t.dtype].items() if n > before[r]))
    else:
        fn, route = variant_fn(VARIANT_LIBS[build], kernel)
        got = fn(t)
        where = ("vector", "pair")[route.value]
    plain = ps.inverse_pixel_shuffle_plain if kernel == "inv_shuffle" else ps.pixel_shuffle_plain
    want = plain(t)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, want))
    err = (got.float() - want.float()).abs().max().item()
    times = [graph_ms(lambda: fn(t)) for _ in range(rounds)]
    return float(np.median(times)), times, err, ok, where


VARIANT_LIBS: dict = {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(ROOT))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pixel_shuffle_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for name in args.variants:
        VARIANT_LIBS[name] = build_variant(name)
    builds = ["as-is", *args.variants]
    gen = torch.Generator(device=device).manual_seed(0)
    sums, all_ok = {}, True
    for size, sites in SITES.items():
        for dshape, dnames in sites:
            B, C, H2, W2 = dshape
            for dname in dnames:
                dtype = DTYPES[dname]
                for kernel, shape in (("inv_shuffle", dshape),
                                      ("shuffle", (B, 4 * C, H2 // 2, W2 // 2))):
                    t = torch.randn(shape, device=device, generator=gen).to(dtype)
                    library = ((lambda: F.pixel_unshuffle(t, 2)) if kernel == "inv_shuffle"
                               else (lambda: F.pixel_shuffle(t, 2)))
                    lib_ms = float(np.median([graph_ms(library) for _ in range(args.rounds)]))
                    bnd = 1e3 * 2 * t.numel() * t.element_size() / HBM_BYTES_PER_S
                    for build in builds:
                        ms, times, err, ok, where = run_site(build, kernel, t, args.rounds)
                        all_ok &= ok
                        print(f"{args.label} {build} {size} {kernel} {dname} {shape}: ms {ms:.5f} "
                              f"(rounds {[round(x, 5) for x in times]}) library_ms {lib_ms:.5f} "
                              f"bound_ms {bnd:.5f}, {100 * bnd / ms:.1f} % of it; route {where}; "
                              f"max abs err {err:.3g} {'exact' if ok else 'FAILED'}", flush=True)
                        r = sums.setdefault(f"{build} {size} {kernel} {dname}", dict(
                            ms=0.0, library_ms=0.0, bound_ms=0.0, calls=0, max_abs_err=0.0))
                        r["ms"] += ms
                        r["library_ms"] += lib_ms
                        r["bound_ms"] += bnd
                        r["calls"] += 1
                        r["max_abs_err"] = max(r["max_abs_err"], err)
                    del t
    for k, r in sums.items():
        print(f"{args.label} {k}: {r['calls']} calls ms {r['ms']:.5f} library_ms "
              f"{r['library_ms']:.5f} bound_ms {r['bound_ms']:.5f}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it; card: {smi}")
    print(json.dumps({"label": args.label, "ok": bool(all_ok), "card": smi, "sums": sums}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
