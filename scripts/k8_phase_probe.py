#!/usr/bin/env python3
"""Where a thread block of K8 (the fused mel frontend) spends its time, on one card.

Builds copies of ``csrc/melspec.cu`` under ``build/k8_phase_probe/`` with
timers added: thread 0 of each thread block of ``log_mel_kernel`` reads
``%globaltimer`` (ns) at seven points (start; the span and the first chunk
of the bases in; the DFT's products done; the magnitudes and the filter
rows in shared memory; the block's partial mels written; the cluster's
partials all written; the end) and its SM's id. Besides the kernel as it is
(``as-is``), variants that each take one cost away, to see what sets the
pace: ``no-mma`` (each mma an empty asm statement that keeps its operands'
dependences and issues nothing; the compiler may then drop work that fed
only the products), ``no-copy`` (the bases' chunks never copied; the
products read whatever shared memory holds) and ``no-copy-mma``; and
orders that may run faster: ``a-major`` (each pass's products ordered by A
fragment, not by B) and ``flush-4`` (a partial over four chunks, not
two). The package itself is not changed.
For pre-padded audio of each bucket at batch 1 (seeded noise, as
``log_mel_time.py``) the script launches each build's ``log_mel_forward``
and prints its device time (CUDA events over 20 launches), the launch's
span from the first block's start to the last block's end, and each
phase's median over the blocks, in microseconds. The timers cost a few
instructions a block. Only ``as-is`` computes the log-mel.

    python3 scripts/k8_phase_probe.py [--variants as-is no-mma no-copy ...]
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "k8_phase_probe")
FRAMES = (192, 448, 576)
PHASES = ["span and first chunk", "products", "magnitudes", "projection",
          "cluster wait", "reduction"]
MAX_BLOCKS = 1 << 14

TIMERS = '''__device__ unsigned long long g_probe[MAX_BLOCKS * 8];
__device__ __forceinline__ void mark(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    if (blk < MAX_BLOCKS) {
      g_probe[blk * 8 + k] = t;
      g_probe[blk * 8 + 7] = sm;
    }
  }
}

'''.replace("MAX_BLOCKS", str(MAX_BLOCKS))
ENTRIES = '''int k8_probe_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(g_probe));
}

int k8_probe_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
}

'''
# (text in log_mel_kernel, the text to put there); each must occur after
# the kernel's signature.
MARKS = [
    ("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n  mark(0);\n"),
    ("    load_chunk(c + kStages - 1);\n", "    if (c == 0) mark(1);\n    load_chunk(c + kStages - 1);\n"),
    ("  __syncthreads();  // the ring is free", "  mark(2);\n  __syncthreads();  // the ring is free"),
    ("  // This block's bins onto the filters", "  mark(3);\n  // This block's bins onto the filters"),
    ("  cluster.sync();  // every block's partial is written\n",
     "  mark(4);\n  cluster.sync();  // every block's partial is written\n  mark(5);\n"),
    ("  cluster.sync();  // no block leaves", "  mark(6);\n  cluster.sync();  // no block leaves"),
]


# Text edits that take one cost away each; a variant applies its list.
NO_MMA = ('  asm(\n      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
          '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n',
          '  asm(""\n      ""\n')
NO_COPY = [("    if (tid == 0 && c < kChunks) {", "    if (tid == 0 && c < 0) {"),
           ("    wait_phase(&full[c % kStages], (c / kStages) & 1);\n", "")]
A_MAJOR = ("#pragma unroll\n        for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
           "          for (int mt = 0; mt < 2; ++mt)\n",
           "#pragma unroll\n        for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
           "          for (int i = 0; i < 4; ++i)\n")
FLUSH4 = ("constexpr int kFlushChunks = 2;", "constexpr int kFlushChunks = 4;")
VARIANTS = {
    "as-is": [],
    "a-major": [A_MAJOR],
    "flush-4": [FLUSH4],
    "a-major-flush-4": [A_MAJOR, FLUSH4],
    "no-mma": [NO_MMA],
    "no-copy": NO_COPY,
    "no-copy-mma": NO_COPY + [NO_MMA],
}


def instrumented(src: str, variant: str) -> str:
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise RuntimeError(f"k8_phase_probe: {old!r} not found in csrc/melspec.cu")
        src = src.replace(old, new)
    k = src.index("log_mel_kernel(const float*")
    head = src.rindex("__global__", 0, k)
    src = src[:head] + TIMERS + src[head:]
    k = src.index("log_mel_kernel(const float*")
    for old, new in MARKS:
        j = src.find(old, k)
        if j < 0:
            raise RuntimeError(f"k8_phase_probe: {old!r} not found in log_mel_kernel")
        src = src[:j] + new + src[j + len(old):]
    j = src.index("const char* kernel_error_string(int code) {")
    return src[:j] + ENTRIES + src[j:]


def build(variant: str) -> ctypes.CDLL:
    from maskcyclegan_vc_tpu_torch.ops import cuda_lib

    os.makedirs(COPY, exist_ok=True)
    cu = os.path.join(COPY, f"melspec-{variant}.cu")
    with open(cu, "w") as f:
        f.write(instrumented((cuda_lib.CSRC / "melspec.cu").read_text(), variant))
    so = os.path.join(COPY, f"melspec-{variant}.so")
    out = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"k8_phase_probe: nvcc failed for {variant}:\n{out.stdout}{out.stderr}")
    regs = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if "registers" in ln]
    print(f"{variant}: {' '.join(regs)}", flush=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.log_mel_forward.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.log_mel_forward.restype = I
    lib.k8_probe_read.argtypes = [P]
    return lib


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from maskcyclegan_vc_tpu_torch.ops import melspec

    shutil.rmtree(COPY, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    device = torch.device("cuda")
    wc, ws, melT = melspec.kernel_constants(str(device))
    buf = np.zeros(MAX_BLOCKS * 8, np.uint64)
    for variant in args.variants:
        lib = build(variant)
        for T in FRAMES:
            L = 1024 + 256 * (T - 1)
            g = torch.Generator(device=device).manual_seed(T)
            audio = torch.randn((1, L), device=device, generator=g) * 0.3
            out = torch.empty((1, 80, T), device=device)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                code = lib.log_mel_forward(audio.data_ptr(), wc.data_ptr(), ws.data_ptr(),
                                           melT.data_ptr(), out.data_ptr(), 1, L, T, stream)
                if code != 0:
                    raise RuntimeError(f"k8_phase_probe: {variant} launch failed ({code})")

            for _ in range(3):
                launch()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            if lib.k8_probe_clear() != 0:
                raise RuntimeError("k8_phase_probe: clearing the timers failed")
            launch()
            torch.cuda.synchronize()
            if lib.k8_probe_read(buf.ctypes.data) != 0:
                raise RuntimeError("k8_phase_probe: reading the timers failed")
            t = buf.reshape(-1, 8).astype(np.int64)
            t = t[t[:, 0] > 0]
            span = (t[:, 6].max() - t[:, 0].min()) / 1e3
            starts = (t[:, 0] - t[:, 0].min()) / 1e3
            phases = ", ".join(f"{name} {np.median(t[:, i + 1] - t[:, i]) / 1e3:.2f}"
                               for i, name in enumerate(PHASES))
            err = ""
            if variant == "as-is":
                want = melspec.log_mel_spectrogram_plain(audio, pad=False)
                err = f"; max abs err {(out - want).abs().max().item():.3g}"
            print(f"{variant} T {T}: {1e3 * ms:.2f} us a launch; {len(t)} blocks on "
                  f"{len(np.unique(t[:, 7]))} SMs, launch span {span:.2f} us, block starts "
                  f"spread over {starts.max():.2f} us; block median "
                  f"{np.median(t[:, 6] - t[:, 0]) / 1e3:.2f} us: {phases}{err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
