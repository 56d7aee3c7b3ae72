#!/usr/bin/env python3
"""Where a thread block of K9's bf16 kernel spends its time, on one card.

Copies ``maskcyclegan_vc_tpu_torch`` into ``build/k9_phase_probe/`` and adds
timers to the copy of ``csrc/melgan_stack.cu``: thread 0 of each thread
block of ``resblock_bf16_kernel`` reads ``%globaltimer`` (ns) at seven
points (start; x and its halo in shared memory; the first weight chunk in;
the dilated conv done; the merged 1x1 conv done; the output staged; the
output stored) and its SM's id. The package itself is not changed; the
copy builds into its own ``build/``. For each (B, C, W) the script calls the
copy's bf16 stage (emit_lrelu, seeded weights as ``k9_stage_time.py``) and
prints, for the last of its three block launches (d = 9), the launch's span
from the first block's start to the last block's end and each phase's
median over the blocks, in microseconds. The timers cost a few instructions
a block; the spans are device time, not the kernel's time from events.

    python3 scripts/k9_phase_probe.py
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
COPY = os.path.join(ROOT, "build", "k9_phase_probe")
SHAPES = [(1, 256, 3448), (1, 128, 27584), (1, 64, 55168), (1, 32, 110336),
          (32, 256, 1024), (32, 128, 8192), (32, 64, 16384), (32, 32, 32768)]
PHASES = ["load x", "first chunk", "dilated conv", "1x1 conv", "staging", "store"]
MAX_BLOCKS = 1 << 17

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
ENTRIES = '''int k9_probe_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(g_probe));
}

int k9_probe_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
}

'''
# (text in the bf16 kernel, the text to put there); each must occur after
# the kernel's signature.
MARKS = [
    ("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n  mark(0);\n"),
    ("  const int warp = tid / 32,", "  mark(1);\n  const int warp = tid / 32,"),
    ("    if (c == S::N1) {\n", "    if (c == 0) mark(2);\n    if (c == S::N1) {\n      mark(3);\n"),
    ("  __syncthreads();\n#pragma unroll\n  for (int mt = 0; mt < MT; ++mt)",
     "  __syncthreads();\n  mark(4);\n#pragma unroll\n  for (int mt = 0; mt < MT; ++mt)"),
    ("  bf16* yb = y + (size_t)b * C * W;\n", "  mark(5);\n  bf16* yb = y + (size_t)b * C * W;\n"),
    ("ys[co * S::SY + p];\n    }\n  }\n}\n", "ys[co * S::SY + p];\n    }\n  }\n  mark(6);\n}\n"),
]


def instrumented(src: str) -> str:
    k = src.index("resblock_bf16_kernel(const bf16*")
    head = src.rindex("template <int C, int TILE>", 0, k)
    src = src[:head] + TIMERS + src[head:]
    k = src.index("resblock_bf16_kernel(const bf16*")
    for old, new in MARKS:
        j = src.find(old, k)
        if j < 0:
            raise RuntimeError(f"k9_phase_probe: {old!r} not found in the bf16 kernel")
        src = src[:j] + new + src[j + len(old):]
    j = src.index("const char* kernel_error_string(int code) {")
    return src[:j] + ENTRIES + src[j:]


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "maskcyclegan_vc_tpu_torch"),
                    os.path.join(COPY, "maskcyclegan_vc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(COPY, "maskcyclegan_vc_tpu_torch", "csrc", "melgan_stack.cu")
    with open(cu) as f:
        src = instrumented(f.read())
    with open(cu, "w") as f:
        f.write(src)
    # The copy's package first: k9_stage_time, imported after it, then finds
    # it in sys.modules and not the package of this checkout.
    sys.path.insert(0, COPY)
    from maskcyclegan_vc_tpu_torch.ops import cuda_lib, melgan_stack  # noqa: E402
    if not cuda_lib.CSRC.is_relative_to(COPY):
        raise RuntimeError(f"k9_phase_probe: imported {cuda_lib.CSRC}, not the copy")
    sys.path.append(os.path.join(ROOT, "scripts"))
    from k9_stage_time import stage_inputs  # noqa: E402

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib = cuda_lib.load("melgan_stack")
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    device = torch.device("cuda")
    for B, C, W in SHAPES:
        x, blocks, _ = stage_inputs(B, C, W, device, C + W)
        x = x.bfloat16()
        blocks = [{k: v.bfloat16() for k, v in bp.items()} for bp in blocks]
        with torch.inference_mode():
            for _ in range(3):
                melgan_stack.melgan_resstack(x, blocks, emit_lrelu=True)
            torch.cuda.synchronize()
            if lib.k9_probe_clear() != 0:
                raise RuntimeError("k9_phase_probe: clearing the timers failed")
            melgan_stack.melgan_resstack(x, blocks, emit_lrelu=True)
            torch.cuda.synchronize()
        if lib.k9_probe_read(buf) != 0:
            raise RuntimeError("k9_phase_probe: reading the timers failed")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8).astype(np.int64)
        t = t[t[:, 0] > 0]
        span = (t[:, 6].max() - t[:, 0].min()) / 1e3
        phases = ", ".join(f"{name} {np.median(t[:, i + 1] - t[:, i]) / 1e3:.2f}"
                           for i, name in enumerate(PHASES))
        print(f"B {B} C {C} W {W}: {len(t)} blocks on {len(np.unique(t[:, 7]))} SMs, launch "
              f"span {span:.2f} us; block median {np.median(t[:, 6] - t[:, 0]) / 1e3:.2f} us: "
              f"{phases}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
