#!/usr/bin/env python3
"""Measure the card's mma.sync rate: TF32 m16n8k8 and bf16 m16n8k16.

The ceiling for a kernel built on warp-level mma.sync (K9's f32 form,
csrc/melgan_stack.cu) rather than Hopper's wgmma, whose dense rates are the
published 495 TFLOP/s TF32 and 989 bf16. Each thread block's 8 warps run
back-to-back MMAs into ``ACCS`` independent accumulators from operands held
in registers (no memory traffic), for every SM several times over; the rate
is the flops of all MMAs over the device time (CUDA events, median of 5
launches after a warm-up). Builds its kernel with nvcc into
``build/mma_sync_peak/``. Run from the root of the repository:

    python3 scripts/mma_sync_peak.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.ops import cuda_lib  # noqa: E402

ACCS = 8
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int kAccs = %(accs)d;

__global__ void __launch_bounds__(256) tf32_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 2654435761u + i) & 0x3F80E000u;
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 40503u + i) & 0x3F80E000u;
  float acc[kAccs][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAccs; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%%0, %%1, %%2, %%3}, {%%4, %%5, %%6, %%7}, {%%8, %%9}, {%%0, %%1, %%2, %%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < kAccs; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) bf16_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 2654435761u + i) & 0x3F803F80u;
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 40503u + i) & 0x3F803F80u;
  float acc[kAccs][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAccs; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%%0, %%1, %%2, %%3}, {%%4, %%5, %%6, %%7}, {%%8, %%9}, {%%0, %%1, %%2, %%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < kAccs; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int which, float* out, int blocks, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) tf32_peak<<<blocks, 256, 0, st>>>(out, iters);
  else bf16_peak<<<blocks, 256, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(str(cuda_lib.BUILD_DIR)), "mma_sync_peak")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "peak.cu"), os.path.join(out_dir, "peak.so")
    with open(cu, "w") as f:
        f.write(SOURCE % {"accs": ACCS})
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_sync_peak: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for which, name, flops_per_mma in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                                       (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for per_sm in (1, 2, 4):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            times = []
            for rep in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                code = lib.launch(which, out.data_ptr(), blocks, iters, stream)
                end.record()
                torch.cuda.synchronize()
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")
                if rep:
                    times.append(start.elapsed_time(end))
            ms = sorted(times)[len(times) // 2]
            flops = blocks * 8 * iters * ACCS * flops_per_mma
            print(f"mma.sync {name}: {per_sm} block(s) of 8 warps per SM, {ACCS} accumulators "
                  f"a warp: {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s ({ms:.3f} ms)")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
