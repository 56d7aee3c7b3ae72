// Affine InstanceNorm, alone, followed by swish, or as the true-GLU pair
// IN(h) * sigmoid(IN(g)).
//
// Replaces maskcyclegan_vc_tpu/ops/pallas/in_gate_kernel.py:127
// (_call_per_sample) for its three entries:
//   in_forward       <- instance_norm_fused       (:152, body _in_kernel       :77)
//   in_swish_forward <- instance_norm_swish_fused (:181, body _in_swish_kernel :89)
//   in_glu_forward   <- instance_norm_glu_fused   (:214, body _in_glu_kernel   :101)
// and, with `lengths`, the masked XLA InstanceNorm that the JAX generator
// and discriminator run at the same call sites on padded inputs
// (ops/layers.py:204-215 and :270-278). Forward only: the backwards are
// the JAX package's XLA formulas, written in PyTorch (ops/in_gate.py).
//
// Each entry has an f32 form and a bf16 form (the `_bf16` entries), as the
// Pallas kernels take x in either dtype (in_gate_kernel.py:66-114): x and y
// are in that dtype, scale, bias and every statistic and product are f32,
// and y is rounded once, to nearest even, from the f32 result.
//
// Layout: NCHW. Each (sample, channel) is one contiguous row of S = H*W
// floats whose last axis, of width W, is time. For the GLU the input is the
// paired conv's (B, 2C, H, W) output: rows c and C+c are h and g. lengths[b]
// (optional) counts the valid frames along W: the statistics take only the
// positions with w < lengths[b], over their count clamped to at least 1, and
// every output at w >= lengths[b] is written as 0. Statistics are f32 and
// two-pass (mean, then the centred variance), biased, eps 1e-5.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The kernel must read each input
// float once and write each output float once; the arithmetic is about ten
// flops per element (swish adds one exp), two orders of magnitude under the
// f32 rate. The design gives every row to one thread group (a warp for rows
// of up to kWarpRowMaxS values, such as the 5120 rows of 112 in
// conv1dto2dLayer_tfan or the discriminator's downSample3 rows of 80 at 64
// frames; a block of kBlockThreads for long rows, such as the generator's
// downSample1 rows of 8960), so the
// statistics need no second launch and no atomics. Its three passes over a
// row (sum, centred squares, normalise and write) read the row three times;
// the second and third reads hit a row the same group has just read, which
// L2 (50 MB) still holds at this model's sizes, so device memory sees about
// one read and one write per element (2 bytes each in bf16). Loads are
// plain coalesced elements; wider loads and keeping the row on chip are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kBlockThreads = 512;
constexpr int kWarpRowsPerBlock = 8;
constexpr int kWarpRowMaxS = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread receives it. smem holds 33 floats.
// The trailing barrier lets the next call overwrite smem safely.
__device__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.f;
    r = warp_sum(r);
    if (lane == 0) smem[32] = r;
  }
  __syncthreads();
  const float total = smem[32];
  __syncthreads();
  return total;
}

template <bool kWarpRow>
__device__ __forceinline__ float row_sum(float v, float* smem) {
  return kWarpRow ? warp_sum(v) : block_sum(v, smem);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// What follows the normalisation: nothing, swish, or the GLU gate.
enum Epilogue { kPlain = 0, kSwish = 1, kGlu = 2 };

// Offset in a row of width W of the i-th valid position, when the first L
// columns of each of the row's H lines are valid.
__device__ __forceinline__ int valid_offset(int i, int L, int W) {
  const int h = i / L;
  return h * W + (i - h * L);
}

template <typename T, bool kWarpRow, int kEpilogue>
__global__ void in_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale_h,
                          const float* __restrict__ bias_h,
                          const float* __restrict__ scale_g,
                          const float* __restrict__ bias_g,
                          const int* __restrict__ lengths,
                          T* __restrict__ y, int B, int C, int S, int W) {
  constexpr bool kGated = kEpilogue == kGlu;
  __shared__ float smem[33];
  int row, t, nt;
  if (kWarpRow) {
    row = blockIdx.x * kWarpRowsPerBlock + (threadIdx.x >> 5);
    t = threadIdx.x & 31;
    nt = 32;
    if (row >= B * C) return;  // whole warps only: warp_sum stays full
  } else {
    row = blockIdx.x;
    t = threadIdx.x;
    nt = blockDim.x;
  }
  const int b = row / C, c = row - b * C;
  const int L = lengths ? min(max(lengths[b], 0), W) : W;
  const int n = (S / W) * L;
  const float inv_n = 1.f / (float)max(n, 1);

  const T* xh = x + ((kGated ? (size_t)b * 2 * C + c : (size_t)row) * S);
  const T* xg = xh + (size_t)C * S;  // read only when kGated
  T* yr = y + (size_t)row * S;

  float sh = 0.f, sg = 0.f;
  for (int i = t; i < n; i += nt) {
    const int k = valid_offset(i, L, W);
    sh += load(xh, k);
    if (kGated) sg += load(xg, k);
  }
  const float mh = row_sum<kWarpRow>(sh, smem) * inv_n;
  const float mg = kGated ? row_sum<kWarpRow>(sg, smem) * inv_n : 0.f;

  float qh = 0.f, qg = 0.f;
  for (int i = t; i < n; i += nt) {
    const int k = valid_offset(i, L, W);
    const float dh = load(xh, k) - mh;
    qh += dh * dh;
    if (kGated) {
      const float dg = load(xg, k) - mg;
      qg += dg * dg;
    }
  }
  const float ah = rsqrtf(row_sum<kWarpRow>(qh, smem) * inv_n + kEps) * scale_h[c];
  const float bh = bias_h[c] - mh * ah;
  float ag = 0.f, bg = 0.f;
  if (kGated) {
    ag = rsqrtf(row_sum<kWarpRow>(qg, smem) * inv_n + kEps) * scale_g[c];
    bg = bias_g[c] - mg * ag;
  }

  for (int s = t; s < S; s += nt) {
    float out = 0.f;
    if (s % W < L) {
      out = load(xh, s) * ah + bh;
      if (kEpilogue == kSwish) out = out / (1.f + expf(-out));
      if (kGated) out *= sigmoid(load(xg, s) * ag + bg);
    }
    store(yr, s, out);
  }
}

template <typename T, int kEpilogue>
int launch(const void* x, const float* scale_h, const float* bias_h,
           const float* scale_g, const float* bias_g, const int* lengths,
           void* y, int B, int C, int S, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * C;
  if (S <= kWarpRowMaxS) {
    const int blocks = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    in_kernel<T, true, kEpilogue><<<blocks, 32 * kWarpRowsPerBlock, 0, st>>>(
        static_cast<const T*>(x), scale_h, bias_h, scale_g, bias_g, lengths,
        static_cast<T*>(y), B, C, S, W);
  } else {
    in_kernel<T, false, kEpilogue><<<rows, kBlockThreads, 0, st>>>(
        static_cast<const T*>(x), scale_h, bias_h, scale_g, bias_g, lengths,
        static_cast<T*>(y), B, C, S, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, C, S) rows of f32 (bf16 in the _bf16 entries); scale, bias:
// (C,) f32; lengths: (B,) int32 or null. Each returns a cudaError_t.
int in_forward(const void* x, const float* scale, const float* bias,
               const int* lengths, void* y, int B, int C, int S, int W,
               void* stream) {
  return launch<float, kPlain>(x, scale, bias, nullptr, nullptr, lengths, y,
                               B, C, S, W, stream);
}

int in_forward_bf16(const void* x, const float* scale, const float* bias,
                    const int* lengths, void* y, int B, int C, int S, int W,
                    void* stream) {
  return launch<__nv_bfloat16, kPlain>(x, scale, bias, nullptr, nullptr,
                                       lengths, y, B, C, S, W, stream);
}

// swish(IN(x)); the same layout as in_forward.
int in_swish_forward(const void* x, const float* scale, const float* bias,
                     const int* lengths, void* y, int B, int C, int S, int W,
                     void* stream) {
  return launch<float, kSwish>(x, scale, bias, nullptr, nullptr, lengths, y,
                               B, C, S, W, stream);
}

int in_swish_forward_bf16(const void* x, const float* scale,
                          const float* bias, const int* lengths, void* y,
                          int B, int C, int S, int W, void* stream) {
  return launch<__nv_bfloat16, kSwish>(x, scale, bias, nullptr, nullptr,
                                       lengths, y, B, C, S, W, stream);
}

// x: (B, 2C, S) rows (h then g); y: (B, C, S).
int in_glu_forward(const void* x, const float* scale_h, const float* bias_h,
                   const float* scale_g, const float* bias_g,
                   const int* lengths, void* y, int B, int C, int S, int W,
                   void* stream) {
  return launch<float, kGlu>(x, scale_h, bias_h, scale_g, bias_g, lengths, y,
                             B, C, S, W, stream);
}

int in_glu_forward_bf16(const void* x, const float* scale_h,
                        const float* bias_h, const float* scale_g,
                        const float* bias_g, const int* lengths, void* y,
                        int B, int C, int S, int W, void* stream) {
  return launch<__nv_bfloat16, kGlu>(x, scale_h, bias_h, scale_g, bias_g,
                                     lengths, y, B, C, S, W, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
