// One MelGAN residual stage: three ResnetBlocks (dilations 1, 3, 9),
//   h = conv3_dil_d(reflect_pad(lrelu(x), d)) + b1
//   x = conv1(lrelu(h)) + b2 + conv1_shortcut(x) + bs
// then either lrelu of the result (emit_lrelu: the stage output only feeds
// lrelu -> the next up-conv) or the generator tail,
//   y = tanh(conv7(reflect_pad(lrelu(x), 3)) + b7)  -> (B, W).
//
// Replaces maskcyclegan_vc_tpu/ops/pallas/melgan_stack_kernel.py:362
// (melgan_resstack, body _stage_kernel :137). Forward only (the vocoder is
// never differentiated).
//
// Layout: PyTorch's conv layout, x (B, C, W), time contiguous, as the
// port's model keeps it for cuDNN's up-convs. Weights, packed by the
// wrapper (ops/melgan_stack.py) for all three blocks: w1 (3, 3, C, C) as
// [block][tap][ci][co]; b1 (3, C); wm (3, 2C, C) as [block][ci][co] with
// the shortcut's rows first and conv2's after; bm (3, C) = bs + b2; the
// tail's k7 (7, C) as [tap][ci] and b7 (1,).
//
// Each call has an f32 form and a bf16 form (the `_bf16` entry), as the
// Pallas kernel takes x in either dtype (melgan_stack_kernel.py:161-233).
// In bf16, x, the block buffers and the output are bf16, and so are the
// weights w1, wm and k7; the biases b1, bm, b7, shared memory and every
// product and sum are f32. Values are rounded to bf16 (to nearest even)
// where the Pallas kernel rounds them: lrelu(x) before the dilated conv,
// lrelu(h) before the merged 1x1 conv, each block's output, the emitted
// lrelu of the last one, and the waveform. In f32 every rounding is a no-op
// and the kernel is the one described above.
//
// Device launches per call: one per ResnetBlock (3), ping-ponging between
// two buffers the wrapper allocates, plus one for the tail (4 in all on the
// last stage).
//
// Bound on an H100 SXM: f32 operations. A block is 2 x (3 + 1 + 1) C^2
// flops per position, a stage 30 C^2 W (plus 14 C W for the tail): 30.5
// GFLOP over the four stages of a 431-frame decode, 0.455 ms at 67 TFLOP/s,
// while its bytes (x in, y out, ~2 x 4 x W x C a stage) take ~0.008 ms a
// stage at 3.35 TB/s. The design: a thread block takes one (batch, tile of
// TW = 4096 / C positions) and all C channels. It stages lrelu(x) over the
// tile and its +-d halo in shared memory, positions outside [0, W) taking
// their mirror (-m -> m, W-1+m -> W-1-m) exactly as the reference pads the
// whole sequence, and the raw x of the tile beside it; computes lrelu(h)
// for the tile and all C channels into shared memory; then the
// out-projection and the shortcut as one product over [x; lrelu(h)], adds
// the biases, and writes. Each of the 256 threads owns 4 output channels x
// 4 positions (positions strided by TW / 4, so shared-memory reads are
// conflict-free), reading a float4 of weights from global memory (L2) and
// four activations from shared memory per 16 FMAs. Shared memory is
// C * (3 TW + 2d) floats, 67.6 KB at C = 256, d = 9: dynamic, above the
// 48 KB default. Every block rereads the weights from L2, and the tensor
// cores are not used (true f32, as the TPU kernel's HIGHEST products);
// x makes a round trip through device memory between the blocks. A fully
// fused stage (x read once, a +-13 halo recomputed, as the TPU kernel keeps
// the stage in VMEM) and 3xTF32 tensor-core products are later work.
// In bf16 the same flops are bound by the dense bf16 tensor-core rate,
// 0.031 ms at 989 TFLOP/s, which this design, on the f32 cores, cannot
// approach: bf16 halves only the bytes, which do not bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // C * TW of one thread block
constexpr int kMaxC = 256;
constexpr int kMaxDilation = 9;
constexpr float kSlope = 0.2f;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes =
    (3 * kTileElems + 2 * kMaxDilation * kMaxC) * (int)sizeof(float);

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v stored as a T.
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the value a T buffer holds.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// Four consecutive weights (16 bytes in f32, 8 in bf16; aligned, since C
// and the channel offset are multiples of 4), read through the read-only
// cache.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Mirror index of position p in a sequence of W (W > pad), as reflect_pad.
// Positions a ragged last tile computes past W and never stores get any
// valid index.
__device__ __forceinline__ int reflect(int p, int W) {
  if (p < 0) p = -p;
  if (p >= W) p = 2 * (W - 1) - p;
  return min(max(p, 0), W - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const float* __restrict__ b1, const T* __restrict__ wm,
                const float* __restrict__ bm, T* __restrict__ y, int C,
                int W, int d, int emit_lrelu) {
  extern __shared__ __align__(16) float smem[];
  const int TW = kTileElems / C;
  const int HW = TW + 2 * d;  // width of a halo'd row
  float* xs = smem;           // (C, HW) lrelu(x) as T, mirrored at the edges
  float* xr = xs + C * HW;    // (C, TW) x
  float* hs = xr + C * TW;    // (C, TW) lrelu(h) as T

  const int b = blockIdx.y, w0 = blockIdx.x * TW;
  const T* xb = x + (size_t)b * C * W;
  for (int i = threadIdx.x; i < C * HW; i += kThreads) {
    const int c = i / HW, p = i - c * HW;
    xs[i] = round_to<T>(lrelu(to_float(xb[(size_t)c * W + reflect(w0 - d + p, W)])));
  }
  for (int i = threadIdx.x; i < C * TW; i += kThreads) {
    const int c = i / TW, p = i - c * TW;
    xr[i] = w0 + p < W ? to_float(xb[(size_t)c * W + w0 + p]) : 0.f;
  }
  __syncthreads();

  const int nwg = TW / 4;  // position groups; position j of group wg is wg + j * nwg
  const int wg = threadIdx.x % nwg;
  const int co = (threadIdx.x / nwg) * 4;
  float acc[4][4];

  // h = conv3_dil_d(xs) + b1, kept as lrelu(h).
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = b1[co + i];
  for (int tap = 0; tap < 3; ++tap) {
    const T* wt = w1 + (size_t)tap * C * C + co;
    const float* xt = xs + tap * d + wg;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wv = load4(wt + (size_t)ci * C);
      const float* row = xt + ci * HW;
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = row[j * nwg];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wa[i], xv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hs[(co + i) * TW + wg + j * nwg] = round_to<T>(lrelu(acc[i][j]));
  __syncthreads();

  // y = [shortcut | conv2] . [x ; lrelu(h)] + (bs + b2).
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = bm[co + i];
#pragma unroll 2
  for (int ci = 0; ci < C; ++ci) {
    const float4 sv = load4(wm + (size_t)ci * C + co);
    const float4 hv = load4(wm + (size_t)(C + ci) * C + co);
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
    const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
    float xv[4], gv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xv[j] = xr[ci * TW + wg + j * nwg];
      gv[j] = hs[ci * TW + wg + j * nwg];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(ha[i], gv[j], fmaf(sa[i], xv[j], acc[i][j]));
  }
  T* yb = y + (size_t)b * C * W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = w0 + wg + j * nwg;
    if (w >= W) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // The block's output as T; emitted, its lrelu, rounded again.
      const float v = round_to<T>(acc[i][j]);
      yb[(size_t)(co + i) * W + w] = from_float<T>(emit_lrelu ? lrelu(v) : v);
    }
  }
}

// y[b, w] = tanh(b7 + sum_{tap, ci} k7[tap, ci] * lrelu(x[b, ci, mirror(w + tap - 3)])),
// lrelu(x) rounded to T, the sum and tanh in f32, y rounded to T.
template <typename T>
__global__ void tail_kernel(const T* __restrict__ x, const T* __restrict__ k7,
                            const float* __restrict__ b7, T* __restrict__ y,
                            int C, int W) {
  const int b = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const T* xb = x + (size_t)b * C * W;
  int idx[7];
#pragma unroll
  for (int t = 0; t < 7; ++t) idx[t] = reflect(w + t - 3, W);
  float acc = b7[0];
  for (int ci = 0; ci < C; ++ci) {
    const T* row = xb + (size_t)ci * W;
#pragma unroll
    for (int t = 0; t < 7; ++t)
      acc = fmaf(to_float(k7[t * C + ci]), round_to<T>(lrelu(to_float(row[idx[t]]))), acc);
  }
  y[(size_t)b * W + w] = from_float<T>(tanhf(acc));
}

template <typename T>
int forward(const void* x_, const void* w1_, const float* b1, const void* wm_,
            const float* bm, const void* k7_, const float* b7, void* buf0_,
            void* buf1_, void* out_, int B, int C, int W, int emit_lrelu,
            void* stream) {
  if (C < 4 || C > kMaxC || 1024 % C != 0 || W <= kMaxDilation)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* wm = static_cast<const T*>(wm_);
  const T* k7 = static_cast<const T*>(k7_);
  T* buf0 = static_cast<T*>(buf0_);
  T* buf1 = static_cast<T*>(buf1_);
  T* out = static_cast<T*>(out_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Raise the kernel's dynamic shared memory limit once per device and
  // form, before any launch there (so never inside a CUDA graph capture).
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(resblock_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int TW = kTileElems / C;
  const dim3 grid((W + TW - 1) / TW, B);
  const T* src[3] = {x, buf0, buf1};
  T* dst[3] = {buf0, buf1, k7 ? buf0 : out};
  for (int j = 0, d = 1; j < 3; ++j, d *= 3) {
    const size_t smem = (size_t)C * (3 * TW + 2 * d) * sizeof(float);
    resblock_kernel<T><<<grid, kThreads, smem, st>>>(
        src[j], w1 + (size_t)j * 3 * C * C, b1 + (size_t)j * C,
        wm + (size_t)j * 2 * C * C, bm + (size_t)j * C, dst[j], C, W, d,
        j == 2 && emit_lrelu && !k7);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (k7) {
    tail_kernel<T><<<dim3((W + 255) / 256, B), 256, 0, st>>>(buf0, k7, b7, out, C, W);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

extern "C" {

// x: (B, C, W); buf0, buf1: (B, C, W) scratch; out: (B, C, W), or (B, W)
// when k7 is given. x, w1, wm, k7, the buffers and out are f32, or bf16 in
// the _bf16 entry; b1, bm and b7 are f32 in both. C a power of two from 4
// to 256, W > 9. Returns a cudaError_t.
int melgan_resstack_forward(const void* x, const void* w1, const float* b1,
                            const void* wm, const float* bm, const void* k7,
                            const float* b7, void* buf0, void* buf1, void* out,
                            int B, int C, int W, int emit_lrelu, void* stream) {
  return forward<float>(x, w1, b1, wm, bm, k7, b7, buf0, buf1, out, B, C, W,
                        emit_lrelu, stream);
}

int melgan_resstack_forward_bf16(const void* x, const void* w1, const float* b1,
                                 const void* wm, const float* bm, const void* k7,
                                 const float* b7, void* buf0, void* buf1, void* out,
                                 int B, int C, int W, int emit_lrelu, void* stream) {
  return forward<__nv_bfloat16>(x, w1, b1, wm, bm, k7, b7, buf0, buf1, out, B, C,
                                W, emit_lrelu, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
