// Pixel-shuffle(2), then affine InstanceNorm, then swish, in one pass; and
// its fused backward.
//
// ps_in_swish_forward replaces maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:344
// (_sis_fwd_impl), entry subpixel_in_swish (:371, body _ps_in_swish_kernel
// :96), and, with `lengths`, the masked XLA form the JAX generator runs in
// bucketed conversion (models/generator.py:303-306 and :319-322:
// pixel_shuffle_nhwc, InstanceNorm with tm_up1/tm_up2, swish). Given the
// optional `mean` and `inv` pointers it also writes each (sample, channel)'s
// statistics, as the Pallas forward emits them for its backward.
//
// ps_in_swish_backward replaces ps_kernel.py:259 (_sis_bwd_pallas, body
// _sis_bwd_kernel :185), the backward of subpixel_in_swish (:386-392): from
// the forward's mean and inv it computes dx and each sample's dscale and
// dbias, without re-reducing x for the statistics.
//
// Layout: NCHW. x is the upsample conv's (B, 4C, H, W) output in
// torch.nn.PixelShuffle order, channel c*4 + q with q = 2i + j, so the four
// rows of output channel c are contiguous in x. y is (B, C, 2H, 2W) with
//   y[b, c, 2h+i, 2w+j] = swish(a * x[b, 4c+2i+j, h, w] + b)
// where a, b fold the channel's statistics over its 2H x 2W output plane
// with the affine scale and bias. lengths[b] (optional, forward only)
// counts the valid output frames along 2W: the statistics take only the
// output columns ow < lengths[b], over their count clamped to at least 1,
// and every output at ow >= lengths[b] is written as 0. f32, two-pass,
// biased, eps 1e-5.
//
// Each entry has an f32 form and a bf16 form (the `_bf16` entries), as the
// Pallas kernels take x in either dtype (ps_kernel.py:73-111, :226-253): x,
// y, dy and dx are in that dtype; scale, bias, mean, inv, dscale, dbias and
// all arithmetic are f32, and each stored element is rounded once, to
// nearest even. In bf16 the backward's parked dz is rounded to bf16 and read
// back, as the Pallas kernel's dx block rounds it (ps_kernel.py:233, :251).
//
// Bound on an H100 SXM (3.35 TB/s): memory. The forward must read the 4C
// input rows once and write the shuffled tensor once, 8 bytes for each of
// the 4*C*H*W elements in f32 (4 in bf16); the backward must read x and dy
// and write dx, 12 bytes each (6 in bf16). The arithmetic (about fifteen flops and one exp per element
// forward, about thirty backward) is far under the f32 rate. The design
// gives each output channel to one block of kBlockThreads, which walks its
// plane in output order: y (forward) and dy (backward) are fully coalesced,
// and each pair of x or dx accesses (j = 0, 1) falls on two input rows at
// the same column, so a warp touches two runs of 16 consecutive floats.
// The shuffle is pure index arithmetic and is never materialised. The
// forward's three passes and the backward's two re-read from L2 rather
// than device memory at this model's sizes. The backward's pass A parks dz
// in dx, as the Pallas kernel does (:223-253), so pass B needs no second
// sigmoid: the parked value is written and read back by the same thread.
// The per-sample dscale and dbias leave as (B, C) and the caller sums them
// over B, so the result needs no atomics and does not depend on the order
// in which blocks run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kBlockThreads = 512;

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

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Offset in the channel's four input rows (each H x W) of output (oh, ow).
__device__ __forceinline__ int source_offset(int oh, int ow, int H, int W) {
  const int q = ((oh & 1) << 1) | (ow & 1);
  return (q * H + (oh >> 1)) * W + (ow >> 1);
}

template <typename T>
__global__ void ps_in_swish_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   const int* __restrict__ lengths,
                                   T* __restrict__ y,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ inv_out, int C, int H,
                                   int W) {
  __shared__ float smem[33];
  const int row = blockIdx.x;  // b * C + c
  const int b = row / C, c = row - b * C;
  const int H2 = 2 * H, W2 = 2 * W, S4 = 4 * H * W;
  const int L = lengths ? min(max(lengths[b], 0), W2) : W2;
  const int n = H2 * L;
  const float inv_n = 1.f / (float)max(n, 1);
  const T* xr = x + (size_t)row * S4;  // rows 4c .. 4c+3 of sample b
  T* yr = y + (size_t)row * S4;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int oh = i / L;
    s += load(xr, source_offset(oh, i - oh * L, H, W));
  }
  const float mean = block_sum(s, smem) * inv_n;

  float q = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int oh = i / L;
    const float d = load(xr, source_offset(oh, i - oh * L, H, W)) - mean;
    q += d * d;
  }
  const float inv = rsqrtf(block_sum(q, smem) * inv_n + kEps);
  const float a = inv * scale[c];
  const float sh = bias[c] - mean * a;
  if (mean_out && threadIdx.x == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }

  for (int o = threadIdx.x; o < S4; o += blockDim.x) {
    const int oh = o / W2, ow = o - oh * W2;
    float out = 0.f;
    if (ow < L) {
      const float z = load(xr, source_offset(oh, ow, H, W)) * a + sh;
      out = z / (1.f + expf(-z));
    }
    store(yr, o, out);
  }
}

template <typename T>
__global__ void ps_in_swish_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ mean_in, const float* __restrict__ inv_in,
    T* __restrict__ dx, float* __restrict__ dscale,
    float* __restrict__ dbias, int C, int H, int W) {
  __shared__ float smem[33];
  const int row = blockIdx.x;  // b * C + c
  const int c = row % C;
  const int W2 = 2 * W, S4 = 4 * H * W;
  const float mean = mean_in[row], inv = inv_in[row];
  const float a = inv * scale[c];
  const float sh = bias[c] - mean * a;
  const T* xr = x + (size_t)row * S4;
  const T* dyr = dy + (size_t)row * S4;
  T* dxr = dx + (size_t)row * S4;

  // Pass A: dz = dy * swish'(z), parked in dx; sums of dz and dz * x.
  float sdz = 0.f, sdzx = 0.f;
  for (int o = threadIdx.x; o < S4; o += blockDim.x) {
    const int oh = o / W2, ow = o - oh * W2;
    const int k = source_offset(oh, ow, H, W);
    const float xv = load(xr, k);
    const float z = xv * a + sh;
    const float sg = 1.f / (1.f + expf(-z));
    const float dz = load(dyr, o) * (sg + z * sg * (1.f - sg));
    store(dxr, k, dz);
    sdz += dz;
    sdzx += dz * xv;
  }
  sdz = block_sum(sdz, smem);
  sdzx = block_sum(sdzx, smem);
  // sum(dz * xhat) = inv * (sum(dz * x) - mean * sum(dz)).
  const float dsc = inv * (sdzx - mean * sdz);
  if (threadIdx.x == 0) {
    dscale[row] = dsc;
    dbias[row] = sdz;
  }

  // Pass B: dx = a * (dz - sum(dz)/n - xhat * dscale/n), xhat = (x-mean)*inv,
  // with dz the parked value (in bf16, rounded).
  const float inv_n = 1.f / (float)S4;
  const float mdz = sdz * inv_n, mdzx = dsc * inv_n;
  for (int o = threadIdx.x; o < S4; o += blockDim.x) {
    const int oh = o / W2, ow = o - oh * W2;
    const int k = source_offset(oh, ow, H, W);
    const float xhat = (load(xr, k) - mean) * inv;
    store(dxr, k, a * (load(dxr, k) - mdz - xhat * mdzx));
  }
}

template <typename T>
int forward(const void* x, const float* scale, const float* bias,
            const int* lengths, void* y, float* mean, float* inv, int B, int C,
            int H, int W, void* stream) {
  ps_in_swish_kernel<T><<<B * C, kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), scale, bias, lengths, static_cast<T*>(y), mean,
      inv, C, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* dy, const float* scale,
             const float* bias, const float* mean, const float* inv, void* dx,
             float* dscale, float* dbias, int B, int C, int H, int W,
             void* stream) {
  ps_in_swish_backward_kernel<T><<<B * C, kBlockThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias, mean,
      inv, static_cast<T*>(dx), dscale, dbias, C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, 4C, H, W); y: (B, C, 2H, 2W), both f32 (bf16 in the _bf16 entry);
// lengths: (B,) int32 or null; mean, inv: (B, C) f32 outputs, both null or
// both given. Returns a cudaError_t.
int ps_in_swish_forward(const void* x, const float* scale, const float* bias,
                        const int* lengths, void* y, float* mean, float* inv,
                        int B, int C, int H, int W, void* stream) {
  return forward<float>(x, scale, bias, lengths, y, mean, inv, B, C, H, W,
                        stream);
}

int ps_in_swish_forward_bf16(const void* x, const float* scale,
                             const float* bias, const int* lengths, void* y,
                             float* mean, float* inv, int B, int C, int H,
                             int W, void* stream) {
  return forward<__nv_bfloat16>(x, scale, bias, lengths, y, mean, inv, B, C,
                                H, W, stream);
}

// x, dx: (B, 4C, H, W); dy: (B, C, 2H, 2W), all f32 (bf16 in the _bf16
// entry); mean, inv: (B, C) f32 from the forward; dscale, dbias: (B, C) f32
// per-sample outputs. Returns a cudaError_t.
int ps_in_swish_backward(const void* x, const void* dy, const float* scale,
                         const float* bias, const float* mean,
                         const float* inv, void* dx, float* dscale,
                         float* dbias, int B, int C, int H, int W,
                         void* stream) {
  return backward<float>(x, dy, scale, bias, mean, inv, dx, dscale, dbias, B,
                         C, H, W, stream);
}

int ps_in_swish_backward_bf16(const void* x, const void* dy,
                              const float* scale, const float* bias,
                              const float* mean, const float* inv, void* dx,
                              float* dscale, float* dbias, int B, int C,
                              int H, int W, void* stream) {
  return backward<__nv_bfloat16>(x, dy, scale, bias, mean, inv, dx, dscale,
                                 dbias, B, C, H, W, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
