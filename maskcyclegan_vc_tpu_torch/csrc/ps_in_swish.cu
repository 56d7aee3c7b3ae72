// Pixel-shuffle(2), then affine InstanceNorm, then swish, in one pass.
//
// Replaces maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:344 (_sis_fwd_impl),
// entry subpixel_in_swish (:371, body _ps_in_swish_kernel :96), forward
// only; and, with `lengths`, the masked XLA form the JAX generator runs in
// bucketed conversion (models/generator.py:303-306 and :319-322:
// pixel_shuffle_nhwc, InstanceNorm with tm_up1/tm_up2, swish).
//
// Layout: NCHW. x is the upsample conv's (B, 4C, H, W) output in
// torch.nn.PixelShuffle order, channel c*4 + q with q = 2i + j, so the four
// rows of output channel c are contiguous in x. y is (B, C, 2H, 2W) with
//   y[b, c, 2h+i, 2w+j] = swish(a * x[b, 4c+2i+j, h, w] + b)
// where a, b fold the channel's statistics over its 2H x 2W output plane
// with the affine scale and bias. lengths[b] (optional) counts the valid
// output frames along 2W: the statistics take only the output columns
// ow < lengths[b], over their count clamped to at least 1, and every output
// at ow >= lengths[b] is written as 0. f32, two-pass, biased, eps 1e-5.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The kernel must read the 4C
// input rows once and write the shuffled tensor once, 8 bytes for each of
// the 4*C*H*W elements; the arithmetic (about fifteen flops and one exp per
// element) is far under the f32 rate. The design gives each output channel
// to one block of kBlockThreads, which walks its plane in output order:
// writes are fully coalesced, and each read pair (j = 0, 1) comes from two
// input rows at the same column, so a warp's reads fall in two runs of 16
// consecutive floats. The shuffle is pure index arithmetic, so the shuffled
// tensor is written exactly once and never materialised unnormalised. As in
// in_gate.cu, the three passes re-read from L2 rather than device memory.

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

// Offset in the channel's four input rows (each H x W) of output (oh, ow).
__device__ __forceinline__ int source_offset(int oh, int ow, int H, int W) {
  const int q = ((oh & 1) << 1) | (ow & 1);
  return (q * H + (oh >> 1)) * W + (ow >> 1);
}

__global__ void ps_in_swish_kernel(const float* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   const int* __restrict__ lengths,
                                   float* __restrict__ y, int C, int H, int W) {
  __shared__ float smem[33];
  const int row = blockIdx.x;  // b * C + c
  const int b = row / C, c = row - b * C;
  const int H2 = 2 * H, W2 = 2 * W, S4 = 4 * H * W;
  const int L = lengths ? min(max(lengths[b], 0), W2) : W2;
  const int n = H2 * L;
  const float inv_n = 1.f / (float)max(n, 1);
  const float* xr = x + (size_t)row * S4;  // rows 4c .. 4c+3 of sample b
  float* yr = y + (size_t)row * S4;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int oh = i / L;
    s += xr[source_offset(oh, i - oh * L, H, W)];
  }
  const float mean = block_sum(s, smem) * inv_n;

  float q = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int oh = i / L;
    const float d = xr[source_offset(oh, i - oh * L, H, W)] - mean;
    q += d * d;
  }
  const float a = rsqrtf(block_sum(q, smem) * inv_n + kEps) * scale[c];
  const float sh = bias[c] - mean * a;

  for (int o = threadIdx.x; o < S4; o += blockDim.x) {
    const int oh = o / W2, ow = o - oh * W2;
    float out = 0.f;
    if (ow < L) {
      const float z = xr[source_offset(oh, ow, H, W)] * a + sh;
      out = z / (1.f + expf(-z));
    }
    yr[o] = out;
  }
}

}  // namespace

extern "C" {

// x: (B, 4C, H, W); y: (B, C, 2H, 2W); lengths: (B,) int32 or null.
// Returns a cudaError_t.
int ps_in_swish_forward(const float* x, const float* scale, const float* bias,
                        const int* lengths, float* y, int B, int C, int H,
                        int W, void* stream) {
  ps_in_swish_kernel<<<B * C, kBlockThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, scale, bias, lengths, y, C, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
