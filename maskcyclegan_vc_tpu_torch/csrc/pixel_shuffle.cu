// Pixel-shuffle(2) and its inverse, as pure permutations.
//
// inverse_pixel_shuffle_forward replaces
// maskcyclegan_vc_tpu/ops/pallas/ps_kernel.py:164
// (inverse_pixel_shuffle_q_major, body _inv_shuffle_kernel :116), which the
// JAX package runs on the cotangent in the split backward of the upsample
// epilogue (_sis_bwd_xla :314, taken by _sis_bwd :386 past the fused
// kernel's budget). pixel_shuffle_forward replaces ps_kernel.py:138
// (pixel_shuffle_q_major, body _ps_shuffle_only :150), the standalone
// shuffle; in the port it is the inverse shuffle's gradient.
//
// Layout: NCHW, torch.nn.PixelShuffle channel order c*4 + q, q = 2i + j
// (JAX's is q-major NHWC). With x (B, 4C, H, W) and y (B, C, 2H, 2W):
//   y[b, c, 2h+i, 2w+j] = x[b, 4c+2i+j, h, w]
// pixel_shuffle_forward maps x to y (F.pixel_shuffle(x, 2));
// inverse_pixel_shuffle_forward maps y to x (F.pixel_unshuffle(y, 2)).
//
// Bound on an H100 SXM (3.35 TB/s): memory, 8 bytes per element (one read,
// one write) and no arithmetic. One thread owns one column pair (2w, 2w+1)
// of one row r = 2h+i of the shuffled tensor: it moves one float2 there and
// one float from each of the two unshuffled planes 4c+2i and 4c+2i+1 at
// (h, w). Consecutive threads take consecutive w, so across a warp the
// shuffled side is one run of 64 consecutive floats and the unshuffled side
// two runs of 32, all coalesced, with no shared memory. A row of the
// shuffled tensor holds 2W floats, an even count, so every float2 is 8-byte
// aligned whatever W is (the wrapper checks the base pointers).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;

struct Index {
  size_t shuffled;    // float2 offset of (b, c, r, 2w) in y, in floats / 2
  size_t unshuffled;  // offset of (b, 4c+2i, h, w) in x; plane +1 is + H*W
};

// t enumerates (b, c, r, w) with w fastest; r = 2h + i in [0, 2H).
__device__ __forceinline__ Index index_of(size_t t, int H, int W) {
  const size_t w = t % W;
  const size_t rest = t / W;
  const size_t r = rest % (2 * H);
  const size_t bc = rest / (2 * H);  // b * C + c
  const size_t h = r >> 1, i = r & 1;
  const size_t plane = 4 * bc + 2 * i;  // (b * 4C + 4c + 2i)
  return {rest * W + w, (plane * H + h) * W + w};
}

__global__ void inverse_pixel_shuffle_kernel(const float2* __restrict__ y,
                                             float* __restrict__ x, size_t n,
                                             int H, int W) {
  const size_t plane = (size_t)H * W;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const Index k = index_of(t, H, W);
    const float2 v = y[k.shuffled];
    x[k.unshuffled] = v.x;
    x[k.unshuffled + plane] = v.y;
  }
}

__global__ void pixel_shuffle_kernel(const float* __restrict__ x,
                                     float2* __restrict__ y, size_t n,
                                     int H, int W) {
  const size_t plane = (size_t)H * W;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const Index k = index_of(t, H, W);
    y[k.shuffled] = make_float2(x[k.unshuffled], x[k.unshuffled + plane]);
  }
}

// Enough blocks to cover n threads, capped; the loops stride past the cap.
int grid_for(size_t n) {
  const size_t blocks = (n + kBlockThreads - 1) / kBlockThreads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

}  // namespace

extern "C" {

// dy: (B, C, 2H, 2W); out: (B, 4C, H, W). Returns a cudaError_t.
int inverse_pixel_shuffle_forward(const float* dy, float* out, int B, int C,
                                  int H, int W, void* stream) {
  const size_t n = (size_t)B * C * 2 * H * W;
  if (n == 0) return 0;
  inverse_pixel_shuffle_kernel<<<grid_for(n), kBlockThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(dy), out, n, H, W);
  return (int)cudaGetLastError();
}

// x: (B, 4C, H, W); out: (B, C, 2H, 2W). Returns a cudaError_t.
int pixel_shuffle_forward(const float* x, float* out, int B, int C, int H,
                          int W, void* stream) {
  const size_t n = (size_t)B * C * 2 * H * W;
  if (n == 0) return 0;
  pixel_shuffle_kernel<<<grid_for(n), kBlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<float2*>(out), n, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
