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
// Each entry has an f32 form and a bf16 form (the `_bf16` entries), as the
// Pallas kernels keep their input's dtype; both move bits and nothing else.
//
// Bound on an H100 SXM (3.35 TB/s): memory, two element sizes per element
// (one read, one write: 8 bytes in f32, 4 in bf16) and no arithmetic. One
// thread owns one column pair (2w, 2w+1) of one row r = 2h+i of the shuffled
// tensor: it moves one pair there (a float2, or a __nv_bfloat162) and one
// element from each of the two unshuffled planes 4c+2i and 4c+2i+1 at
// (h, w). Consecutive threads take consecutive w, so across a warp the
// shuffled side is one run of 64 consecutive elements and the unshuffled
// side two runs of 32, all coalesced, with no shared memory. A row of the
// shuffled tensor holds 2W elements, an even count, so every pair is aligned
// to twice the element size whatever W is (the wrapper checks the base
// pointers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;

struct Index {
  size_t shuffled;    // pair offset of (b, c, r, 2w) in y, in elements / 2
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

// T2 is the pair type of T: float2 for float, __nv_bfloat162 for bf16.
template <typename T, typename T2>
__global__ void inverse_pixel_shuffle_kernel(const T2* __restrict__ y,
                                             T* __restrict__ x, size_t n,
                                             int H, int W) {
  const size_t plane = (size_t)H * W;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const Index k = index_of(t, H, W);
    const T2 v = y[k.shuffled];
    x[k.unshuffled] = v.x;
    x[k.unshuffled + plane] = v.y;
  }
}

template <typename T, typename T2>
__global__ void pixel_shuffle_kernel(const T* __restrict__ x,
                                     T2* __restrict__ y, size_t n,
                                     int H, int W) {
  const size_t plane = (size_t)H * W;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const Index k = index_of(t, H, W);
    T2 v;
    v.x = x[k.unshuffled];
    v.y = x[k.unshuffled + plane];
    y[k.shuffled] = v;
  }
}

// Enough blocks to cover n threads, capped; the loops stride past the cap.
int grid_for(size_t n) {
  const size_t blocks = (n + kBlockThreads - 1) / kBlockThreads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

template <typename T, typename T2>
int inverse_shuffle(const void* dy, void* out, int B, int C, int H, int W,
                    void* stream) {
  const size_t n = (size_t)B * C * 2 * H * W;
  if (n == 0) return 0;
  inverse_pixel_shuffle_kernel<T, T2><<<grid_for(n), kBlockThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T2*>(dy), static_cast<T*>(out), n, H, W);
  return (int)cudaGetLastError();
}

template <typename T, typename T2>
int shuffle(const void* x, void* out, int B, int C, int H, int W,
            void* stream) {
  const size_t n = (size_t)B * C * 2 * H * W;
  if (n == 0) return 0;
  pixel_shuffle_kernel<T, T2><<<grid_for(n), kBlockThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T2*>(out), n, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dy: (B, C, 2H, 2W); out: (B, 4C, H, W); f32, or bf16 in the _bf16 entry.
// Returns a cudaError_t.
int inverse_pixel_shuffle_forward(const void* dy, void* out, int B, int C,
                                  int H, int W, void* stream) {
  return inverse_shuffle<float, float2>(dy, out, B, C, H, W, stream);
}

int inverse_pixel_shuffle_forward_bf16(const void* dy, void* out, int B,
                                       int C, int H, int W, void* stream) {
  return inverse_shuffle<__nv_bfloat16, __nv_bfloat162>(dy, out, B, C, H, W,
                                                        stream);
}

// x: (B, 4C, H, W); out: (B, C, 2H, 2W); f32, or bf16 in the _bf16 entry.
// Returns a cudaError_t.
int pixel_shuffle_forward(const void* x, void* out, int B, int C, int H,
                          int W, void* stream) {
  return shuffle<float, float2>(x, out, B, C, H, W, stream);
}

int pixel_shuffle_forward_bf16(const void* x, void* out, int B, int C, int H,
                               int W, void* stream) {
  return shuffle<__nv_bfloat16, __nv_bfloat162>(x, out, B, C, H, W, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
