// The whole mel frontend in one kernel: frame -> periodic Hann -> rDFT ->
// magnitude -> Slaney mel filterbank -> log10 with a 1e-5 clamp.
//
// Replaces maskcyclegan_vc_tpu/ops/pallas/melspec_kernel.py:116
// (log_mel_spectrogram_pallas, body _melspec_kernel :60), pad=False form:
// the reflect pad of 384 samples is done before the launch, as the JAX
// package does it outside the pallas_call. Forward only (the frontend is
// never differentiated).
//
// Layout: audio (B, L) f32, already padded; frame t is samples
// [256 t, 256 t + 1024). wc, ws: (1024, 513) f32, the window times the
// cos / sin DFT bases, built on the host in float64 as the JAX package
// builds them; melT: (513, 80). out: (B, 80, T), T = (L - 1024) / 256 + 1.
//
// Bound on an H100 SXM: f32 operations. Per frame 2 x 2 x 1024 x 513 flops
// for the DFT and 2 x 513 x 80 for the mel product, about 2.18 MFLOP, so a
// 576-frame bucket is 1.26 GFLOP, 0.019 ms at 67 TFLOP/s; its bytes (the
// audio in, the mels out, the 4.5 MB of constants) take ~0.0015 ms at
// 3.35 TB/s. The design: one block takes one (batch, tile of kFrames
// frames). It stages the tile's audio span (kFrames - 1) * 256 + 1024
// samples in shared memory, read straight from the padded audio with no
// framing in memory; 171 threads each own three DFT bins (171 x 3 = 513,
// so every warp does the same work) and accumulate re and im for all
// kFrames frames in registers with f32 FMAs, reading the bases from global
// memory (L2 holds them: 4.2 MB, read by every block) and the samples from
// shared memory four at a time. The magnitudes stay in shared memory; the
// block then projects them onto the 80 filters and writes log10 of the
// clamped value in (B, 80, T) directly. Nothing intermediate reaches
// device memory. The tensor cores are not used (the TPU kernel's products
// are true f32); the L2 traffic of the bases (every block reads all of
// them) and the small grid at batch 1 (T / kFrames blocks) are what keep
// it from its bound; a tensor-core (3xTF32) version is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kNFft = 1024;
constexpr int kHop = 256;
constexpr int kBins = 513;
constexpr int kMels = 80;
constexpr int kFrames = 8;                 // frames per block
constexpr int kBinThreads = 171;           // 171 x 3 = 513 bins
constexpr int kThreads = 192;              // 6 warps
constexpr int kSpan = (kFrames - 1) * kHop + kNFft;  // 2816 samples

__global__ void __launch_bounds__(kThreads)
melspec_kernel(const float* __restrict__ audio, const float* __restrict__ wc,
               const float* __restrict__ ws, const float* __restrict__ melT,
               float* __restrict__ out, int L, int T) {
  __shared__ __align__(16) float span[kSpan];
  __shared__ float mag[kFrames * kBins];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* a = audio + (size_t)b * L + (size_t)t0 * kHop;
  const int avail = L - t0 * kHop;  // samples of the span that exist
  for (int i = threadIdx.x; i < kSpan; i += kThreads)
    span[i] = i < avail ? a[i] : 0.f;
  __syncthreads();

  if (threadIdx.x < kBinThreads) {
    const int k0 = threadIdx.x;
    float re[3][kFrames], im[3][kFrames];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int f = 0; f < kFrames; ++f) re[j][f] = im[j][f] = 0.f;

    for (int n = 0; n < kNFft; n += 4) {
      float c[4][3], s[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const size_t off = (size_t)(n + q) * kBins + k0 + j * kBinThreads;
          c[q][j] = __ldg(wc + off);
          s[q][j] = __ldg(ws + off);
        }
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(span + f * kHop + n);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            re[j][f] = fmaf(xs[q], c[q][j], re[j][f]);
            im[j][f] = fmaf(xs[q], s[q][j], im[j][f]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        mag[f * kBins + k0 + j * kBinThreads] =
            sqrtf(re[j][f] * re[j][f] + im[j][f] * im[j][f] + 1e-24f);
  }
  __syncthreads();

  // Mel projection: output (m, f), f fastest so neighbouring threads write
  // neighbouring frames of one mel row.
  for (int idx = threadIdx.x; idx < kMels * kFrames; idx += kThreads) {
    const int f = idx % kFrames, m = idx / kFrames;
    const int t = t0 + f;
    if (t >= T) continue;
    const float* mg = mag + f * kBins;
    float acc = 0.f;
    for (int k = 0; k < kBins; ++k) acc = fmaf(mg[k], __ldg(melT + k * kMels + m), acc);
    out[((size_t)b * kMels + m) * T + t] = log10f(fmaxf(acc, 1e-5f));
  }
}

}  // namespace

extern "C" {

// audio: (B, L) padded f32; out: (B, 80, T). Returns a cudaError_t.
int log_mel_forward(const float* audio, const float* wc, const float* ws,
                    const float* melT, float* out, int B, int L, int T,
                    void* stream) {
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  melspec_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, wc, ws, melT, out, L, T);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
