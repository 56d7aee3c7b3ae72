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
// lrelu of the last one, and the waveform. The two forms run different
// block kernels (below); the tail kernel is one template.
//
// Device launches per call: one per ResnetBlock (3), ping-ponging between
// two buffers the wrapper allocates, plus one for the tail (4 in all on the
// last stage).
//
// Bound on an H100 SXM: operations. A block is 2 x (3 + 1 + 1) C^2 flops
// per position, a stage 30 C^2 W (plus 14 C W for the tail): 30.5 GFLOP
// over the four stages of a 431-frame decode, while its bytes (x in, y out,
// ~2 x 4 x W x C a stage) take ~0.008 ms a stage at 3.35 TB/s.
//
// f32 (melgan_resstack_forward): 3xTF32 on the tensor cores. Each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (round to
// nearest, ties away, on the top 10 mantissa bits, as cvt.rna.tf32.f32), and
// a product a.b is taken as
// a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, the small terms first, into an f32
// accumulator. The dropped lo.lo term and the rounding of lo are ~2^-22 of
// the product; one TF32 product alone (~2^-11) misses the card tests'
// tolerance by 5-7x. The tensor cores' own accumulation loses more than f32
// adds do: one accumulator over a whole product (K = 3C) put a C = 256
// stage 1.6e-5 of its scale from the plain f32 chain on an H100. So each
// chunk of 32 K rows sums into a zeroed partial that is added to the
// accumulator in f32, which brings it to 1.3e-6, the f32-core kernel's own
// distance (PERF.md). The bound is then three TF32 products per f32 flop at
// 495 TFLOP/s dense: 0.185 ms per 431-frame decode (0.455 ms at the 67
// TFLOP/s of the f32 cores). mma.sync itself peaks at ~310 TFLOP/s TF32 on
// an H100 (scripts/mma_sync_peak.py), ~103 TFLOP/s of f32 products.
//
// The f32 design (resblock_tc_kernel): a thread block takes one (batch,
// tile of TW = kTileOut / max(C, 32) positions) and all C output channels;
// its 8 warps each own 32 channels x 8 NT positions (2 x NT m16n8 tiles).
// Shared memory holds x of the tile, lrelu(x) over the tile and its +-d
// halo, positions outside [0, W) taking their mirror (-m -> m, W-1+m ->
// W-1-m) exactly as the reference pads the whole sequence, and two chunks
// of kChunkK weight rows [k][co]: cp.async (16 B, .cg: through L2 only)
// brings the next chunk in while the warps multiply the current one. Both
// products are implicit GEMMs on mma.sync.m16n8k8 TF32 with f32
// accumulators: h = conv3_dil_d(lrelu(x)) + b1 is M = C x N = TW x K = 3C,
// where row k = tap * C + ci of B is lrelu(x) row ci shifted by tap * d (a
// shifted fragment address, no im2col); the merged [shortcut | conv2] 1x1
// conv is K = 2C over [x ; lrelu(h)], lrelu(h) written over the space
// lrelu(x) held. Operands are split into hi and lo in registers as each
// fragment loads, so the weights cross L2 in f32, once per thread block:
// 5 C^2 floats each, ~1 GB per 431-frame decode at kTileOut = 8192. Shared
// rows are padded to a stride of 8 or 24 modulo 32 floats, so the 8 x 4
// lanes of a fragment load (row lane % 4, column lane / 4) hit 32 banks.
// Stages narrower than a warp's 32 channels (C < 32, in tests only) pad
// the output channels with zero weights; a product's K is padded to whole
// chunks with zero weights, whose B rows read any valid row. x makes a round
// trip through device memory between the blocks. A fully fused stage (x
// read once, a +-13 halo recomputed, as the TPU kernel keeps the stage in
// VMEM) and wgmma/TMA are later work.
//
// The bf16 design (resblock_kernel, the _bf16 entry only): the f32 cores.
// A thread block takes one (batch, tile of TW = 4096 / C positions) and all
// C channels, stages lrelu(x) with its mirrored halo and x in shared memory
// as above, computes lrelu(h) into shared memory, then the merged 1x1 conv
// over [x; lrelu(h)]. Each of the 256 threads owns 4 output channels x 4
// positions (positions strided by TW / 4, so shared-memory reads are
// conflict-free), reading a float4 of weights from global memory (L2) and
// four activations from shared memory per 16 FMAs. Shared memory is
// C * (3 TW + 2d) floats, 67.6 KB at C = 256, d = 9. Its flops are bound by
// the dense bf16 tensor-core rate, 0.031 ms at 989 TFLOP/s, which this
// design cannot approach; its redesign on the tensor cores (mma.sync
// m16n8k16 in bf16, no split) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // C * TW of one thread block of the bf16 kernel
constexpr int kMaxC = 256;
constexpr int kMaxDilation = 9;
constexpr float kSlope = 0.2f;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes =
    (3 * kTileElems + 2 * kMaxDilation * kMaxC) * (int)sizeof(float);

// The f32 kernel's tile: output channels (padded to 32) x positions of one
// thread block. 8192 against 4096 and 16384: PERF.md.
constexpr int kTileOut = 8192;
constexpr int kChunkK = 32;  // weight rows (K) a chunk stages
constexpr int kTcThreads = 256;
constexpr int kWarps = kTcThreads / 32;

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

// Four consecutive bf16 weights (8 bytes; aligned, since C and the channel
// offset are multiples of 4), read through the read-only cache.
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

// ---- f32: 3xTF32 on the tensor cores ----

// Shared-memory row stride for rows of n floats: n rounded up to a multiple
// of 8 that is 8 or 24 modulo 32, so a fragment load's lanes (row lane % 4,
// column lane / 4 + const) fall in 32 distinct banks.
__host__ __device__ constexpr int padded_stride(int n) {
  return (n + 7) / 8 * 8 % 16 == 0 ? (n + 7) / 8 * 8 + 8 : (n + 7) / 8 * 8;
}

template <int C>
struct TcShape {
  static constexpr int MP = C < 32 ? 32 : C;         // output channels, zero-padded
  static constexpr int TW = kTileOut / MP;           // positions of a tile
  static constexpr int WARPS_M = MP / 32;            // warps along the channels
  static constexpr int NT = TW / (kWarps / WARPS_M) / 8;  // n8 tiles of a warp
  static constexpr int SB = padded_stride(TW);       // stride of x and lrelu(h) rows
  static constexpr int SA = MP + 8;                  // stride of a weight chunk's rows
  static constexpr int K1 = 3 * C, K2 = 2 * C;       // K of the two products
  static constexpr int N1 = (K1 + kChunkK - 1) / kChunkK;  // chunks of each
  static constexpr int N2 = (K2 + kChunkK - 1) / kChunkK;
  static_assert(MP % 32 == 0 && kWarps % WARPS_M == 0 && NT >= 1, "tile");
  // x (C, SB); lrelu(x) (C, SH), later lrelu(h) (C, SB); 2 weight chunks.
  static constexpr int smem_bytes(int d) {
    return 4 * (C * SB + C * padded_stride(TW + 2 * d) + 2 * kChunkK * SA);
  }
};

// v rounded to TF32 (round to nearest, ties away), as the b32 an mma takes:
// cvt.rna.tf32.f32's rounding for finite and infinite v, in two integer
// operations. The cvt compiles to a longer sequence (PERF.md). ptxas drops
// the mask where the mma, which ignores the low 13 bits, is the only reader.
// A NaN whose mantissa is all ones (the card's own, 0x7FFFFFFF) carries into
// the sign and comes out as -0: split() keeps NaN out of it.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to ~2^-22 of v, both TF32. A NaN v passes into hi unchanged,
// so every product it enters is NaN, as in f32; lo is then of no account.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = isnan(v) ? __float_as_uint(v) : to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 in, f32 accumulate. Fragments (g = lane / 4,
// t = lane % 4): a {(g, t), (g+8, t), (g, t+4), (g+8, t+4)} of A (16 x 8);
// b {(t, g), (t+4, g)} of B (8 x 8); d {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)} of D (16 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Every accumulator of channel co set to bias[co] (0 past C).
template <int C, int NT>
__device__ __forceinline__ void set_bias(float (&acc)[2][NT][4], const float* bias,
                                         int m0, int g) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int co = m0 + mt * 16 + g;
    const float lo = co < C ? bias[co] : 0.f, hi = co + 8 < C ? bias[co + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = lo;
      acc[mt][nt][2] = acc[mt][nt][3] = hi;
    }
  }
}

// acc += the chunk's weights wc (kChunkK rows [k][co], k from k0 in the
// product) times the B rows rows(k), 3xTF32, for the warp's 32 channels
// from m0 and NT x 8 positions from n0. The chunk's MMAs sum into a zeroed
// partial, added to acc in f32: an MMA's sum into a large accumulator loses
// more than an f32 add does, and one accumulator over all of K = 3C lands
// ~12x further from the f32 chain at C = 256 (PERF.md).
template <int C, int NT, class Rows>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][NT][4], const float* wc, int k0,
                                          int m0, int n0, int g, int t, Rows rows) {
  constexpr int SA = TcShape<C>::SA;
  float part[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kChunkK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* a = wc + (kk + t) * SA + m0 + mt * 16 + g;
      split(a[0], ah[mt][0], al[mt][0]);
      split(a[8], ah[mt][1], al[mt][1]);
      split(a[4 * SA], ah[mt][2], al[mt][2]);
      split(a[4 * SA + 8], ah[mt][3], al[mt][3]);
    }
    const float* r0 = rows(k0 + kk + t) + n0 + g;
    const float* r1 = rows(k0 + kk + t + 4) + n0 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(r0[nt * 8], bh[0], bl[0]);
      split(r1[nt * 8], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(part[mt][nt], ah[mt], bl);
        mma_tf32(part[mt][nt], al[mt], bh);
        mma_tf32(part[mt][nt], ah[mt], bh);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// Thread blocks an SM holds: two where shared memory fits two (C <= 64),
// which caps registers at 128 a thread (spilling none; PERF.md).
template <int C>
__global__ void __launch_bounds__(kTcThreads, C <= 64 ? 2 : 1)
resblock_tc_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ wm,
                   const float* __restrict__ bm, float* __restrict__ y, int W, int d,
                   int emit_lrelu) {
  using S = TcShape<C>;
  constexpr int NT = S::NT, SB = S::SB, SA = S::SA;
  extern __shared__ __align__(16) float smem[];
  const int SH = padded_stride(S::TW + 2 * d);
  // Rows k of [x ; lrelu(h)] lie at xr + k * SB: lrelu(h) is written over
  // lrelu(x), which starts right after x.
  float* xr = smem;           // (C, SB) x of the tile
  float* xs = xr + C * SB;    // (C, SH) lrelu(x), mirrored at the edges
  float* ws = xs + C * SH;    // 2 x (kChunkK, SA) weights [k][co]

  const int tid = threadIdx.x;
  // Chunk c of the block's weights, w1's rows then wm's, into buffer c % 2;
  // channels past C and rows past the product's K are zeros.
  auto load_chunk = [&](int c) {
    const bool first = c < S::N1;
    const float* src = first ? w1 : wm;
    const int k0 = (first ? c : c - S::N1) * kChunkK;
    const int K = first ? S::K1 + 0 : S::K2 + 0;  // values, not references
    float* dst = ws + (c & 1) * kChunkK * SA;
    constexpr int Q = S::MP / 4;  // 16-byte pieces of a row
    for (int i = tid; i < kChunkK * Q; i += kTcThreads) {
      const int r = i / Q, q = i - r * Q;
      float* p = dst + r * SA + 4 * q;
      if (k0 + r < K && 4 * q < C)
        cp_async16(p, src + (size_t)(k0 + r) * C + 4 * q);
      else
        *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  };
  load_chunk(0);

  const int b = blockIdx.y, w0 = blockIdx.x * S::TW;
  const float* xb = x + (size_t)b * C * W;
  const int HW = S::TW + 2 * d;
  for (int i = tid; i < C * HW; i += kTcThreads) {
    const int c = i / HW, p = i - c * HW;
    const float v = xb[(size_t)c * W + reflect(w0 - d + p, W)];
    xs[c * SH + p] = lrelu(v);
    if (p >= d && p < d + S::TW) xr[c * SB + p - d] = v;
  }

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = (warp % S::WARPS_M) * 32, n0 = (warp / S::WARPS_M) * NT * 8;
  float acc[2][NT][4];
  set_bias<C>(acc, b1, m0, g);
  // B row k of the dilated conv: lrelu(x) row k % C shifted by tap k / C.
  auto rows1 = [&](int k) {
    k = min(k, S::K1 - 1);
    return (const float*)xs + (k % C) * SH + (k / C) * d;
  };
  // B row k of the merged 1x1 conv: row k of [x ; lrelu(h)].
  auto rows2 = [&](int k) { return (const float*)xr + min(k, S::K2 - 1) * SB; };

  constexpr int kChunks = S::N1 + S::N2;
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c (and at c = 0 the tile) in; chunk c - 1 done
    if (c + 1 < kChunks) load_chunk(c + 1);
    if (c == S::N1) {
      // The dilated conv is done in every warp: lrelu(h) over lrelu(x).
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = m0 + mt * 16 + g + 8 * h, n = n0 + nt * 8 + 2 * t;
            if (co < C) {
              xs[co * SB + n] = lrelu(acc[mt][nt][2 * h]);
              xs[co * SB + n + 1] = lrelu(acc[mt][nt][2 * h + 1]);
            }
          }
      set_bias<C>(acc, bm, m0, g);
      __syncthreads();
    }
    const float* wc = ws + (c & 1) * kChunkK * SA;
    if (c < S::N1)
      mma_chunk<C>(acc, wc, c * kChunkK, m0, n0, g, t, rows1);
    else
      mma_chunk<C>(acc, wc, (c - S::N1) * kChunkK, m0, n0, g, t, rows2);
  }

  float* yb = y + (size_t)b * C * W;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = m0 + mt * 16 + g + 8 * h;
        if (co >= C) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int w = w0 + n0 + nt * 8 + 2 * t + j;
          const float v = acc[mt][nt][2 * h + j];
          if (w < W) yb[(size_t)co * W + w] = emit_lrelu ? lrelu(v) : v;
        }
      }
}

// Raise every f32 instantiation's dynamic shared memory limit once per
// device, before any launch there (so never inside a CUDA graph capture).
template <int C>
cudaError_t raise_tc_smem() {
  return cudaFuncSetAttribute(resblock_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TcShape<C>::smem_bytes(kMaxDilation));
}

template <int C>
cudaError_t launch_tc(const float* const src[3], float* const dst[3], const float* w1,
                      const float* b1, const float* wm, const float* bm, int B, int W,
                      int emit_lrelu, cudaStream_t st) {
  using S = TcShape<C>;
  const dim3 grid((W + S::TW - 1) / S::TW, B);
  for (int j = 0, d = 1; j < 3; ++j, d *= 3) {
    resblock_tc_kernel<C><<<grid, kTcThreads, S::smem_bytes(d), st>>>(
        src[j], w1 + (size_t)j * 3 * C * C, b1 + (size_t)j * C, wm + (size_t)j * 2 * C * C,
        bm + (size_t)j * C, dst[j], W, d, j == 2 && emit_lrelu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The three ResnetBlocks of one call, src[j] -> dst[j]. f32: the tensor-core
// kernel for C.
cudaError_t launch_blocks(const float* const src[3], float* const dst[3], const float* w1,
                          const float* b1, const float* wm, const float* bm, int B, int C,
                          int W, int emit_lrelu, int dev, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  if (!raised[dev]) {
    const cudaError_t errs[] = {raise_tc_smem<4>(), raise_tc_smem<8>(), raise_tc_smem<16>(),
                                raise_tc_smem<32>(), raise_tc_smem<64>(),
                                raise_tc_smem<128>(), raise_tc_smem<256>()};
    for (const cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  switch (C) {
    case 4: return launch_tc<4>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 8: return launch_tc<8>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 16: return launch_tc<16>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 32: return launch_tc<32>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 64: return launch_tc<64>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 128: return launch_tc<128>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    case 256: return launch_tc<256>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the scalar kernel.
cudaError_t launch_blocks(const __nv_bfloat16* const src[3], __nv_bfloat16* const dst[3],
                          const __nv_bfloat16* w1, const float* b1,
                          const __nv_bfloat16* wm, const float* bm, int B, int C, int W,
                          int emit_lrelu, int dev, cudaStream_t st) {
  using T = __nv_bfloat16;
  static bool raised[kMaxDevices] = {};
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int TW = kTileElems / C;
  const dim3 grid((W + TW - 1) / TW, B);
  for (int j = 0, d = 1; j < 3; ++j, d *= 3) {
    const size_t smem = (size_t)C * (3 * TW + 2 * d) * sizeof(float);
    resblock_kernel<T><<<grid, kThreads, smem, st>>>(
        src[j], w1 + (size_t)j * 3 * C * C, b1 + (size_t)j * C,
        wm + (size_t)j * 2 * C * C, bm + (size_t)j * C, dst[j], C, W, d,
        j == 2 && emit_lrelu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const T* const src[3] = {x, buf0, buf1};
  T* const dst[3] = {buf0, buf1, k7 ? buf0 : out};
  err = launch_blocks(src, dst, w1, b1, wm, bm, B, C, W, emit_lrelu && !k7, dev, st);
  if (err != cudaSuccess) return (int)err;
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
