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
// ~2 x W x C elements of 4 bytes, or 2 in bf16) take ~0.008 ms a stage in
// f32 at 3.35 TB/s. Both forms multiply on the tensor cores (below).
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
// W-1-m, repeated where m >= W: reflect()) exactly as the reference pads
// the whole sequence, and two chunks
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
// The bf16 design (resblock_bf16_kernel, the _bf16 entry): the same two
// implicit GEMMs on mma.sync.m16n8k16 bf16 with f32 accumulators, with the
// roles swapped: M = positions, N = output channels, K = tap x ci (and
// [x ; lrelu(h)] for the 1x1 conv). bf16 fragments pair two elements
// consecutive along K in one register, so the activations are staged
// position-major, [p][c]: the A operand of tap t is rows p + t * d, any row
// of which is a 16-byte-aligned address for ldmatrix.x4, and the weights,
// packed [k][co], give B through ldmatrix.trans. Rows are padded to an odd
// number of 16-byte units, so the 8 rows of an ldmatrix phase hit all 32
// banks. A thread block takes one (batch, tile of TW = TILE / NP positions)
// and all NP = max(C, 8) output channels, each warp 32 channels (fewer when
// NP < 32) x MT m16 tiles; TILE is 8192 outputs, or 16384 where the grid
// still fills two thread blocks an SM (half the weight reads from L2). Each
// tap's (or part's) K is padded to CK = max(C, 16) with zero weights and
// zero activations. Weight chunks of min(CK, 64) rows are double-buffered by
// cp.async as in the f32 form; a chunk never straddles a tap. x arrives 16
// bytes (8 positions) a load where its rows allow, and its halo element by
// element. lrelu(h)'s D fragment (positions g and g + 8, channels 2t and
// 2t + 1) is one bf16x2 word at one position: it is written straight into
// the [p][c] rows lrelu(x) held (row p + d), and the block's output through
// shared memory as [c][p], so the (B, C, W) store runs along W, 16 bytes a
// store where the rows allow. Every product is bf16 x bf16, exact in f32, so the MMA changes only the
// summation order; one accumulator per output sums a whole product (the
// tensor cores' accumulation error, ~1.6e-5 of the scale in f32, is far
// inside the bf16 tolerance of two roundings). Its bound: the dense bf16
// tensor rate, 0.031 ms per 431-frame decode at 989 TFLOP/s; mma.sync
// peaks near 600 TFLOP/s on an H100 (scripts/mma_sync_peak.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 256;
constexpr int kMaxDilation = 9;
constexpr float kSlope = 0.2f;
constexpr int kMaxDevices = 64;

// The f32 kernel's tile: output channels (padded to 32) x positions of one
// thread block. 8192 against 4096 and 16384: PERF.md.
constexpr int kTileOut = 8192;
constexpr int kChunkK = 32;  // weight rows (K) a chunk stages
// The bf16 kernel's tiles, output channels (padded to 8) x positions: the
// large one halves the weight reads from L2 and is taken where its grid
// still fills two thread blocks an SM (Kernels<bf16, C>::launch); its weight
// chunks (rows of K, at most) and the chunks in flight. Tiles against each
// other: PERF.md.
constexpr int kTileOutBf16 = 8192;
constexpr int kTileOutBf16Large = 16384;
constexpr int kChunkKBf16 = 64;
constexpr int kStagesBf16 = 2;
constexpr int kLoadBatch = 8;  // x loads a thread keeps in flight, element by element
constexpr int kVecBatch = 2;   // and 16-byte pairs (8 positions of 2 channels)
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

// Mirror index of position p in a sequence of W > 9, every pad's one
// reflection (-m -> m, W-1+m -> W-1-m), as reflect_pad. Positions a ragged
// last tile computes past W and never stores get any valid index.
__device__ __forceinline__ int mirror_once(int p, int W) {
  if (p < 0) p = -p;
  if (p >= W) p = 2 * (W - 1) - p;
  return min(max(p, 0), W - 1);
}

// Mirror index of position p in a sequence of any W >= 1, as reflect_pad
// and jnp.pad(mode="reflect"): for W <= 9 (a mel of 1 frame reaches the
// first stage at W = 8) the mirror repeats with period 2 (W - 1), as the
// Pallas kernel's sequential fill does (melgan_stack_kernel.py:123-134);
// at W = 1 every position is 0. W is the same across the grid, so the
// branch never diverges; past 9 the code is mirror_once's (a general
// mirror there cost K9 4-5 % on an H100, scripts/k9_stage_time.py).
__device__ __forceinline__ int reflect(int p, int W) {
  if (W > kMaxDilation) return mirror_once(p, W);
  if (W == 1) return 0;
  const int period = 2 * (W - 1);
  p %= period;
  if (p < 0) p += period;
  return p < W ? p : period - p;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
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
    cp_async_wait<0>();
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

// ---- bf16: mma.sync m16n8k16 on a position-major tile ----

using bf16 = __nv_bfloat16;

// Row stride, in bf16, of shared rows of n bf16 (n a multiple of 8): an odd
// number of 16-byte units, so the 8 rows an ldmatrix phase reads fall in 8
// distinct groups of 4 banks.
__host__ __device__ constexpr int ldm_stride(int n) { return n / 8 % 2 ? n : n + 8; }

template <int C, int TILE>
struct Bf16Shape {
  static constexpr int NP = C < 8 ? 8 : C;            // output channels (N), zero-padded
  static constexpr int CK = C < 16 ? 16 : C;          // K of a tap or part, zero-padded
  static constexpr int TW = TILE / NP;                // positions (M) of a tile
  static constexpr int WN = NP < 32 ? NP : 32;        // channels of a warp
  static constexpr int NT = WN / 8;                   // n8 tiles of a warp
  static constexpr int WARPS_N = NP / WN;             // warps along the channels
  static constexpr int MT = TW / 16 / (kWarps / WARPS_N);  // m16 tiles of a warp
  static constexpr int SR = ldm_stride(CK);           // stride of activation rows [p][c]
  static constexpr int SW = ldm_stride(NP);           // stride of weight rows [k][co]
  static constexpr int KC = CK < kChunkKBf16 ? CK : kChunkKBf16;  // weight rows of a chunk
  static constexpr int N1 = 3 * CK / KC, N2 = 2 * CK / KC;  // chunks of each product
  static constexpr int SY = TW + 8;                   // stride of the output's rows [c][p]
  static_assert(TW % 32 == 0, "whole tiles load and store 8 positions a thread");
  static_assert(kWarps % WARPS_N == 0 && MT >= 1 && (NT == 1 || NT % 2 == 0), "tile");
  // x (TW, SR); lrelu(x) (TW + 2d, SR), later lrelu(h) at rows d..d+TW-1;
  // kStagesBf16 weight chunks (KC, SW). The output (C, SY) is staged over x
  // and lrelu(x).
  static constexpr int smem_bytes(int d) {
    return 2 * ((2 * TW + 2 * d) * SR + kStagesBf16 * KC * SW);
  }
  static_assert(C * SY <= 2 * TW * SR, "the output's staging fits over x and lrelu(x)");
};

// Four 8 x 8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l receives elements (l / 4, 2 (l % 4) .. +1) of each, one
// register per matrix. .trans: elements (2 (l % 4) .. +1, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate. Fragments (g = lane / 4,
// t = lane % 4), each register two elements consecutive along K:
// a {(g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..9), (g+8, 2t+8..9)} of A
// (16 x 16); b {(2t..2t+1, g), (2t+8..9, g)} of B (16 x 8); d {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} of D (16 x 8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Every accumulator of channel co set to bias[co] (0 past C).
template <int C, int MT, int NT>
__device__ __forceinline__ void set_bias_bf16(float (&acc)[MT][NT][4], const float* bias,
                                              int n0, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = n0 + nt * 8 + 2 * t;
    const float lo = co < C ? bias[co] : 0.f, hi = co + 1 < C ? bias[co + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] = acc[mt][nt][2] = lo;
      acc[mt][nt][1] = acc[mt][nt][3] = hi;
    }
  }
}

// acc += A . wc over one chunk of KC rows of K. a: the chunk's first A
// column at the warp's first position, A row m at a + m * SR; wc: the chunk
// (KC, SW) [k][co]. Lane l addresses A row l % 16, columns (l / 16) * 8 of
// an m16 x k16 tile (matrices: rows 0-7 and 8-15 at k 0-7, then at k 8-15:
// a0..a3), and B row l % 16, columns n + (l / 16) * 8 (k 0-7 and 8-15 of
// two n8 tiles: b0, b1 of each; x2: one n8 tile, lanes 0-15).
template <class S, int MT, int NT>
__device__ __forceinline__ void mma_chunk_bf16(float (&acc)[MT][NT][4], const bf16* a,
                                               const bf16* wc, int n0, int lane) {
  const bf16* ar = a + (lane % 16) * S::SR + (lane / 16) * 8;
  const bf16* br = wc + (lane % 16) * S::SW + n0 + (NT > 1 ? (lane / 16) * 8 : 0);
#pragma unroll
  for (int kk = 0; kk < S::KC; kk += 16) {
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], ar + mt * 16 * S::SR + kk);
    if constexpr (NT == 1) {
      ldmatrix_x2_trans(bf[0], br + kk * S::SW);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, br + kk * S::SW + np * 16);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int C, int TILE>
__global__ void __launch_bounds__(kTcThreads, 2)
resblock_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ wm,
                     const float* __restrict__ bm, bf16* __restrict__ y, int W, int d,
                     int emit_lrelu) {
  using S = Bf16Shape<C, TILE>;
  constexpr int MT = S::MT, NT = S::NT, SR = S::SR, SW = S::SW, KC = S::KC, CK = S::CK;
  extern __shared__ __align__(16) bf16 smem_bf16[];
  bf16* xr = smem_bf16;                     // (TW, SR) x of the tile, [p][c]
  bf16* xs = xr + S::TW * SR;               // (TW + 2d, SR) lrelu(x), mirrored at the edges
  bf16* ws = xs + (S::TW + 2 * d) * SR;     // kStagesBf16 x (KC, SW) weights [k][co]
  bf16* ys = smem_bf16;                     // (C, SY) the output, [c][p], at the end

  const int tid = threadIdx.x;
  // Chunk c of the block's weights, w1's then wm's, into buffer c %
  // kStagesBf16 (past the last chunk, an empty group). Row k of a product is
  // part k / CK (w1: the tap; wm: shortcut, conv2), channel ci = k % CK:
  // packed row part * C + ci, zeros for ci >= C and co >= C.
  constexpr int kChunks = S::N1 + S::N2;
  auto load_chunk = [&](int c) {
    if (c >= kChunks) {
      cp_async_commit();
      return;
    }
    const bool first = c < S::N1;
    const bf16* src = first ? w1 : wm;
    const int k0 = (first ? c : c - S::N1) * KC;
    bf16* dst = ws + (c % kStagesBf16) * KC * SW;
    constexpr int Q = S::NP / 8;  // 16-byte pieces of a row
    for (int i = tid; i < KC * Q; i += kTcThreads) {
      const int r = i / Q, q = i - r * Q;
      const int part = (k0 + r) / CK, ci = (k0 + r) % CK;
      bf16* p = dst + r * SW + 8 * q;
      const bf16* from = src + (size_t)(part * C + ci) * C + 8 * q;
      if (ci >= C) {
        *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (C % 8 == 0) {
        cp_async16(p, from);
      } else {  // C = 4: one 8-byte row, then zeros
        const uint2 v = *reinterpret_cast<const uint2*>(from);
        *reinterpret_cast<uint4*>(p) = make_uint4(v.x, v.y, 0u, 0u);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c + 1 < kStagesBf16; ++c) load_chunk(c);

  // lrelu(x) over the tile and its +-d halo, rounded to bf16, and x of the
  // tile, [p][c]; channels past C are zeros.
  const int b = blockIdx.y, w0 = blockIdx.x * S::TW;
  const bf16* xb = x + (size_t)b * C * W;
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto put = [&](int p, int c, bf16 v) {  // p: row of lrelu(x), from w0 - d
    xs[p * SR + c] = __float2bfloat16_rn(lrelu(__bfloat162float(v)));
    if (p >= d && p < d + S::TW) xr[(p - d) * SR + c] = v;
  };
  // A whole tile on 16-byte rows of x and y: loaded and stored 16 bytes at
  // a time.
  const bool whole = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0 && w0 + S::TW <= W;
  if (whole) {
    // 8 positions of channels c and c + 1 an item, stored as bf16x2 words;
    // a warp takes 8 channel pairs x 4 groups of 8 positions, 64 contiguous
    // bytes of each of its rows. The halo, d rows each side, is mirrored at
    // the sequence's ends. A thread issues the loads of kVecBatch items (the
    // first time with its halo's) before it stores any.
    constexpr int PG = S::TW / 8, PB = CK / 16;  // position groups; blocks of 8 pairs
    constexpr int NV = CK / 2 * PG / kTcThreads;   // items a thread
    constexpr int NH = (CK * 2 * kMaxDilation + kTcThreads - 1) / kTcThreads;
    // A whole tile lies in a row wider than any pad: one mirror suffices.
    static_assert(S::TW > kMaxDilation, "tile narrower than the pads");
    static_assert(PG % 4 == 0 && CK / 2 * PG % kTcThreads == 0 && NV % kVecBatch == 0,
                  "tile positions");
    const int nh = CK * 2 * d;
    bf16 hv[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int i = tid + h * kTcThreads, c = i / (2 * d), e = i - c * 2 * d;
      const int p = e < d ? e : S::TW + e;  // row of lrelu(x)
      hv[h] = i < nh && c < C ? xb[(size_t)c * W + mirror_once(w0 - d + p, W)] : zero;
    }
#pragma unroll
    for (int v0 = 0; v0 < NV; v0 += kVecBatch) {
      uint4 u[kVecBatch][2];
      int cs[kVecBatch], ps[kVecBatch];
#pragma unroll
      for (int v = 0; v < kVecBatch; ++v) {
        const int i = tid + (v0 + v) * kTcThreads, r = i / 32;
        const int c = cs[v] = 2 * ((r % PB) * 8 + i % 8);
        const int p0 = ps[v] = 8 * ((r / PB) * 4 + i / 8 % 4);
        u[v][0] = u[v][1] = make_uint4(0u, 0u, 0u, 0u);
        if (c < C) {  // C is even: c + 1 < C too
          u[v][0] = *reinterpret_cast<const uint4*>(xb + (size_t)c * W + w0 + p0);
          u[v][1] = *reinterpret_cast<const uint4*>(xb + (size_t)(c + 1) * W + w0 + p0);
        }
      }
      if (v0 == 0) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int i = tid + h * kTcThreads, c = i / (2 * d), e = i - c * 2 * d;
          if (i < nh) put(e < d ? e : S::TW + e, c, hv[h]);
        }
      }
#pragma unroll
      for (int v = 0; v < kVecBatch; ++v) {
        const bf16* lo = reinterpret_cast<const bf16*>(&u[v][0]);
        const bf16* hi = reinterpret_cast<const bf16*>(&u[v][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162 x2;
          x2.x = lo[j];
          x2.y = hi[j];
          *reinterpret_cast<__nv_bfloat162*>(xr + (ps[v] + j) * SR + cs[v]) = x2;
          *reinterpret_cast<uint32_t*>(xs + (ps[v] + j + d) * SR + cs[v]) =
              pack_bf16x2(lrelu(__bfloat162float(x2.x)), lrelu(__bfloat162float(x2.y)));
        }
      }
    }
  } else {
    // A ragged last tile, or rows not on 16-byte boundaries: element by
    // element along W, kLoadBatch loads a thread in flight before it stores.
    const int HW = S::TW + 2 * d, n = CK * HW;
    for (int i0 = tid; i0 < n; i0 += kLoadBatch * kTcThreads) {
      bf16 v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kTcThreads, c = i / HW;
        v[u] = i < n && c < C ? xb[(size_t)c * W + reflect(w0 - d + i - c * HW, W)] : zero;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kTcThreads, c = i / HW;
        if (i < n) put(i - c * HW, c, v[u]);
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n0 = (warp % S::WARPS_N) * S::WN, m0 = (warp / S::WARPS_N) * MT * 16;
  float acc[MT][NT][4];
  set_bias_bf16<C>(acc, b1, n0, t);

  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait<kStagesBf16 - 2>();
    __syncthreads();  // chunk c (and at c = 0 the tile) in; chunk c - 1 done
    load_chunk(c + kStagesBf16 - 1);
    if (c == S::N1) {
      // The dilated conv is done in every warp: lrelu(h), rounded to bf16,
      // over lrelu(x) at rows p + d, one bf16x2 word per position.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m0 + mt * 16 + g + 8 * h, co = n0 + nt * 8 + 2 * t;
            const uint32_t v = co < C ? pack_bf16x2(lrelu(acc[mt][nt][2 * h]),
                                                    lrelu(acc[mt][nt][2 * h + 1]))
                                      : 0u;
            *reinterpret_cast<uint32_t*>(xs + (p + d) * SR + co) = v;
          }
      set_bias_bf16<C>(acc, bm, n0, t);
      __syncthreads();
    }
    // The chunk's A: tap k0 / CK of lrelu(x), rows shifted by tap * d; then
    // [x ; lrelu(h)], x's rows or lrelu(h)'s at rows p + d.
    const int k0 = (c < S::N1 ? c : c - S::N1) * KC, part = k0 / CK, ci0 = k0 % CK;
    const bf16* a = c < S::N1 ? xs + (m0 + part * d) * SR + ci0
                              : (part == 0 ? xr + m0 * SR : xs + (m0 + d) * SR) + ci0;
    mma_chunk_bf16<S>(acc, a, ws + (c % kStagesBf16) * KC * SW, n0, lane);
  }

  // The block's output, rounded to bf16 (emitted: its lrelu, rounded again),
  // staged as [c][p] over x and lrelu(x), then stored along W.
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + mt * 16 + g + 8 * (i / 2), co = n0 + nt * 8 + 2 * t + i % 2;
        const float v = __bfloat162float(__float2bfloat16_rn(acc[mt][nt][i]));
        if (co < C) ys[co * S::SY + p] = __float2bfloat16_rn(emit_lrelu ? lrelu(v) : v);
      }
  __syncthreads();
  bf16* yb = y + (size_t)b * C * W;
  if (whole) {  // 16 bytes (8 positions) a store
    for (int i = tid; i < C * S::TW / 8; i += kTcThreads) {
      const int co = i / (S::TW / 8), p = 8 * (i - co * (S::TW / 8));
      *reinterpret_cast<uint4*>(yb + (size_t)co * W + w0 + p) =
          *reinterpret_cast<const uint4*>(ys + co * S::SY + p);
    }
  } else {
    for (int i = tid; i < C * S::TW; i += kTcThreads) {
      const int co = i / S::TW, p = i - co * S::TW;
      if (w0 + p < W) yb[(size_t)co * W + w0 + p] = ys[co * S::SY + p];
    }
  }
}

// ---- launching the three blocks ----

// A block kernel with its shape: f32 3xTF32, or bf16 m16n8k16 at one tile.
template <int C>
struct TcBlock {
  using S = TcShape<C>;
  static constexpr auto kernel = &resblock_tc_kernel<C>;
};
template <int C, int TILE>
struct Bf16Block {
  using S = Bf16Shape<C, TILE>;
  static constexpr auto kernel = &resblock_bf16_kernel<C, TILE>;
};

// Raise a kernel's dynamic shared memory limit; done for every kernel once
// per device, before any launch there (so never inside a CUDA graph
// capture).
template <class K>
cudaError_t raise_smem() {
  return cudaFuncSetAttribute(K::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              K::S::smem_bytes(kMaxDilation));
}

// The three ResnetBlocks of one call on kernel K, src[j] -> dst[j].
template <class K, int C, typename T>
cudaError_t launch_k(const T* const src[3], T* const dst[3], const T* w1, const float* b1,
                     const T* wm, const float* bm, int B, int W, int emit_lrelu,
                     cudaStream_t st) {
  using S = typename K::S;
  const auto kernel = K::kernel;
  const dim3 grid((W + S::TW - 1) / S::TW, B);
  for (int j = 0, d = 1; j < 3; ++j, d *= 3) {
    kernel<<<grid, kTcThreads, S::smem_bytes(d), st>>>(
        src[j], w1 + (size_t)j * 3 * C * C, b1 + (size_t)j * C, wm + (size_t)j * 2 * C * C,
        bm + (size_t)j * C, dst[j], W, d, j == 2 && emit_lrelu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The kernels of an element type and width, and which one a call takes.
template <typename T, int C>
struct Kernels;
template <int C>
struct Kernels<float, C> {
  static cudaError_t raise() { return raise_smem<TcBlock<C>>(); }
  static cudaError_t launch(const float* const src[3], float* const dst[3], const float* w1,
                            const float* b1, const float* wm, const float* bm, int B, int W,
                            int emit_lrelu, int, cudaStream_t st) {
    return launch_k<TcBlock<C>, C>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
  }
};
template <int C>
struct Kernels<bf16, C> {
  using Small = Bf16Block<C, kTileOutBf16>;
  using Large = Bf16Block<C, kTileOutBf16Large>;
  static cudaError_t raise() {
    const cudaError_t err = raise_smem<Small>();
    return err != cudaSuccess ? err : raise_smem<Large>();
  }
  // The large tile where its grid gives every SM two thread blocks, else
  // the small one: a decode at batch 1 is a wave or less of either, and its
  // time that of one thread block; at batch 32 the large tile's halved
  // weight reads win (PERF.md).
  static cudaError_t launch(const bf16* const src[3], bf16* const dst[3], const bf16* w1,
                            const float* b1, const bf16* wm, const float* bm, int B, int W,
                            int emit_lrelu, int sms, cudaStream_t st) {
    const long long blocks = (long long)B * ((W + Large::S::TW - 1) / Large::S::TW);
    if (blocks >= 2LL * sms)
      return launch_k<Large, C>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
    return launch_k<Small, C>(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, st);
  }
};

// The three ResnetBlocks of one call, src[j] -> dst[j], on the kernels for T
// and C.
template <typename T>
cudaError_t launch_blocks(const T* const src[3], T* const dst[3], const T* w1,
                          const float* b1, const T* wm, const float* bm, int B, int C,
                          int W, int emit_lrelu, int dev, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  if (!raised[dev]) {
    const cudaError_t errs[] = {
        Kernels<T, 4>::raise(), Kernels<T, 8>::raise(), Kernels<T, 16>::raise(),
        Kernels<T, 32>::raise(), Kernels<T, 64>::raise(), Kernels<T, 128>::raise(),
        Kernels<T, 256>::raise(),
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)};
    for (const cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const int n = sms[dev];
  switch (C) {
    case 4: return Kernels<T, 4>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 8: return Kernels<T, 8>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 16: return Kernels<T, 16>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 32: return Kernels<T, 32>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 64: return Kernels<T, 64>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 128: return Kernels<T, 128>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    case 256: return Kernels<T, 256>::launch(src, dst, w1, b1, wm, bm, B, W, emit_lrelu, n, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int forward(const void* x_, const void* w1_, const float* b1, const void* wm_,
            const float* bm, const void* k7_, const float* b7, void* buf0_,
            void* buf1_, void* buf2_, void* out_, int B, int C, int W, int emit_lrelu,
            void* stream) {
  if (C < 4 || C > kMaxC || 1024 % C != 0 || W < 1) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* wm = static_cast<const T*>(wm_);
  const T* k7 = static_cast<const T*>(k7_);
  T* buf0 = static_cast<T*>(buf0_);
  T* buf1 = static_cast<T*>(buf1_);
  T* buf2 = static_cast<T*>(buf2_);
  T* out = static_cast<T*>(out_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const T* const src[3] = {x, buf0, buf1};
  T* const dst[3] = {buf0, buf1, k7 ? buf2 : out};
  err = launch_blocks(src, dst, w1, b1, wm, bm, B, C, W, emit_lrelu && !k7, dev, st);
  if (err != cudaSuccess) return (int)err;
  if (k7) {
    tail_kernel<T><<<dim3((W + 255) / 256, B), 256, 0, st>>>(buf2, k7, b7, out, C, W);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

extern "C" {

// x: (B, C, W); buf0, buf1, buf2: (B, C, W) scratch; out: (B, C, W), or
// (B, W) when k7 is given. Block 1 writes buf0, block 2 buf1, block 3 out,
// or buf2 when k7 is given, which the tail reads (buf2 is unused without
// k7): every block's output survives the call. x, w1, wm, k7, the buffers
// and out are f32, or bf16 in the _bf16 entry; b1, bm and b7 are f32 in
// both. C a power of two from 4 to 256, W >= 1. Returns a cudaError_t.
int melgan_resstack_forward(const void* x, const void* w1, const float* b1,
                            const void* wm, const float* bm, const void* k7,
                            const float* b7, void* buf0, void* buf1, void* buf2,
                            void* out, int B, int C, int W, int emit_lrelu, void* stream) {
  return forward<float>(x, w1, b1, wm, bm, k7, b7, buf0, buf1, buf2, out, B, C, W,
                        emit_lrelu, stream);
}

int melgan_resstack_forward_bf16(const void* x, const void* w1, const float* b1,
                                 const void* wm, const float* bm, const void* k7,
                                 const float* b7, void* buf0, void* buf1, void* buf2,
                                 void* out, int B, int C, int W, int emit_lrelu,
                                 void* stream) {
  return forward<__nv_bfloat16>(x, w1, b1, wm, bm, k7, b7, buf0, buf1, buf2, out, B,
                                C, W, emit_lrelu, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
