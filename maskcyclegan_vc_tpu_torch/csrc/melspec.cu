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
// [256 t, 256 t + 1024). wc, ws: (kCluster, 1024, kSliceBins, 2) f32, the
// window times the cos / sin DFT bases, built on the host in float64 as the
// JAX package builds them, bin 68 r + i of sample n at [r][n][i], each value
// split on the host into its TF32 (hi, lo) pair (the constants' split of
// `split` below), bins 513..543 zero; melT: (kBinsPad, 80), rows past 512
// zero.
// out: (B, 80, T), T = (L - 1024) / 256 + 1.
//
// The DFT is a GEMM: frames (M = T) x 1024 samples (K) against the bases
// (N: cos and sin of 513 bins), 8.38 GFLOP over the 10 calls of a 2 x 5
// utterance preprocess run with the mel product. Bound on an H100 SXM:
// operations. The products are true f32, as the TPU kernel's
// Precision.HIGHEST: 3xTF32 on the tensor cores (mma.sync.m16n8k8), each
// operand v split into TF32 values hi and lo, v = hi + lo to ~2^-22, and a
// product taken as a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, the small terms
// first; the dropped lo.lo term and the rounding of lo are ~2^-22 of the
// product. A warp's share of every kFlushChunks chunks sums into a zeroed
// partial that is added to the accumulator in f32 (the tensor cores' own
// accumulation loses more than f32 adds do; melgan_stack.cu). So the bound
// is three TF32 products per f32 flop at 495 TFLOP/s dense (0.0508 ms over
// those 10 calls; 0.1251 ms at the 67 TFLOP/s of the f32 cores); the bytes
// (the audio in, the mels out, 4.5 MB of constants) take ~0.0015 ms a call
// at 3.35 TB/s.
//
// The design:
// - A cluster of kCluster thread blocks takes one (batch, tile of kFrames
//   frames); block `rank` of it takes bins [68 rank, 68 rank + 68), so the
//   grid is (T / kFrames x kCluster, B): 48-144 blocks at batch 1 and
//   192-576 frames, each reading only its own slice of the bases. Two
//   blocks fit an SM (106 KB of shared memory, 256 threads).
// - The tile's audio span, kFrames + 3 rows of 256 samples, is copied once
//   (cp.async, zeros past L) into shared memory at a row stride of
//   kSpanStride = 260 floats: frame f's sample n is span row f + n / 256,
//   column n % 256, so no framed matrix is formed, and an A fragment's 8
//   rows fall in 8 distinct groups of 4 banks (a stride of 256 would put
//   them all in one).
// - B, the block's 136 columns, is staged kChunkK rows at a time into a
//   ring of kStages buffers by the TMA: thread 0 bulk-copies the chunk's
//   rows of the block's 68 cos pairs and of its 68 sin pairs, each one
//   contiguous run (17 KB) of wc or ws, whose layout gives every block its
//   bins' rows together, completing on the buffer's mbarrier. (Per-thread
//   16-byte cp.async copies, or a bulk copy a row, left the products
//   waiting.) The bases are split into TF32 (hi, lo) pairs on the host,
//   once, so a B fragment costs two 8-byte loads and no arithmetic. An n8
//   tile j of B is the cos of bins 4j..4j+3, then their sin: column g of
//   the tile lies in the cos rows (g < 4) or in the sin rows (g >= 4), at
//   4j + g % 4, so each half warp's 8-byte loads hit 16 distinct pairs of
//   banks (4 t + g % 4 in a half). A tile's m16n8
//   accumulator gives lane (g, t) columns 2t and 2t+1, the cos of two bins
//   (t < 2) or their sin (t >= 2); lanes t and t ^ 2 trade one row's halves
//   by a shuffle, so each holds re and im of two bins of one frame, and the
//   magnitude sqrt(re^2 + im^2 + 1e-24) is formed in registers.
// - 8 warps. Warp w's units are m16n8 tiles: tiles w % 4 + 4 i (i < 4) in
//   both m16 halves, and for w % 4 < 2 also tile 16 in half w % 4 (9, 9, 8
//   and 8 units; the last two take a copy of tile 16 and drop it, so that
//   every warp runs the same code). Warps w and w + 4 take the same units
//   over the two halves of every chunk's k-steps; their sums meet in
//   shared memory at the end. Each k-step a warp splits its A fragments
//   once for all its units (the audio may hold any value: NaN stays in hi),
//   loads its B fragments, then issues its units' first products, their
//   second, their third: no mma waits on the one before it.
// - The magnitudes go to shared memory; each block projects its 68 bins
//   onto the 80 filters in f32 (a thread: 2 frames x 5 mels; its filter
//   rows copied into the ring while the magnitudes form) into a partial
//   (80, kFrames) in shared memory. The mel projection is linear, so the
//   cluster's partials sum to the mels: block `rank` sums the 8 partials of
//   its 320 outputs from distributed shared memory in rank order (the same
//   sum every run), clamps at 1e-5 (NaN stays NaN), takes log10 and writes
//   (B, 80, T). Frames past T are computed and not written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNFft = 1024;
constexpr int kHop = 256;
constexpr int kMels = 80;
constexpr int kCluster = 8;                      // blocks of a frame tile
constexpr int kSliceBins = 68;                   // bins of a block
constexpr int kBinsPad = kCluster * kSliceBins;  // 544 >= 513
constexpr int kTiles = kSliceBins / 4;           // 17 n8 tiles: 4 cos, 4 sin columns each
constexpr int kFrames = 32;                      // frames of a tile: two m16 halves
constexpr int kSpanRows = kFrames + kNFft / kHop - 1;  // 35
constexpr int kSpanStride = kHop + 4;            // 260: 4 banks apart row to row
constexpr int kWarpsN = 4;                       // warps across a block's n8 tiles,
constexpr int kGroupsK = 2;                      // each once per half of a chunk's k-steps
constexpr int kThreads = 32 * kWarpsN * kGroupsK;
constexpr int kUnits = 9;                        // m16n8 tiles a warp, at most
constexpr int kChunkK = 32;                      // B rows a chunk stages
constexpr int kChunks = kNFft / kChunkK;
constexpr int kChunksPerHop = kHop / kChunkK;
constexpr int kStepsPerGroup = kChunkK / 8 / kGroupsK;  // k-steps of a chunk a warp takes
constexpr int kFlushChunks = 2;                  // chunks a partial sums
constexpr int kStages = 2;                       // chunks in flight
constexpr int kRunFloats = 2 * kChunkK * kSliceBins;  // a chunk's (hi, lo) rows of one array
constexpr int kSinOffset = kRunFloats + 16;      // the sin rows, past the cos rows
constexpr int kChunkFloats = kSinOffset + kRunFloats;
constexpr int kMagStride = kSliceBins;           // 68: rows 4 banks apart
constexpr int kPartStride = kFrames + 1;         // a partial's rows, one bank apart
constexpr int kPerRank = kMels * kFrames / kCluster;  // outputs a block writes
constexpr int kSpanFloats = kSpanRows * kSpanStride;
constexpr int kRingFloats = kStages * kChunkFloats;
constexpr int kXchFloats = kGroupsK / 2 * kUnits * 4 * (kThreads / kGroupsK);
constexpr int kSmemBytes = 4 * (kSpanFloats + kRingFloats);
constexpr float kFloor = 1e-5f;
static_assert(kTiles == 4 * kWarpsN + 1 && kUnits == 2 * 4 + 1,
              "units: four tiles a warp in both halves, tile 16 in one");
static_assert(kChunks % kFlushChunks == 0 && kStepsPerGroup >= 1, "k-steps");
static_assert(kFrames * kMagStride + kMels * kPartStride <= kSpanFloats,
              "the magnitudes and the partial reuse the span");
static_assert(kXchFloats + kSliceBins * kMels <= kRingFloats,
              "the groups' sums and the filter rows reuse the ring");
static_assert(kSmemBytes <= 113 * 1024, "two blocks an SM");
static_assert(kRunFloats % 4 == 0 && kSinOffset % 4 == 0 && kChunkFloats % 4 == 0,
              "16-byte bulk copies");

// v rounded to TF32 (round to nearest, ties away), as the b32 an mma takes
// (melgan_stack.cu's, where PERF.md times it against cvt.rna.tf32.f32).
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
// Not volatile: a pure function of its operands, which the compiler may
// schedule among the loads and the other units' products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Product q of a . b's three into d, the small terms first: a_hi.b_lo,
// a_lo.b_hi, a_hi.b_hi (q is a constant once the caller's loop unrolls).
__device__ __forceinline__ void mma_3xtf32(int q, float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (q == 0) mma_tf32(d, ah, bl);
  else if (q == 1) mma_tf32(d, al, bh);
  else mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// 16 (4) bytes at src to dst, of which the first n are read and the rest
// zero-filled (n = 0: src is not read).
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4_fill(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes at src to dst by the TMA's bulk copy (16-byte aligned, a multiple
// of 16), completing on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Returns once the mbarrier bar has completed the phase of the given parity.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// The B fragment of n8 tile j at k-step kk of a staged chunk, as its TF32
// (hi, lo) pairs. A staged chunk holds the block's cos rows (kChunkK x 68
// pairs), then its sin rows kSinOffset floats on: column g of tile j is cos
// (g < 4) or sin (g >= 4) of bin 4 j + g % 4.
__device__ __forceinline__ void b_fragment(const float* bs, int kk, int j, int g, int t,
                                           uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const uint2* p = reinterpret_cast<const uint2*>(bs + kSinOffset * (g >> 2)) +
                   (kk + t) * kSliceBins + 4 * j + (g & 3);
  const uint2 v0 = p[0], v1 = p[4 * kSliceBins];
  bh[0] = v0.x, bl[0] = v0.y, bh[1] = v1.x, bl[1] = v1.y;
}

// One unit's accumulator d (an m16n8 tile: rows 16 mt + g and + 8, columns
// 2t, 2t + 1 of tile j) to two magnitudes: lanes t and t ^ 2 trade a row.
// Lane t < 2 keeps row g, bins 4j + 2t, +1; lane t >= 2 row g + 8, bins
// 4j + 2(t - 2), +1.
__device__ __forceinline__ void magnitudes(const float (&d)[4], int mt, int j, int g, int t,
                                           float* mag) {
  const bool cos_lane = t < 2;
  const float r0 = __shfl_xor_sync(0xffffffffu, cos_lane ? d[2] : d[0], 2);
  const float r1 = __shfl_xor_sync(0xffffffffu, cos_lane ? d[3] : d[1], 2);
  const float re0 = cos_lane ? d[0] : r0, re1 = cos_lane ? d[1] : r1;
  const float im0 = cos_lane ? r0 : d[2], im1 = cos_lane ? r1 : d[3];
  const int f = 16 * mt + g + (cos_lane ? 0 : 8);
  float* m = mag + f * kMagStride + 4 * j + 2 * (t & 1);
  m[0] = sqrtf(re0 * re0 + im0 * im0 + 1e-24f);
  m[1] = sqrtf(re1 * re1 + im1 * im1 + 1e-24f);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
    log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ wc,
                   const float* __restrict__ ws, const float* __restrict__ melT,
                   float* __restrict__ out, int L, int T) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kStages];  // a chunk's bytes have landed
  float* span = smem;                // (kSpanRows, kSpanStride) audio of the tile
  float* ring = smem + kSpanFloats;  // kStages chunks of B
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / kCluster) * kFrames;
  const int tid = threadIdx.x;

  // The span, by cp.async (one group): samples past L are zeros. 16-byte
  // pieces where the tile's audio starts on a 16-byte boundary (every tile
  // of sample 0; L a multiple of 4), else 4-byte ones.
  const float* a = audio + (size_t)b * L + (size_t)t0 * kHop;
  const int avail = L - t0 * kHop;  // samples of the span that exist
  if (reinterpret_cast<uintptr_t>(a) % 16 == 0) {
    for (int i = 4 * tid; i < kSpanRows * kHop; i += 4 * kThreads) {
      const int n = 4 * min(max(avail - i, 0), 4);
      cp_async16_fill(span + (i / kHop) * kSpanStride + i % kHop, n ? a + i : a, n);
    }
  } else {
    for (int i = tid; i < kSpanRows * kHop; i += kThreads)
      cp_async4_fill(span + (i / kHop) * kSpanStride + i % kHop, i < avail ? a + i : a,
                     i < avail ? 4 : 0);
  }
  cp_async_commit();

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Chunk c of the block's B into buffer c % kStages by thread 0: two bulk
  // copies of the TMA, the chunk's cos rows and its sin rows, each one run
  // of the block's slice of wc or ws, completing on the buffer's mbarrier.
  auto load_chunk = [&](int c) {
    if (tid == 0 && c < kChunks) {
      uint64_t* bar = &full[c % kStages];
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bar)),
                   "r"(8 * kRunFloats)
                   : "memory");
      float* dst = ring + (c % kStages) * kChunkFloats;
      const size_t src = ((size_t)rank * kNFft + (size_t)c * kChunkK) * kSliceBins * 2;
      bulk_copy(dst, wc + src, 4 * kRunFloats, bar);
      bulk_copy(dst + kSinOffset, ws + src, 4 * kRunFloats, bar);
    }
  };
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // Warps w and w + 4 take the same units, each half of every chunk's
  // k-steps: two warps an SM sub-partition even at one block an SM.
  const int nw = warp % kWarpsN, kg = warp / kWarpsN;
  const bool extra = nw < 2;  // tile kTiles - 1 in m16 half `nw`
  float acc[kUnits][4], part[kUnits][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[u][r] = part[u][r] = 0.f;

  cp_async_wait<0>();
  for (int c = 0; c < kChunks; ++c) {
    __syncthreads();  // chunk c - 1 done (and at c = 0 the span in)
    load_chunk(c + kStages - 1);
    wait_phase(&full[c % kStages], (c / kStages) & 1);
    const float* bs = ring + (c % kStages) * kChunkFloats;
    // Sample n of frame f is span row f + n / 256: the chunk's samples lie
    // in one hop row, n0 .. n0 + kChunkK - 1 of it.
    const int hop = c / kChunksPerHop, n0 = (c % kChunksPerHop) * kChunkK;
    const float* as = span + (g + hop) * kSpanStride + n0 + t;
#pragma unroll
    for (int s = 0; s < kStepsPerGroup; ++s) {
      const int kk = 8 * (kg * kStepsPerGroup + s);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = as + 16 * mt * kSpanStride + kk;
        split(p[0], ah[mt][0], al[mt][0]);
        split(p[8 * kSpanStride], ah[mt][1], al[mt][1]);
        split(p[4], ah[mt][2], al[mt][2]);
        split(p[8 * kSpanStride + 4], ah[mt][3], al[mt][3]);
      }
      // The B fragments of the warp's tiles (tile kTiles - 1 last), then
      // the three products as three passes over the units, so that no mma
      // waits on the one before it. Warps with nw >= 2 also take tile
      // kTiles - 1, in half nw & 1, as the others do, and drop it: their
      // sub-partitions hold 8-unit warps beside nothing busier.
      uint32_t bh[5][2], bl[5][2], xh[4], xl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b_fragment(bs, kk, nw + kWarpsN * i, g, t, bh[i], bl[i]);
      b_fragment(bs, kk, kTiles - 1, g, t, bh[4], bl[4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xh[r] = nw & 1 ? ah[1][r] : ah[0][r];
        xl[r] = nw & 1 ? al[1][r] : al[0][r];
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3xtf32(q, part[2 * i + mt], ah[mt], al[mt], bh[i], bl[i]);
        mma_3xtf32(q, part[kUnits - 1], xh, xl, bh[4], bl[4]);
      }
    }
    if (c % kFlushChunks == kFlushChunks - 1) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][r] += part[u][r], part[u][r] = 0.f;
    }
  }
  __syncthreads();  // the ring is free: the groups' sums, the filters

  // This block's filter rows (kSliceBins x kMels, contiguous in melT) into
  // the ring, while the groups' sums meet and the magnitudes form.
  float* xch = ring;  // kGroupsK / 2 x (kUnits * 4, kThreads / kGroupsK)
  float* fb = ring + kXchFloats;
  {
    const float* src = melT + (size_t)rank * kSliceBins * kMels;
    for (int i = 4 * tid; i < kSliceBins * kMels; i += 4 * kThreads) cp_async16(fb + i, src + i);
    cp_async_commit();
  }
  // The groups' sums in a fixed tree: group kg + w into group kg, w halving.
  constexpr int kGroupThreads = kThreads / kGroupsK;
  const int lane_g = tid % kGroupThreads;
#pragma unroll
  for (int w = kGroupsK / 2; w > 0; w /= 2) {
    if (kg >= w && kg < 2 * w) {
      float* x = xch + (kg - w) * kUnits * 4 * kGroupThreads;
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) x[(4 * u + r) * kGroupThreads + lane_g] = acc[u][r];
    }
    __syncthreads();
    if (kg < w) {
      const float* x = xch + kg * kUnits * 4 * kGroupThreads;
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][r] += x[(4 * u + r) * kGroupThreads + lane_g];
    }
    __syncthreads();
  }

  float* mag = smem;                               // (kFrames, kMagStride)
  float* partial = smem + kFrames * kMagStride;    // (kMels, kPartStride)
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) magnitudes(acc[2 * i + mt], mt, nw + kWarpsN * i, g, t, mag);
    if (extra) magnitudes(acc[kUnits - 1], nw, kTiles - 1, g, t, mag);
  }
  cp_async_wait<0>();
  __syncthreads();

  // This block's bins onto the filters: thread (fg, mg) takes frames
  // 2 fg, 2 fg + 1 and mels 5 mg .. 5 mg + 4.
  {
    const int mg = tid & 15, fg = tid >> 4;
    float s[2][5];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 5; ++e) s[i][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kSliceBins; ++k) {
      float w[5], m[2];
#pragma unroll
      for (int e = 0; e < 5; ++e) w[e] = fb[k * kMels + 5 * mg + e];
#pragma unroll
      for (int i = 0; i < 2; ++i) m[i] = mag[(2 * fg + i) * kMagStride + k];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 5; ++e) s[i][e] = fmaf(m[i], w[e], s[i][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 5; ++e) partial[(5 * mg + e) * kPartStride + 2 * fg + i] = s[i][e];
  }
  cluster.sync();  // every block's partial is written

  const float* parts[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) parts[q] = cluster.map_shared_rank(partial, q);
  for (int idx = rank * kPerRank + tid; idx < (rank + 1) * kPerRank; idx += kThreads) {
    const int m = idx / kFrames, f = idx % kFrames;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) v += parts[q][m * kPartStride + f];
    if (t0 + f < T)
      out[((size_t)b * kMels + m) * T + t0 + f] = log10f(isnan(v) ? v : fmaxf(v, kFloor));
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace

extern "C" {

// audio: (B, L) padded f32; wc, ws: (8, 1024, 68, 2); melT: (544, 80); out:
// (B, 80, T). One launch. Returns a cudaError_t.
int log_mel_forward(const float* audio, const float* wc, const float* ws,
                    const float* melT, float* out, int B, int L, int T,
                    void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kFrames - 1) / kFrames * kCluster, B);
  log_mel_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      audio, wc, ws, melT, out, L, T);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
