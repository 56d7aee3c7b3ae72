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
// (ops/layers.py:204-215 and :270-278).
//
// The backward entries (in_backward, in_swish_backward, in_glu_backward)
// replace no Pallas kernel: they replace the jax.custom_vjp backwards of
// the three entries (in_gate_kernel.py:161-258), which XLA fuses on the
// TPU and which PyTorch ran as chains of eager ops, each recomputing the
// statistics and making about ten f32 temporaries the size of x. Those
// chains moved about 83 % of the bytes of a training step's eager ops. The
// plain formulas stay in ops/in_gate.py, as the CPU path and the oracle.
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
// element once and write each output element once; the arithmetic is about
// ten flops per element (swish and the sigmoid add one exp), under the f32
// rate, but not by much in bf16, where instruction issue rather than bytes
// set the pace of a kernel that spends a division or an IEEE exp per
// element. Every row goes to one thread group, so the statistics need no
// second launch and no atomics.
//
// All three entries run in_staged_kernel, which K2 (in_forward) instantiates
// with no epilogue, K3 (in_swish_forward) with swish and K1
// (in_glu_forward) with the gate.
// - Stage once. A block's rows are bulk-copied into shared memory by one
//   thread (cp.async.bulk, the TMA's 1-D form, completing on an mbarrier):
//   consecutive channels of a sample are contiguous, so a block's rows are
//   one copy, two for K1 (the h rows, and the g rows C*S elements further
//   on). DRAM is read exactly once. A run whose start or end is off a
//   16-byte boundary (bf16 with S odd, or a tensor that starts off one) is
//   bulk-copied from its first to its last boundary, and the block's
//   threads copy the head and tail, under 16 bytes each.
// - Rows to threads. A row of at most kGroupMaxUnits units goes to a group
//   of 4-32 consecutive lanes (the least power of two that leaves a thread
//   at most kGroupUnits units, more where the launch is too small to fill
//   the card), reduced by shuffles within the group; a block holds up to
//   kGroupBlockThreads threads of such groups, fewer where that would leave
//   SMs without a block. A longer row takes a whole block, whose threads
//   follow from how many blocks fit an SM by shared memory and how many
//   rows there are per SM, so that kThreadsPerSM threads stay resident
//   where the rows allow. A block's rows belong to one sample.
// - Units. A thread takes V = 4 (f32) or 8 (bf16) consecutive columns of
//   one line of its row, 16 bytes, and walks its units with no division
//   per unit; a unit with a column at w >= L tests each element. Where W is
//   a multiple of V and x and y are 16-byte aligned every access is 16
//   bytes; else a unit takes scalar accesses and a line's last unit is
//   ragged.
// - Statistics from shared memory: the sums, then the centred squares;
//   K1 reduces h and g together, so a row takes two reductions, each one
//   barrier for a whole-block row and none for a group.
// - Epilogue: K2 writes the normalised value as it is; K3 and K1 use the
//   SFU's exp and reciprocal (__expf, __fdividef). One cvt for a bf16 pair.
// - A row past a block's shared memory takes the streaming route: a whole
//   block, the same units read from device memory in three passes. That is
//   an f32 K1 row of more than 28,928 elements (its h and g rows together;
//   a conversion bucket past about 1446 frames), or an f32 K2 or K3 row of
//   more than 57,856. The entry reports the route it launched.
//
// The backwards run in_backward_kernel, one template with the same three
// epilogues, on the same plan. Given x (the forward's input, saved) and dy
// (the gradient of y), a row's gradient is
//   dx = scale * inv * (dz - mean(dz) - xhat * mean(dz * xhat)),
// with dz the gradient at the normalised value: dy for K2, dy * swish'(z)
// for K3, and for K1, with s = sigmoid(IN(g)), dy * s at h and
// dy * IN(h) * s * (1 - s) at g. Its bound is bytes too: x and dy read once
// and dx written once, 12 bytes an element in f32 and 6 in bf16 (K1: 10 and
// 5 an element of x, its dy half x's size), plus the vectors and a (B, C)
// pair of partials an array.
// - The block stages its x rows (K1: h and g) and its dy rows in one bulk
//   copy each, as the forward stages x; a row of x and dy past a block's
//   shared memory streams from device memory. DRAM is read once.
// - From shared memory, in f32: the mean, the centred variance (as the
//   forward), then dz on the fly and the row's sum(dz) and
//   sum(dz * (x - mean)) in one reduction (K1: h's and g's together), then
//   dz again and dx, rounded once to x's dtype and written once. K1 writes
//   dh and dg into one (B, 2C, S) tensor, as hg came in.
// - dscale and dbias leave as per-row partials, sum(dz * xhat) and sum(dz),
//   in a (2A, B, C) f32 array that the caller sums over B in a fixed order:
//   no atomics, so a CUDA graph's replays give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kVecBytes = 16;           // one vector access
constexpr int kMaxThreads = 512;        // a block's threads, at most
constexpr int kThreadsPerSM = 2048;
constexpr int kMaxBlocksPerSM = 32;
constexpr int kSmemPerSM = 233472;      // 228 KB an SM on an H100
constexpr int kBlockReserve = 1024;     // shared memory the card keeps per block
constexpr int kStaticSmem = 1024;       // kept back for a block's static shared memory
constexpr uint32_t kBulkChunk = 65536;  // bytes per cp.async.bulk
constexpr int kMinGroup = 4;            // threads of a row's group, at least
constexpr int kGroupUnits = 4;          // units a group's thread takes, at most
constexpr int kGroupMaxUnits = 128;     // longer rows take a whole block
constexpr int kGroupBlockThreads = 256; // threads of a block of groups, at most
enum Route { kBulk = 0, kStream = 1 };
// What follows the normalisation: nothing (K2), swish (K3) or the GLU gate
// (K1).
enum Epilogue { kNone = 0, kSwish = 1, kGlu = 2 };

template <typename T>
struct Elem;

// Four f32 in 16 bytes.
template <>
struct Elem<float> {
  static constexpr int V = kVecBytes / 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float get(const float* p, int k) { return p[k]; }
  static __device__ __forceinline__ void put(float* p, int k, float v) { p[k] = v; }
};

// Eight bf16 in 16 bytes; a bf16's bits are the top half of its f32's.
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int V = kVecBytes / 2;
  static __device__ __forceinline__ void unpack2(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // one cvt.rn.bf16x2.f32
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    unpack2(r.x, v);
    unpack2(r.y, v + 2);
    unpack2(r.z, v + 4);
    unpack2(r.w, v + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p, int k) {
    return __bfloat162float(p[k]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, int k, float v) {
    p[k] = __float2bfloat16_rn(v);
  }
};

// m consecutive elements at p into v[0..m) as f32, v[m..V) = 0. kVec: m is V
// and p is 16-byte aligned, and one 16-byte load reads them.
template <bool kVec, typename T>
__device__ __forceinline__ void load_unit(const T* p, int m, float (&v)[Elem<T>::V]) {
  constexpr int V = Elem<T>::V;
  if constexpr (kVec) {
    Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = k < m ? Elem<T>::get(p, k) : 0.f;
  }
}

// v[0..m) to the m consecutive elements at p, each rounded once to T.
template <bool kVec, typename T>
__device__ __forceinline__ void store_unit(T* p, int m, const float (&v)[Elem<T>::V]) {
  constexpr int V = Elem<T>::V;
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = Elem<T>::pack(v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < m) Elem<T>::put(p, k, v[k]);
  }
}

// A thread's walk over its units u = t, t + gt, t + 2 gt, ... of a row
// whose lines of width W hold nW = ceil(W / V) units each: unit u is line
// h = u / nW, columns w0 .. w0 + n - 1 with w0 = (u - h * nW) * V, at row
// offset h * W + w0. The divisions by nW are made once, where the walk
// starts; a step adds gt's quotient and remainder.
struct Walk {
  int h, wu, dh, dw;
  __device__ __forceinline__ Walk(int t, int gt, int nW) {
    h = t / nW, wu = t - h * nW;
    dh = gt / nW, dw = gt - dh * nW;
  }
  __device__ __forceinline__ void next(int nW) {
    h += dh, wu += dw;
    if (wu >= nW) wu -= nW, ++h;
  }
};

// Sums each v[i] over the thread's group of gt threads: gt <= 32 a power of
// two, consecutive lanes of one warp, or gt = blockDim.x, the whole block.
// Every thread of the group receives the totals. red holds kN x 32 floats
// that no other reduction of the kernel uses, so a whole block's sum costs
// one barrier and a group's none. Every thread of the block must call it.
template <int kN>
__device__ __forceinline__ void group_sum(float (&v)[kN], int gt, float* red) {
  const int width = min(gt, 32);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    for (int o = width >> 1; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (gt <= 32) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (lane == 0) red[i * 32 + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = warp_sum(lane < warps ? red[i * 32 + lane] : 0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The bytes an array of `bytes` bytes at p takes in shared memory when it is
// staged at an address congruent to p modulo 16: from p's 16-byte boundary
// to the one after its end.
__host__ __device__ __forceinline__ size_t staged_bytes(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % kVecBytes + bytes + kVecBytes - 1) / kVecBytes *
         kVecBytes;
}

// Copies kCount global arrays of n elements each into shared memory from
// smem on, array a at dst[a], an address congruent to src[a]'s modulo 16
// bytes, and returns when the whole block can read them. One thread issues
// cp.async.bulk copies of each array's 16-byte-aligned body, completing on
// the mbarrier bar; the block's threads copy the head before the first
// boundary and the tail after the last, under 16 bytes each, where an
// array starts or ends off one.
template <int kCount, typename T>
__device__ void stage(unsigned char* smem, const T* (&src)[kCount], int n,
                      const T* (&dst)[kCount], uint64_t* bar) {
  const uint32_t bytes = (uint32_t)n * sizeof(T);
  int head[kCount], tail[kCount];  // elements: [0, head) and [tail, n) by threads
  uint32_t body[kCount], total = 0;
  T* to[kCount];
#pragma unroll
  for (int a = 0; a < kCount; ++a) {
    const uint32_t lead = reinterpret_cast<uintptr_t>(src[a]) % kVecBytes;
    to[a] = reinterpret_cast<T*>(smem + lead);
    const uint32_t h = min(bytes, (kVecBytes - lead) % kVecBytes);
    body[a] = (bytes - h) / kVecBytes * kVecBytes;
    head[a] = h / sizeof(T);
    tail[a] = (h + body[a]) / sizeof(T);
    total += body[a];
    smem += staged_bytes(src[a], bytes);
  }
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(total)
                 : "memory");
#pragma unroll
    for (int a = 0; a < kCount; ++a)
      for (uint32_t off = 0; off < body[a]; off += kBulkChunk)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(to[a] + head[a]) + off),
            "l"(reinterpret_cast<const char*>(src[a] + head[a]) + off),
            "r"(min(kBulkChunk, body[a] - off)), "r"(b)
            : "memory");
  }
#pragma unroll
  for (int a = 0; a < kCount; ++a) {
    const int edge = head[a] + (n - tail[a]);
    for (int k = threadIdx.x; k < edge; k += blockDim.x) {
      const int e = k < head[a] ? k : tail[a] + k - head[a];
      to[a][e] = src[a][e];
    }
    dst[a] = to[a];
  }
  __syncthreads();
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
}

// swish(z) = z * sigmoid(z) and sigmoid(v), with the SFU's exp and
// reciprocal (a few ulp in f32, far inside the 1e-5 the kernels are held
// to; a NaN stays NaN, and z / inf is -0 for large negative z).
__device__ __forceinline__ float swish(float z) { return __fdividef(z, 1.f + __expf(-z)); }
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

// Adds to s[a], over this thread's units of its row (the walk from start,
// units t, t + gt, ...), array a's valid elements (w < L) less c[a], or
// with kSquare their squares. A unit whose columns are all valid skips the
// test. row: the arrays in shared memory, or in device memory on the
// streaming route.
template <bool kVec, bool kSquare, int A, typename T>
__device__ __forceinline__ void unit_sums(const T* const (&row)[A], Walk w, int t, int gt,
                                          int nU, int nW, int W, int L, const float (&c)[A],
                                          float (&s)[A]) {
  constexpr int V = Elem<T>::V;
  for (int u = t; u < nU; u += gt, w.next(nW)) {
    const int w0 = w.wu * V, n = min(V, W - w0), off = w.h * W + w0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float v[V];
      load_unit<kVec>(row[a] + off, n, v);
      if (w0 + V <= L) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = v[k] - c[a];
          s[a] += kSquare ? d * d : d;
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = v[k] - c[a];
          if (w0 + k < L) s[a] += kSquare ? d * d : d;  // past a ragged unit's end: w >= W
        }
      }
    }
  }
}

// One block: rows c0 .. c0 + R - 1 (those below C) of sample b, R =
// blockDim.x / gt, row j to threads j*gt .. j*gt + gt - 1.
template <typename T, int kEpilogue, bool kStream, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    in_staged_kernel(const T* __restrict__ x, const float* __restrict__ scale_h,
                  const float* __restrict__ bias_h, const float* __restrict__ scale_g,
                  const float* __restrict__ bias_g, const int* __restrict__ lengths,
                  T* __restrict__ y, int C, int H, int W, int gt) {
  constexpr bool kGated = kEpilogue == kGlu;
  constexpr int A = kGated ? 2 : 1;  // arrays: h, and g for the GLU
  constexpr int V = Elem<T>::V;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2 * A * 32];
  const int S = H * W;
  const int R = blockDim.x / gt;
  const int groups = (C + R - 1) / R;  // blocks a sample
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * R;
  const int rows = min(R, C - c0);
  const int j = threadIdx.x / gt, t = threadIdx.x - j * gt;
  const bool live = j < rows;  // an idle group still joins the reductions
  const int c = c0 + j;

  const T* src[A];
  src[0] = x + ((size_t)b * A * C + c0) * S;
  if constexpr (kGated) src[1] = src[0] + (size_t)C * S;
  const T* row[A];
  if constexpr (kStream) {
#pragma unroll
    for (int a = 0; a < A; ++a) row[a] = src[a];
  } else {
    stage<A>(dyn, src, rows * S, row, &bar);
  }
#pragma unroll
  for (int a = 0; a < A; ++a) row[a] += (size_t)j * S;

  const int L = lengths ? min(max(lengths[b], 0), W) : W;
  const int nW = (W + V - 1) / V, nU = H * nW;
  const float inv_n = 1.f / (float)max(H * L, 1);
  const Walk start(t, gt, nW);

  float zero[A], m[A], q[A];
#pragma unroll
  for (int a = 0; a < A; ++a) zero[a] = m[a] = q[a] = 0.f;
  if (live) unit_sums<kVec, false>(row, start, t, gt, nU, nW, W, L, zero, m);
  group_sum(m, gt, red);
#pragma unroll
  for (int a = 0; a < A; ++a) m[a] *= inv_n;
  if (live) unit_sums<kVec, true>(row, start, t, gt, nU, nW, W, L, m, q);
  group_sum(q, gt, red + A * 32);
  if (!live) return;

  const float ah = rsqrtf(q[0] * inv_n + kEps) * scale_h[c];
  const float bh = bias_h[c] - m[0] * ah;
  float ag = 0.f, bg = 0.f;
  if constexpr (kGated) {
    ag = rsqrtf(q[1] * inv_n + kEps) * scale_g[c];
    bg = bias_g[c] - m[1] * ag;
  }
  T* yr = y + ((size_t)b * C + c) * S;
  Walk w = start;
  for (int u = t; u < nU; u += gt, w.next(nW)) {
    const int w0 = w.wu * V, n = min(V, W - w0), off = w.h * W + w0;
    float h[V], g[V], out[V];
    load_unit<kVec>(row[0] + off, n, h);
    if constexpr (kGated) load_unit<kVec>(row[A - 1] + off, n, g);
    const bool full = w0 + V <= L;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = h[k] * ah + bh;
      if constexpr (kGated) z *= sigmoid(g[k] * ag + bg);
      else if constexpr (kEpilogue == kSwish) z = swish(z);
      out[k] = full || w0 + k < L ? z : 0.f;
    }
    store_unit<kVec>(yr + off, n, out);
  }
}

// The gradient at the normalised value(s) of one element whose dy is d,
// from its centred values ch = xh - mean (and cg, K1's g): K2 d; K3
// d * swish'(z), z = ch * ah + bh; K1, with the gate s = sigmoid(cg * ag +
// bg), d * s at h and d * (ch * ah + bh) * s * (1 - s) at g (dzg). ah =
// inv * scale and bh the bias: z from the centred value, as the plain
// formulas' xhat * scale + bias, keeps a row of small variance (inv up to
// 1 / sqrt(eps)) clear of the cancellation in x * ah + (bias - mean * ah).
// Each operation is rounded as written (the _rn intrinsics, which the
// compiler does not fuse with what consumes them), so the sums' pass and
// dx's pass see the same dz to the bit: a one-element row's dx is then
// exactly 0, as the plain formulas give it, and not rounding noise times
// inv.
template <int kEpilogue>
__device__ __forceinline__ float grad_z(float ch, float cg, float d, float ah, float bh,
                                        float ag, float bg, float& dzg) {
  if constexpr (kEpilogue == kNone) {
    return d;
  } else if constexpr (kEpilogue == kSwish) {
    const float z = __fmaf_rn(ch, ah, bh), s = sigmoid(z);
    return __fmul_rn(d, __fmaf_rn(__fmul_rn(z, s), __fsub_rn(1.f, s), s));
  } else {
    const float s = sigmoid(__fmaf_rn(cg, ag, bg)), yh = __fmaf_rn(ch, ah, bh);
    dzg = __fmul_rn(__fmul_rn(__fmul_rn(d, yh), s), __fsub_rn(1.f, s));
    return __fmul_rn(d, s);
  }
}

// The backward of one block: rows c0 .. c0 + R - 1 (those below C) of
// sample b, as in in_staged_kernel. x and dx are (B, A*C, S), dy is
// (B, C, S); part is (2A, B, C) f32: array a's sum(dz * xhat) at part[2a]
// and its sum(dz) at part[2a + 1]. K2 reads no bias.
template <typename T, int kEpilogue, bool kStream, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    in_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale_h, const float* __restrict__ bias_h,
                       const float* __restrict__ scale_g, const float* __restrict__ bias_g,
                       T* __restrict__ dx, float* __restrict__ part, int B, int C, int H,
                       int W, int gt) {
  constexpr bool kGated = kEpilogue == kGlu;
  constexpr int A = kGated ? 2 : 1;  // arrays of x: h, and g for the GLU
  constexpr int V = Elem<T>::V;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bar;
  // The sums of dz take red[0, 2A) x 32, over the means' red[0, A) x 32:
  // every thread has read the means before any passes the variance's
  // barrier. The variance takes red[2A, 3A) x 32.
  __shared__ float red[3 * A * 32];
  const int S = H * W;
  const int R = blockDim.x / gt;
  const int groups = (C + R - 1) / R;  // blocks a sample
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * R;
  const int rows = min(R, C - c0);
  const int j = threadIdx.x / gt, t = threadIdx.x - j * gt;
  const bool live = j < rows;  // an idle group still joins the reductions
  const int c = c0 + j;

  const T* src[A + 1];  // x's runs (h, g), then dy's
  src[0] = x + ((size_t)b * A * C + c0) * S;
  if constexpr (kGated) src[1] = src[0] + (size_t)C * S;
  src[A] = dy + ((size_t)b * C + c0) * S;
  const T* run[A + 1];
  if constexpr (kStream) {
#pragma unroll
    for (int a = 0; a <= A; ++a) run[a] = src[a];
  } else {
    stage<A + 1>(dyn, src, rows * S, run, &bar);
  }
  const T* row[A];
#pragma unroll
  for (int a = 0; a < A; ++a) row[a] = run[a] + (size_t)j * S;
  const T* dyr = run[A] + (size_t)j * S;

  const int nW = (W + V - 1) / V, nU = H * nW;
  const float inv_n = 1.f / (float)S;
  const Walk start(t, gt, nW);

  float zero[A], m[A], q[A];
#pragma unroll
  for (int a = 0; a < A; ++a) zero[a] = m[a] = q[a] = 0.f;
  if (live) unit_sums<kVec, false>(row, start, t, gt, nU, nW, W, W, zero, m);
  group_sum(m, gt, red);
#pragma unroll
  for (int a = 0; a < A; ++a) m[a] *= inv_n;
  if (live) unit_sums<kVec, true>(row, start, t, gt, nU, nW, W, W, m, q);
  group_sum(q, gt, red + 2 * A * 32);

  float inv[A];
#pragma unroll
  for (int a = 0; a < A; ++a) inv[a] = rsqrtf(q[a] * inv_n + kEps);
  float ah = 0.f, bh = 0.f, ag = 0.f, bg = 0.f;
  if (live) {
    ah = inv[0] * scale_h[c];
    if constexpr (kEpilogue != kNone) bh = bias_h[c];
    if constexpr (kGated) {
      ag = inv[1] * scale_g[c];
      bg = bias_g[c];
    }
  }

  // Each array's sum(dz * (x - mean)), then its sum(dz).
  float sums[2 * A];
#pragma unroll
  for (int i = 0; i < 2 * A; ++i) sums[i] = 0.f;
  if (live) {
    Walk w = start;
    for (int u = t; u < nU; u += gt, w.next(nW)) {
      const int w0 = w.wu * V, n = min(V, W - w0), off = w.h * W + w0;
      float h[V], g[V], d[V];
      load_unit<kVec>(row[0] + off, n, h);
      if constexpr (kGated) load_unit<kVec>(row[A - 1] + off, n, g);
      load_unit<kVec>(dyr + off, n, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (!kVec && k >= n) break;  // past a ragged unit's end: w >= W
        const float ch = h[k] - m[0], cg = kGated ? g[k] - m[A - 1] : 0.f;
        float dzg = 0.f;
        const float dzh = grad_z<kEpilogue>(ch, cg, d[k], ah, bh, ag, bg, dzg);
        sums[0] += dzh * ch;
        sums[1] += dzh;
        if constexpr (kGated) {
          sums[2] += dzg * cg;
          sums[3] += dzg;
        }
      }
    }
  }
  group_sum(sums, gt, red);
  if (!live) return;

  // sum(dz * xhat) = inv * sum(dz * (x - mean)): the row's dscale; sum(dz)
  // its dbias. dx = a * (dz - mean(dz) - (x - mean) * kx) with a = scale *
  // inv and kx = inv * mean(dz * xhat).
  const size_t bc = (size_t)B * C, at = (size_t)b * C + c;
  float mdz[A], kx[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float dsc = inv[a] * sums[2 * a];
    if (t == 0) {
      part[2 * a * bc + at] = dsc;
      part[(2 * a + 1) * bc + at] = sums[2 * a + 1];
    }
    mdz[a] = sums[2 * a + 1] * inv_n;
    kx[a] = inv[a] * dsc * inv_n;
  }
  T* dxr = dx + ((size_t)b * A * C + c) * S;
  Walk w = start;
  for (int u = t; u < nU; u += gt, w.next(nW)) {
    const int w0 = w.wu * V, n = min(V, W - w0), off = w.h * W + w0;
    float h[V], g[V], d[V], oh[V], og[V];
    load_unit<kVec>(row[0] + off, n, h);
    if constexpr (kGated) load_unit<kVec>(row[A - 1] + off, n, g);
    load_unit<kVec>(dyr + off, n, d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float ch = h[k] - m[0], cg = kGated ? g[k] - m[A - 1] : 0.f;
      float dzg = 0.f;
      const float dzh = grad_z<kEpilogue>(ch, cg, d[k], ah, bh, ag, bg, dzg);
      oh[k] = ah * (dzh - mdz[0] - ch * kx[0]);
      if constexpr (kGated) og[k] = ag * (dzg - mdz[A - 1] - cg * kx[A - 1]);
    }
    store_unit<kVec>(dxr + off, n, oh);
    if constexpr (kGated) store_unit<kVec>(dxr + (size_t)C * S + off, n, og);
  }
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The most shared memory one block's rows may take.
int smem_limit() {
  static const int limit =
      device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin) - kStaticSmem;
  return limit;
}

int sm_count() {
  static const int n = device_attribute(cudaDevAttrMultiProcessorCount);
  return n;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// The most bytes an array of `bytes` bytes takes staged (staged_bytes) where
// it starts at p + k * stride bytes for any k: every block's h and g rows
// start so, with stride the row's bytes.
size_t staged_max(const void* p, size_t bytes, size_t stride) {
  size_t most = 0;
  for (int k = 0; k < kVecBytes; ++k) {
    const size_t n = staged_bytes(static_cast<const char*>(p) + k * stride, bytes);
    if (n > most) most = n;
  }
  return most;
}

// The most bytes `rows` consecutive rows of `row` bytes each take staged,
// for any block: `arrays` runs from x (K1's h and g rows) and, for a
// backward, one from dy.
size_t staged_rows(const void* x, const void* dy, int arrays, int rows, size_t row) {
  return arrays * staged_max(x, rows * row, row) + (dy ? staged_max(dy, rows * row, row) : 0);
}

struct Plan {
  int route;    // Route
  bool vec;     // 16-byte accesses: W a multiple of V, x, y (and dy) aligned
  int gt;       // threads a row
  int threads;  // threads a block: rows a block times gt
  int blocks;
  size_t smem;  // dynamic shared memory
};

// arrays: 2 for K1 (h and g rows), 1 for K2 and K3. dy: the backward's
// gradient of y, whose rows a block stages beside x's (y is then dx); null
// for the forward.
Plan plan(const void* x, const void* dy, const void* y, int B, int C, int S, int W, int esize,
          int arrays) {
  const int V = kVecBytes / esize;
  const int nU = (S / W) * ((W + V - 1) / V);
  const size_t row = (size_t)S * esize;
  Plan p;
  p.route = kBulk;
  p.vec = W % V == 0 && aligned16(x) && aligned16(y) && (!dy || aligned16(dy));
  int per_block = 1;  // rows a block
  if (nU <= kGroupMaxUnits) {
    p.gt = kMinGroup;
    while (p.gt * kGroupUnits < nU && p.gt < 32) p.gt <<= 1;
    // Where all the rows' threads fit the card twice over, more threads a
    // row: a launch that small is bound by latency, not by issue.
    while (p.gt < 32 && p.gt < nU &&
           (size_t)B * C * p.gt * 2 <= (size_t)sm_count() * kThreadsPerSM)
      p.gt <<= 1;
    const int least = 32 / p.gt;  // a block is whole warps
    per_block = kGroupBlockThreads / p.gt;
    while (per_block > least &&
           (size_t)B * ((C + per_block - 1) / per_block) < (size_t)sm_count())
      per_block >>= 1;
    p.threads = per_block * p.gt;
    p.smem = staged_rows(x, dy, arrays, per_block, row);
  } else {
    const size_t bytes = staged_rows(x, dy, arrays, 1, row);
    const int per_row = (nU + 31) / 32 * 32;
    if (bytes > (size_t)smem_limit()) {
      p.route = kStream;
      p.smem = 0;
      p.threads = min(kMaxThreads, per_row);
    } else {
      const int rows_per_sm = (B * C + sm_count() - 1) / sm_count();
      int per_sm =
          min(kMaxBlocksPerSM, kSmemPerSM / (int)(bytes + kBlockReserve + kStaticSmem));
      per_sm = max(1, min(per_sm, rows_per_sm));
      p.smem = bytes;
      p.threads = max(32, min(min(kMaxThreads, kThreadsPerSM / per_sm / 32 * 32), per_row));
    }
    p.gt = p.threads;
  }
  p.blocks = B * ((C + per_block - 1) / per_block);
  return p;
}

template <typename T, int kEpilogue, bool kStream, bool kVec>
int launch_staged(const Plan& p, const void* x, const float* scale_h, const float* bias_h,
                  const float* scale_g, const float* bias_g, const int* lengths, void* y,
                  int C, int S, int W, cudaStream_t stream) {
  auto kernel = in_staged_kernel<T, kEpilogue, kStream, kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(static_cast<const T*>(x), scale_h, bias_h,
                                                   scale_g, bias_g, lengths,
                                                   static_cast<T*>(y), C, S / W, W, p.gt);
  return (int)cudaGetLastError();
}

template <typename T, int kEpilogue>
int staged_forward(const void* x, const float* scale_h, const float* bias_h,
                   const float* scale_g, const float* bias_g, const int* lengths, void* y,
                   int B, int C, int S, int W, int* route, void* stream) {
  const Plan p = plan(x, nullptr, y, B, C, S, W, sizeof(T), kEpilogue == kGlu ? 2 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route) *route = p.route;
  if (p.route == kStream)
    return p.vec ? launch_staged<T, kEpilogue, true, true>(p, x, scale_h, bias_h, scale_g,
                                                           bias_g, lengths, y, C, S, W, s)
                 : launch_staged<T, kEpilogue, true, false>(p, x, scale_h, bias_h, scale_g,
                                                            bias_g, lengths, y, C, S, W, s);
  return p.vec ? launch_staged<T, kEpilogue, false, true>(p, x, scale_h, bias_h, scale_g,
                                                          bias_g, lengths, y, C, S, W, s)
               : launch_staged<T, kEpilogue, false, false>(p, x, scale_h, bias_h, scale_g,
                                                           bias_g, lengths, y, C, S, W, s);
}

template <typename T, int kEpilogue, bool kStream, bool kVec>
int launch_backward(const Plan& p, const void* x, const void* dy, const float* scale_h,
                    const float* bias_h, const float* scale_g, const float* bias_g, void* dx,
                    float* part, int B, int C, int S, int W, cudaStream_t stream) {
  auto kernel = in_backward_kernel<T, kEpilogue, kStream, kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale_h, bias_h, scale_g, bias_g,
      static_cast<T*>(dx), part, B, C, S / W, W, p.gt);
  return (int)cudaGetLastError();
}

template <typename T, int kEpilogue>
int staged_backward(const void* x, const void* dy, const float* scale_h, const float* bias_h,
                    const float* scale_g, const float* bias_g, void* dx, float* part, int B,
                    int C, int S, int W, int* route, void* stream) {
  const Plan p = plan(x, dy, dx, B, C, S, W, sizeof(T), kEpilogue == kGlu ? 2 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route) *route = p.route;
  if (p.route == kStream)
    return p.vec ? launch_backward<T, kEpilogue, true, true>(p, x, dy, scale_h, bias_h, scale_g,
                                                             bias_g, dx, part, B, C, S, W, s)
                 : launch_backward<T, kEpilogue, true, false>(p, x, dy, scale_h, bias_h,
                                                              scale_g, bias_g, dx, part, B, C,
                                                              S, W, s);
  return p.vec ? launch_backward<T, kEpilogue, false, true>(p, x, dy, scale_h, bias_h, scale_g,
                                                            bias_g, dx, part, B, C, S, W, s)
               : launch_backward<T, kEpilogue, false, false>(p, x, dy, scale_h, bias_h,
                                                             scale_g, bias_g, dx, part, B, C, S,
                                                             W, s);
}

}  // namespace

extern "C" {

// x, y: (B, C, S) rows of f32 (bf16 in the _bf16 entries); scale, bias:
// (C,) f32; lengths: (B,) int32 or null; route (or null) receives the
// route launched: 0 the rows bulk-copied into shared memory, 1 each row
// streamed from device memory. Each returns a cudaError_t.
int in_forward(const void* x, const float* scale, const float* bias,
               const int* lengths, void* y, int B, int C, int S, int W,
               int* route, void* stream) {
  return staged_forward<float, kNone>(x, scale, bias, nullptr, nullptr, lengths, y, B, C, S,
                                      W, route, stream);
}

int in_forward_bf16(const void* x, const float* scale, const float* bias,
                    const int* lengths, void* y, int B, int C, int S, int W,
                    int* route, void* stream) {
  return staged_forward<__nv_bfloat16, kNone>(x, scale, bias, nullptr, nullptr, lengths, y,
                                              B, C, S, W, route, stream);
}

// swish(IN(x)); the same layout and route as in_forward.
int in_swish_forward(const void* x, const float* scale, const float* bias,
                     const int* lengths, void* y, int B, int C, int S, int W,
                     int* route, void* stream) {
  return staged_forward<float, kSwish>(x, scale, bias, nullptr, nullptr, lengths, y, B, C,
                                       S, W, route, stream);
}

int in_swish_forward_bf16(const void* x, const float* scale,
                          const float* bias, const int* lengths, void* y,
                          int B, int C, int S, int W, int* route, void* stream) {
  return staged_forward<__nv_bfloat16, kSwish>(x, scale, bias, nullptr, nullptr, lengths,
                                               y, B, C, S, W, route, stream);
}

// x: (B, 2C, S) rows (h then g); y: (B, C, S); route as in_swish_forward.
int in_glu_forward(const void* x, const float* scale_h, const float* bias_h,
                   const float* scale_g, const float* bias_g,
                   const int* lengths, void* y, int B, int C, int S, int W,
                   int* route, void* stream) {
  return staged_forward<float, kGlu>(x, scale_h, bias_h, scale_g, bias_g, lengths, y, B, C,
                                     S, W, route, stream);
}

int in_glu_forward_bf16(const void* x, const float* scale_h,
                        const float* bias_h, const float* scale_g,
                        const float* bias_g, const int* lengths, void* y,
                        int B, int C, int S, int W, int* route, void* stream) {
  return staged_forward<__nv_bfloat16, kGlu>(x, scale_h, bias_h, scale_g, bias_g, lengths,
                                             y, B, C, S, W, route, stream);
}

// The backwards. x, dx: (B, C, S) rows of f32 (bf16 in the _bf16 entries),
// the forward's input and its gradient; dy: (B, C, S), the gradient of the
// forward's output, in x's dtype; scale, bias: (C,) f32 (in_backward reads
// no bias); part: (2, B, C) f32, each row's sum(dz * xhat) (its share of
// dscale) then its sum(dz) (of dbias); route as in in_forward, the rows of
// x and dy staged together. Each returns a cudaError_t.
int in_backward(const void* x, const void* dy, const float* scale, const float* bias,
                void* dx, float* part, int B, int C, int S, int W, int* route, void* stream) {
  return staged_backward<float, kNone>(x, dy, scale, bias, nullptr, nullptr, dx, part, B, C,
                                       S, W, route, stream);
}

int in_backward_bf16(const void* x, const void* dy, const float* scale, const float* bias,
                     void* dx, float* part, int B, int C, int S, int W, int* route,
                     void* stream) {
  return staged_backward<__nv_bfloat16, kNone>(x, dy, scale, bias, nullptr, nullptr, dx, part,
                                               B, C, S, W, route, stream);
}

int in_swish_backward(const void* x, const void* dy, const float* scale, const float* bias,
                      void* dx, float* part, int B, int C, int S, int W, int* route,
                      void* stream) {
  return staged_backward<float, kSwish>(x, dy, scale, bias, nullptr, nullptr, dx, part, B, C,
                                        S, W, route, stream);
}

int in_swish_backward_bf16(const void* x, const void* dy, const float* scale,
                           const float* bias, void* dx, float* part, int B, int C, int S,
                           int W, int* route, void* stream) {
  return staged_backward<__nv_bfloat16, kSwish>(x, dy, scale, bias, nullptr, nullptr, dx,
                                                part, B, C, S, W, route, stream);
}

// x, dx: (B, 2C, S) rows (h then g); dy: (B, C, S); part: (4, B, C), h's
// pair then g's.
int in_glu_backward(const void* x, const void* dy, const float* scale_h, const float* bias_h,
                    const float* scale_g, const float* bias_g, void* dx, float* part, int B,
                    int C, int S, int W, int* route, void* stream) {
  return staged_backward<float, kGlu>(x, dy, scale_h, bias_h, scale_g, bias_g, dx, part, B, C,
                                      S, W, route, stream);
}

int in_glu_backward_bf16(const void* x, const void* dy, const float* scale_h,
                         const float* bias_h, const float* scale_g, const float* bias_g,
                         void* dx, float* part, int B, int C, int S, int W, int* route,
                         void* stream) {
  return staged_backward<__nv_bfloat16, kGlu>(x, dy, scale_h, bias_h, scale_g, bias_g, dx,
                                              part, B, C, S, W, route, stream);
}

// The most bytes a block stages in shared memory: its rows (K1's h and g
// rows; a backward's dy rows beside them), each run from its first 16-byte
// boundary to the one after its end. A longer row streams from device
// memory.
int in_gate_smem_limit(void) { return smem_limit(); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
