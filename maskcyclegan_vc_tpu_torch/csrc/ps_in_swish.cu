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
// rows of output channel c are contiguous in x: one "row" of S4 = 4HW
// elements. y is (B, C, 2H, 2W) with
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
// back, as the Pallas kernel's dx block rounds it (ps_kernel.py:233, :251);
// its sums take dz unrounded.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The forward must read the row
// once and write the shuffled plane once, 8 bytes for each of the 4*C*H*W
// elements in f32 (4 in bf16); the backward must read x and dy and write
// dx, 12 bytes each (6 in bf16). The arithmetic (about fifteen flops and
// one exp per element forward, about thirty backward) is under the f32
// rate, but not by much in bf16, where instruction issue, not bytes, set
// the parent design's pace; so the design keeps instructions per element
// low as well (no division per element; the SFU's exp and reciprocal).
//
// Design. One block owns one row, as the Pallas kernel keeps a sample in
// VMEM (ps_kernel.py:96-113, :185-253):
// - Stage once. One thread issues a bulk copy (cp.async.bulk, the TMA's 1-D
//   form, completing on an mbarrier) of the row into shared memory; the
//   backward copies the x row and the (2H, 2W) dy plane, both contiguous.
//   DRAM is read exactly once. A row whose start or end is off a 16-byte
//   boundary (bf16 with H*W odd, or a tensor that starts off one; never the
//   model's rows, whose S4 is 80W or 160W) is bulk-copied from its first
//   to its last boundary, and the block's threads copy the head and tail,
//   under 16 bytes each.
// - Units. A thread takes a unit: input rows q = 2i and 2i+1 at h, columns
//   w0 .. w0+V-1 (V = 4 in f32, 8 in bf16: 16 bytes), which land in the 2V
//   consecutive outputs y[2h+i, 2w0 .. 2w0+2V-1]. One integer division per
//   unit, none per element; where W is a multiple of V every access is 16
//   bytes (two loads, two stores), else each unit takes scalar accesses and
//   the last unit of a row is ragged.
// - Forward: the mean, then the centred squares, over the valid columns
//   from shared memory, one block reduction each (one barrier each), then
//   the write.
// - Backward: pass A computes dz for the 2V dy elements of a unit and writes
//   it, rounded to the element type, over those same dy slots in shared
//   memory; sum(dz) and sum(dz * x) leave in one block reduction; pass B
//   writes dx once, in x's layout. x and dy are read once, dx written once.
// - Sizing: the block's threads follow from how many blocks fit an SM by
//   shared memory (and how many rows there are per SM), so that 2048
//   threads an SM stay resident where the rows allow.
// - A forward row larger than one block's shared memory (f32 upSample2 past
//   about 726 frames, bf16 past 1452) takes the streaming route: the same
//   units read from device memory, in three passes (the later ones from
//   L2). The backward has no such route: the 32 MiB budget that sends it
//   here caps its x row at 43.7 KB for the model's C >= 128, and x row and
//   dy plane past a block's shared memory are refused.
// The per-sample dscale and dbias leave as (B, C) and the caller sums them
// over B, so the result needs no atomics and does not depend on the order
// in which blocks run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kVecBytes = 16;          // one vector access
constexpr int kMaxThreads = 512;       // a block's threads, at most
constexpr int kThreadsPerSM = 2048;
constexpr int kMaxBlocksPerSM = 32;
constexpr int kSmemPerSM = 233472;     // 228 KB an SM on an H100
constexpr int kBlockReserve = 1024;    // shared memory the card keeps per block
constexpr int kStaticSmem = 1024;      // kept back for a block's static shared memory
constexpr uint32_t kBulkChunk = 65536; // bytes per cp.async.bulk
enum Route { kBulk = 0, kStream = 1 };

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

// m consecutive elements at p into v[0..m) as f32, v[m..kN) = 0. kVec: m is
// kN and p is 16-byte aligned, and kN / V 16-byte loads read them.
template <bool kVec, int kN, typename T>
__device__ __forceinline__ void load_run(const T* p, int m, float (&v)[kN]) {
  constexpr int V = Elem<T>::V;
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < kN / V; ++r)
      Elem<T>::unpack(reinterpret_cast<const uint4*>(p)[r], v + r * V);
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = k < m ? Elem<T>::get(p, k) : 0.f;
  }
}

// v[0..m) to the m consecutive elements at p, each rounded once to T.
template <bool kVec, int kN, typename T>
__device__ __forceinline__ void store_run(T* p, int m, const float (&v)[kN]) {
  constexpr int V = Elem<T>::V;
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < kN / V; ++r)
      reinterpret_cast<uint4*>(p)[r] = Elem<T>::pack(v + r * V);
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (k < m) Elem<T>::put(p, k, v[k]);
  }
}

// Unit u of a row: input rows q = 2i (j = 0) and 2i + 1 (j = 1) at h,
// columns w0 .. w0 + n - 1, at row offsets src0 and src1; their outputs are
// the 2n consecutive elements from dst, y[2h + i, 2 w0 + 2k + j] at dst +
// 2k + j. nW = ceil(W / V) units per input row.
struct Unit {
  int src0, src1, dst, w0, n;
};

__device__ __forceinline__ Unit unit_of(int u, int nW, int H, int W, int V) {
  const int oh = u / nW, wu = u - oh * nW;
  const int h = oh >> 1, i = oh & 1;
  Unit t;
  t.w0 = wu * V;
  t.n = min(V, W - t.w0);
  t.src0 = (2 * i * H + h) * W + t.w0;
  t.src1 = t.src0 + H * W;
  t.dst = oh * 2 * W + 2 * t.w0;
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each v[i] over the block; every thread receives the totals. red
// holds kN x 32 floats that no other reduction of the kernel uses, so one
// barrier suffices. blockDim.x is a multiple of 32.
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i] = warp_sum(v[i]);
    if (lane == 0) red[i * 32 + warp] = v[i];
  }
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
__host__ __device__ __forceinline__ uint32_t staged_bytes(const void* p, uint32_t bytes) {
  return (uint32_t)((reinterpret_cast<uintptr_t>(p) % kVecBytes + bytes + kVecBytes - 1) /
                    kVecBytes * kVecBytes);
}

// Copies kCount global arrays of n elements each into shared memory from
// smem on, array a at dst[a], an address congruent to src[a]'s modulo 16
// bytes, and returns when the whole block can read them. One thread issues
// cp.async.bulk copies of each array's 16-byte-aligned body, completing on
// the mbarrier bar; the block's threads copy the head before the first
// boundary and the tail after the last, under 16 bytes each, where an
// array starts or ends off one.
template <int kCount, typename T>
__device__ void stage(unsigned char* smem, const T* const (&src)[kCount], int n,
                      T* (&dst)[kCount], uint64_t* bar) {
  const uint32_t bytes = (uint32_t)n * sizeof(T);
  int head[kCount], tail[kCount];  // elements: [0, head) and [tail, n) by threads
  uint32_t body[kCount], total = 0;
#pragma unroll
  for (int a = 0; a < kCount; ++a) {
    const uint32_t lead = reinterpret_cast<uintptr_t>(src[a]) % kVecBytes;
    dst[a] = reinterpret_cast<T*>(smem + lead);
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
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst[a] + head[a]) + off),
            "l"(reinterpret_cast<const char*>(src[a] + head[a]) + off),
            "r"(min(kBulkChunk, body[a] - off)), "r"(b)
            : "memory");
  }
#pragma unroll
  for (int a = 0; a < kCount; ++a) {
    const int edge = head[a] + (n - tail[a]);
    for (int k = threadIdx.x; k < edge; k += blockDim.x) {
      const int e = k < head[a] ? k : tail[a] + k - head[a];
      dst[a][e] = src[a][e];
    }
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

// swish(z) = z * sigmoid(z), with the SFU's exp and reciprocal (__expf,
// __fdividef: a few ulp in f32, far inside the 1e-5 the kernel is held to;
// a NaN stays NaN, and z / inf is -0 for large negative z). The IEEE forms
// cost bf16 K4 and K5 a fifth of their time at 32 x 128 on an H100.
__device__ __forceinline__ float swish(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// Sum over the row's valid outputs (ow < L) of x - c, or with kSquare of
// (x - c)^2, this thread's units only. src: the row in shared memory, or in
// device memory on the streaming route.
template <bool kVec, bool kSquare, typename T>
__device__ __forceinline__ float row_sum(const T* src, int nU, int nW, int H, int W,
                                         int L, float c) {
  constexpr int V = Elem<T>::V;
  float s = 0.f;
  for (int u = threadIdx.x; u < nU; u += blockDim.x) {
    const Unit t = unit_of(u, nW, H, W, V);
    float a[V], b[V];
    load_run<kVec>(src + t.src0, t.n, a);
    load_run<kVec>(src + t.src1, t.n, b);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ow = 2 * (t.w0 + k);  // >= 2W past a ragged unit's end
      const float da = a[k] - c, db = b[k] - c;
      if (ow < L) s += kSquare ? da * da : da;
      if (ow + 1 < L) s += kSquare ? db * db : db;
    }
  }
  return s;
}

template <typename T, bool kStream, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    ps_in_swish_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const int* __restrict__ lengths,
                       T* __restrict__ y, float* __restrict__ mean_out,
                       float* __restrict__ inv_out, int C, int H, int W) {
  constexpr int V = Elem<T>::V;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2 * 32];
  const int row = blockIdx.x;  // b * C + c
  const int b = row / C, c = row - b * C;
  const int W2 = 2 * W, S4 = 4 * H * W;
  const int L = lengths ? min(max(lengths[b], 0), W2) : W2;
  const int nW = (W + V - 1) / V, nU = 2 * H * nW;
  const float inv_n = 1.f / (float)max(2 * H * L, 1);
  const T* src = x + (size_t)row * S4;  // rows 4c .. 4c+3 of sample b
  T* yr = y + (size_t)row * S4;
  if constexpr (!kStream) {
    const T* const from[1] = {src};
    T* to[1];
    stage<1>(dyn, from, S4, to, &bar);
    src = to[0];
  }

  float m[1] = {row_sum<kVec, false>(src, nU, nW, H, W, L, 0.f)};
  block_sum(m, red);
  const float mean = m[0] * inv_n;
  float q[1] = {row_sum<kVec, true>(src, nU, nW, H, W, L, mean)};
  block_sum(q, red + 32);
  const float inv = rsqrtf(q[0] * inv_n + kEps);
  const float a = inv * scale[c];
  const float sh = bias[c] - mean * a;
  if (mean_out && threadIdx.x == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }

  for (int u = threadIdx.x; u < nU; u += blockDim.x) {
    const Unit t = unit_of(u, nW, H, W, V);
    float x0[V], x1[V], out[2 * V];
    load_run<kVec>(src + t.src0, t.n, x0);
    load_run<kVec>(src + t.src1, t.n, x1);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ow = 2 * (t.w0 + k);
      out[2 * k] = ow < L ? swish(x0[k] * a + sh) : 0.f;
      out[2 * k + 1] = ow + 1 < L ? swish(x1[k] * a + sh) : 0.f;
    }
    store_run<kVec>(yr + t.dst, 2 * t.n, out);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) ps_in_swish_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ mean_in,
    const float* __restrict__ inv_in, T* __restrict__ dx, float* __restrict__ dscale,
    float* __restrict__ dbias, int C, int H, int W) {
  constexpr int V = Elem<T>::V;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2 * 32];
  const int row = blockIdx.x;  // b * C + c
  const int c = row % C;
  const int S4 = 4 * H * W;
  const int nW = (W + V - 1) / V, nU = 2 * H * nW;
  const float mean = mean_in[row], inv = inv_in[row];
  const float a = inv * scale[c];
  const float sh = bias[c] - mean * a;
  T* dxr = dx + (size_t)row * S4;
  const T* const from[2] = {x + (size_t)row * S4, dy + (size_t)row * S4};
  T* to[2];
  stage<2>(dyn, from, S4, to, &bar);
  const T* xs = to[0];
  T* park = to[1];  // the dy plane in shared memory, dz written over it

  // Pass A: dz = dy * swish'(z), parked rounded to T over its dy slots in
  // shared memory; sums of dz and dz * x.
  float sums[2] = {0.f, 0.f};
  for (int u = threadIdx.x; u < nU; u += blockDim.x) {
    const Unit t = unit_of(u, nW, H, W, V);
    float x0[V], x1[V], g[2 * V];
    load_run<kVec>(xs + t.src0, t.n, x0);
    load_run<kVec>(xs + t.src1, t.n, x1);
    load_run<kVec>(park + t.dst, 2 * t.n, g);
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) {
      const float xv = (k & 1) ? x1[k >> 1] : x0[k >> 1];
      const float z = xv * a + sh;
      const float sg = __fdividef(1.f, 1.f + __expf(-z));
      const float dz = g[k] * (sg + z * sg * (1.f - sg));
      g[k] = dz;
      if ((k >> 1) < t.n) {
        sums[0] += dz;
        sums[1] += dz * xv;
      }
    }
    store_run<kVec>(park + t.dst, 2 * t.n, g);
  }
  block_sum(sums, red);
  const float sdz = sums[0];
  // sum(dz * xhat) = inv * (sum(dz * x) - mean * sum(dz)).
  const float dsc = inv * (sums[1] - mean * sdz);
  if (threadIdx.x == 0) {
    dscale[row] = dsc;
    dbias[row] = sdz;
  }

  // Pass B: dx = a * (dz - sum(dz)/n - xhat * dscale/n), xhat = (x-mean)*inv,
  // with dz the parked value (in bf16, rounded), read back by the thread
  // that wrote it.
  const float inv_n = 1.f / (float)S4;
  const float mdz = sdz * inv_n, mdzx = dsc * inv_n;
  for (int u = threadIdx.x; u < nU; u += blockDim.x) {
    const Unit t = unit_of(u, nW, H, W, V);
    float x0[V], x1[V], d0[V], d1[V];
    load_run<kVec>(xs + t.src0, t.n, x0);
    load_run<kVec>(xs + t.src1, t.n, x1);
    float g[2 * V];
    load_run<kVec>(park + t.dst, 2 * t.n, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      d0[k] = g[2 * k];
      d1[k] = g[2 * k + 1];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      d0[k] = a * (d0[k] - mdz - (x0[k] - mean) * inv * mdzx);
      d1[k] = a * (d1[k] - mdz - (x1[k] - mean) * inv * mdzx);
    }
    store_run<kVec>(dxr + t.src0, t.n, d0);
    store_run<kVec>(dxr + t.src1, t.n, d1);
  }
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The most shared memory one block's row (or x row and dy plane) may take.
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

struct Plan {
  int route;   // Route
  bool vec;    // 16-byte accesses: W a multiple of V, every row's start aligned
  int threads;
  size_t smem;  // dynamic shared memory
};

// dy: null for the forward, whose block stages x's row alone. A row staged
// at an address congruent to its own modulo 16 bytes takes staged_bytes.
Plan plan(const void* x, const void* dy, int B, int C, int H, int W, int esize) {
  const int V = kVecBytes / esize;
  const uint32_t row = (uint32_t)4 * H * W * esize;
  const size_t bytes = staged_bytes(x, row) + (dy ? staged_bytes(dy, row) : 0);
  Plan p;
  p.route = bytes > (size_t)smem_limit() ? kStream : kBulk;
  p.vec = W % V == 0 && aligned16(x) && (!dy || aligned16(dy));
  p.smem = p.route == kStream ? 0 : bytes;
  const int units = 2 * H * ((W + V - 1) / V);
  const int per_row = (units + 31) / 32 * 32;
  if (p.route == kStream) {
    p.threads = min(kMaxThreads, per_row);
    return p;
  }
  const int rows_per_sm = (B * C + sm_count() - 1) / sm_count();
  int per_sm = min(kMaxBlocksPerSM, kSmemPerSM / (int)(bytes + kBlockReserve + kStaticSmem));
  per_sm = max(1, min(per_sm, rows_per_sm));
  p.threads = max(32, min(min(kMaxThreads, kThreadsPerSM / per_sm / 32 * 32), per_row));
  return p;
}

template <typename T, bool kStream, bool kVec>
int launch_forward(const Plan& p, const void* x, const float* scale, const float* bias,
                   const int* lengths, void* y, float* mean, float* inv, int B, int C,
                   int H, int W, cudaStream_t stream) {
  auto kernel = ps_in_swish_kernel<T, kStream, kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<B * C, p.threads, p.smem, stream>>>(static_cast<const T*>(x), scale, bias,
                                                lengths, static_cast<T*>(y), mean, inv, C,
                                                H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* x, const float* scale, const float* bias, const int* lengths,
            void* y, float* mean, float* inv, int B, int C, int H, int W, int* route,
            void* stream) {
  const Plan p = plan(x, nullptr, B, C, H, W, sizeof(T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route) *route = p.route;
  if (p.route == kStream)
    return p.vec ? launch_forward<T, true, true>(p, x, scale, bias, lengths, y, mean, inv,
                                                 B, C, H, W, s)
                 : launch_forward<T, true, false>(p, x, scale, bias, lengths, y, mean,
                                                  inv, B, C, H, W, s);
  return p.vec ? launch_forward<T, false, true>(p, x, scale, bias, lengths, y, mean, inv, B,
                                                C, H, W, s)
               : launch_forward<T, false, false>(p, x, scale, bias, lengths, y, mean, inv,
                                                 B, C, H, W, s);
}

template <typename T, bool kVec>
int launch_backward(const Plan& p, const void* x, const void* dy, const float* scale,
                    const float* bias, const float* mean, const float* inv, void* dx,
                    float* dscale, float* dbias, int B, int C, int H, int W,
                    cudaStream_t stream) {
  auto kernel = ps_in_swish_backward_kernel<T, kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<B * C, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias, mean, inv,
      static_cast<T*>(dx), dscale, dbias, C, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* dy, const float* scale, const float* bias,
             const float* mean, const float* inv, void* dx, float* dscale, float* dbias,
             int B, int C, int H, int W, void* stream) {
  const Plan p = plan(x, dy, B, C, H, W, sizeof(T));
  if (p.route != kBulk) return (int)cudaErrorInvalidValue;  // past a block's shared memory
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.vec ? launch_backward<T, true>(p, x, dy, scale, bias, mean, inv, dx, dscale,
                                          dbias, B, C, H, W, s)
               : launch_backward<T, false>(p, x, dy, scale, bias, mean, inv, dx, dscale,
                                           dbias, B, C, H, W, s);
}

}  // namespace

extern "C" {

// x: (B, 4C, H, W); y: (B, C, 2H, 2W), both f32 (bf16 in the _bf16 entry);
// lengths: (B,) int32 or null; mean, inv: (B, C) f32 outputs, both null or
// both given; route (or null) receives the route launched: 0 the row
// bulk-copied into shared memory, 1 the row streamed from device memory.
// Returns a cudaError_t.
int ps_in_swish_forward(const void* x, const float* scale, const float* bias,
                        const int* lengths, void* y, float* mean, float* inv,
                        int B, int C, int H, int W, int* route, void* stream) {
  return forward<float>(x, scale, bias, lengths, y, mean, inv, B, C, H, W,
                        route, stream);
}

int ps_in_swish_forward_bf16(const void* x, const float* scale,
                             const float* bias, const int* lengths, void* y,
                             float* mean, float* inv, int B, int C, int H,
                             int W, int* route, void* stream) {
  return forward<__nv_bfloat16>(x, scale, bias, lengths, y, mean, inv, B, C,
                                H, W, route, stream);
}

// x, dx: (B, 4C, H, W); dy: (B, C, 2H, 2W), all f32 (bf16 in the _bf16
// entry); mean, inv: (B, C) f32 from the forward; dscale, dbias: (B, C) f32
// per-sample outputs. The x row and the dy plane of a block must fit its
// shared memory together (ps_in_swish_smem_limit), else the entry returns
// cudaErrorInvalidValue and launches nothing. Returns a cudaError_t.
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

// The most bytes a block stages in shared memory: a forward row, or a
// backward's x row and dy plane together, each from its first 16-byte
// boundary to the one after its end.
int ps_in_swish_smem_limit(void) { return smem_limit(); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
