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
// Each entry has an f32 form and a bf16 form (the `_bf16` entries), as the
// Pallas kernels keep their input's dtype; both move bits and nothing else,
// as 32- and 16-bit words, so every value (NaN payloads included) arrives
// as it left.
//
// Bound on an H100 SXM (3.35 TB/s): memory, one read and one write of every
// element, no arithmetic. So the design serves the memory system: 16-byte
// accesses, both loads of a thread issued before its stores, and almost no
// index arithmetic.
//
// Rows. Row R = (b*C + c)*2H + r of the shuffled tensor, r = 2h + i, holds
// 2W elements: its even columns are row h of unshuffled plane 4c+2i, its odd
// columns row h of plane 4c+2i+1, H rows further on. So the inverse shuffle
// is a deinterleave within a row and the shuffle an interleave: no exchange
// across rows, no shared memory. With q = R >> 1 = (b*C + c)*H + h, the
// even plane's row is 4q - 3h + 2iH: one 32-bit division (h = q mod H) per
// row, none per element.
//
// Units. A thread takes a unit of V unshuffled columns of one row and the
// 2V shuffled columns they come from. Vector route: V = 16 bytes of
// elements (4 in f32, 8 in bf16); the inverse shuffle loads two 16-byte
// words of the shuffled row, splits evens from odds in registers (word moves
// in f32, byte permutes, prmt, in bf16) and stores one 16-byte word to each
// plane; the shuffle is its mirror. It needs the row's W elements to fill
// whole 16-byte words and both base pointers on a 16-byte boundary. Pair
// route, anything else: V = 1, one pair of the shuffled row (8 bytes in
// f32, 4 in bf16) and one element of each plane, which needs only the
// two-element alignment the wrapper checks. Both routes are this kernel.
//
// Blocks. A block is (tx, ty) threads, tx the units of a row (at most
// kBlockThreads, a longer row strided), ty = kBlockThreads / tx rows; the
// grid covers the rows, sized to the work. Consecutive threads take
// consecutive units of a row and then the next row, which follows it in
// memory, so each warp's loads and stores are runs of consecutive 16-byte
// words. Offsets are 32-bit; 64-bit only where the tensor has more than
// INT32_MAX elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecBytes = 16;
constexpr int kBlockThreads = 256;
constexpr int kUnits = 1;  // units a thread loads before it stores
enum Route { kVector = 0, kPair = 1 };

// A vector unit's side in the shuffled row: 2V elements, two 16-byte words.
struct alignas(16) Words2 {
  uint4 a, b;
};

// One unit's types and its exchange, by route and element size. split takes
// the shuffled side (2V interleaved elements) to the two planes' sides (V
// evens, V odds); join is its inverse.
template <int kElem, bool kVec>
struct Unit;

template <>
struct Unit<4, true> {  // f32, V = 4: word moves
  using Shuffled = Words2;
  using Plane = uint4;
  __device__ __forceinline__ static void split(const Shuffled& s, Plane& e, Plane& o) {
    e = make_uint4(s.a.x, s.a.z, s.b.x, s.b.z);
    o = make_uint4(s.a.y, s.a.w, s.b.y, s.b.w);
  }
  __device__ __forceinline__ static Shuffled join(const Plane& e, const Plane& o) {
    return {make_uint4(e.x, o.x, e.y, o.y), make_uint4(e.z, o.z, e.w, o.w)};
  }
};

// Two 32-bit words of bf16 pairs, (p0 | p1 << 16) and (q0 | q1 << 16), to
// (p0 | q0 << 16) and (p1 | q1 << 16): a 2 x 2 transpose of 16-bit halves,
// its own inverse.
__device__ __forceinline__ void transpose_halves(uint32_t p, uint32_t q, uint32_t& lo,
                                                 uint32_t& hi) {
  lo = __byte_perm(p, q, 0x5410);
  hi = __byte_perm(p, q, 0x7632);
}

template <>
struct Unit<2, true> {  // bf16, V = 8: byte permutes
  using Shuffled = Words2;
  using Plane = uint4;
  __device__ __forceinline__ static void split(const Shuffled& s, Plane& e, Plane& o) {
    transpose_halves(s.a.x, s.a.y, e.x, o.x);
    transpose_halves(s.a.z, s.a.w, e.y, o.y);
    transpose_halves(s.b.x, s.b.y, e.z, o.z);
    transpose_halves(s.b.z, s.b.w, e.w, o.w);
  }
  __device__ __forceinline__ static Shuffled join(const Plane& e, const Plane& o) {
    Shuffled s;
    transpose_halves(e.x, o.x, s.a.x, s.a.y);
    transpose_halves(e.y, o.y, s.a.z, s.a.w);
    transpose_halves(e.z, o.z, s.b.x, s.b.y);
    transpose_halves(e.w, o.w, s.b.z, s.b.w);
    return s;
  }
};

template <>
struct Unit<4, false> {  // f32, V = 1: a float pair
  using Shuffled = uint2;
  using Plane = uint32_t;
  __device__ __forceinline__ static void split(const Shuffled& s, Plane& e, Plane& o) {
    e = s.x;
    o = s.y;
  }
  __device__ __forceinline__ static Shuffled join(const Plane& e, const Plane& o) {
    return make_uint2(e, o);
  }
};

template <>
struct Unit<2, false> {  // bf16, V = 1: a bf16 pair
  using Shuffled = uint32_t;
  using Plane = uint16_t;
  __device__ __forceinline__ static void split(const Shuffled& s, Plane& e, Plane& o) {
    e = (uint16_t)(s & 0xFFFFu);
    o = (uint16_t)(s >> 16);
  }
  __device__ __forceinline__ static Shuffled join(const Plane& e, const Plane& o) {
    return (uint32_t)e | ((uint32_t)o << 16);
  }
};

// This thread's shuffled row R (rows or more past the last). Row R starts
// R * nU units into y; the even plane's row, plane_row(R, H), starts that
// many times nU units into x, and the odd plane's H * nU units after it.
template <typename I>
__device__ __forceinline__ I row_of() {
  return (I)blockIdx.x * blockDim.y + threadIdx.y;
}

template <typename I>
__device__ __forceinline__ I plane_row(I R, I H) {
  const I q = R >> 1, i = R & 1;
  const I h = q - q / H * H;
  return 4 * q - 3 * h + 2 * i * H;
}

// rows = B*C*2H shuffled rows of nU units; a plane is H*nU units.
template <int kElem, bool kVec, typename I>
__global__ void __launch_bounds__(kBlockThreads)
    inverse_pixel_shuffle_kernel(const typename Unit<kElem, kVec>::Shuffled* __restrict__ y,
                                 typename Unit<kElem, kVec>::Plane* __restrict__ x, I rows,
                                 I H, I nU) {
  using U = Unit<kElem, kVec>;
  const I R = row_of<I>();
  if (R >= rows) return;
  const typename U::Shuffled* src = y + R * nU;
  typename U::Plane* dst0 = x + plane_row(R, H) * nU;
  typename U::Plane* dst1 = dst0 + H * nU;
  for (I u0 = threadIdx.x; u0 < nU; u0 += kUnits * blockDim.x) {
    typename U::Shuffled s[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const I u = u0 + k * blockDim.x;
      if (u < nU) s[k] = src[u];
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const I u = u0 + k * blockDim.x;
      if (u < nU) {
        // Split in registers, then one store a plane: a split straight into
        // device memory would store each 32-bit word on its own.
        typename U::Plane e, o;
        U::split(s[k], e, o);
        dst0[u] = e;
        dst1[u] = o;
      }
    }
  }
}

template <int kElem, bool kVec, typename I>
__global__ void __launch_bounds__(kBlockThreads)
    pixel_shuffle_kernel(const typename Unit<kElem, kVec>::Plane* __restrict__ x,
                         typename Unit<kElem, kVec>::Shuffled* __restrict__ y, I rows, I H,
                         I nU) {
  using U = Unit<kElem, kVec>;
  const I R = row_of<I>();
  if (R >= rows) return;
  typename U::Shuffled* dst = y + R * nU;
  const typename U::Plane* src0 = x + plane_row(R, H) * nU;
  const typename U::Plane* src1 = src0 + H * nU;
  for (I u0 = threadIdx.x; u0 < nU; u0 += kUnits * blockDim.x) {
    typename U::Plane e[kUnits], o[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const I u = u0 + k * blockDim.x;
      if (u < nU) {
        e[k] = src0[u];
        o[k] = src1[u];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const I u = u0 + k * blockDim.x;
      if (u < nU) dst[u] = U::join(e[k], o[k]);
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// One launch of the inverse shuffle (kInverse) or the shuffle on (B, C, H,
// W) as the entries take them: the vector route where the row's W
// elements fill whole 16-byte words and both pointers lie on a 16-byte
// boundary, else the pair route; 32-bit offsets up to INT32_MAX elements.
template <bool kInverse, int kElem, bool kVec, typename I>
cudaError_t launch(const void* src, void* dst, int B, int C, int H, int W,
                   cudaStream_t stream) {
  using U = Unit<kElem, kVec>;
  const I V = kVec ? kVecBytes / kElem : 1;
  const I rows = (I)B * C * 2 * H, nU = (I)W / V;
  const I per = (nU + kUnits - 1) / kUnits;  // threads a row could use
  const int tx = (int)(per < kBlockThreads ? per : kBlockThreads);
  const int ty = kBlockThreads / tx;
  const uint64_t blocks = ((uint64_t)rows + ty - 1) / ty;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 block(tx, ty);
  if (kInverse) {
    inverse_pixel_shuffle_kernel<kElem, kVec, I><<<(unsigned)blocks, block, 0, stream>>>(
        static_cast<const typename U::Shuffled*>(src), static_cast<typename U::Plane*>(dst),
        rows, (I)H, nU);
  } else {
    pixel_shuffle_kernel<kElem, kVec, I><<<(unsigned)blocks, block, 0, stream>>>(
        static_cast<const typename U::Plane*>(src), static_cast<typename U::Shuffled*>(dst),
        rows, (I)H, nU);
  }
  return cudaGetLastError();
}

template <bool kInverse, int kElem>
int shuffle(const void* src, void* dst, int B, int C, int H, int W, int* route,
            void* stream) {
  const bool vec = (size_t)W * kElem % kVecBytes == 0 && aligned(src) && aligned(dst);
  *route = vec ? kVector : kPair;
  const size_t n = (size_t)B * 4 * C * H * W;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = n <= (size_t)INT32_MAX;
  cudaError_t e;
  if (vec) {
    e = narrow ? launch<kInverse, kElem, true, uint32_t>(src, dst, B, C, H, W, s)
               : launch<kInverse, kElem, true, uint64_t>(src, dst, B, C, H, W, s);
  } else {
    e = narrow ? launch<kInverse, kElem, false, uint32_t>(src, dst, B, C, H, W, s)
               : launch<kInverse, kElem, false, uint64_t>(src, dst, B, C, H, W, s);
  }
  return (int)e;
}

}  // namespace

extern "C" {

// dy: (B, C, 2H, 2W); out: (B, 4C, H, W); f32, or bf16 in the _bf16 entry.
// *route: the route taken (0 vector, 1 pair). Returns a cudaError_t.
int inverse_pixel_shuffle_forward(const void* dy, void* out, int B, int C, int H, int W,
                                  int* route, void* stream) {
  return shuffle<true, 4>(dy, out, B, C, H, W, route, stream);
}

int inverse_pixel_shuffle_forward_bf16(const void* dy, void* out, int B, int C, int H,
                                       int W, int* route, void* stream) {
  return shuffle<true, 2>(dy, out, B, C, H, W, route, stream);
}

// x: (B, 4C, H, W); out: (B, C, 2H, 2W); f32, or bf16 in the _bf16 entry.
// *route as above. Returns a cudaError_t.
int pixel_shuffle_forward(const void* x, void* out, int B, int C, int H, int W, int* route,
                          void* stream) {
  return shuffle<false, 4>(x, out, B, C, H, W, route, stream);
}

int pixel_shuffle_forward_bf16(const void* x, void* out, int B, int C, int H, int W,
                               int* route, void* stream) {
  return shuffle<false, 2>(x, out, B, C, H, W, route, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
