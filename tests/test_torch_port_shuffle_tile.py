"""The index maps of K6 and K7 (``csrc/pixel_shuffle.cu``), emulated on the CPU.

A thread takes a unit of V unshuffled columns of one shuffled row R =
(b*C + c)*2H + 2h + i and the 2V shuffled columns they come from: on the
vector route V is 16 bytes of elements and the shuffled side two 16-byte
words, split into evens and odds by word moves (f32) or byte permutes
(bf16); on the pair route V = 1, one element pair. A block is (tx, ty)
threads, tx the units of a row (at most the block's threads, a longer row
strided), ty rows; the grid covers the rows. The even plane's row is
4q - 3h + 2iH with q = R >> 1, h = q mod H.

This file mirrors those formulas in numpy, each beside the ``.cu``
expression it copies (``FORMULAS``, checked to appear in the source
verbatim). Device memory is an array of 32-bit words (f32, or bf16 pairs)
or of 16-bit halves (the bf16 pair route's planes); outputs start as NaN, so
an element no unit wrote poisons the result, and a unit written twice
fails. The unit walk runs per thread as the kernel strides it (every
thread of the grid at once, one stride at a time), at several block sizes.
The vector width, block size and units per thread are read from the
``.cu``. Each emulated launch is held against ``F.pixel_unshuffle`` and
``F.pixel_shuffle`` exactly, on random bit patterns (NaN payloads
included), in f32 and in bf16 (as int16 bit patterns), at the card tests'
shapes, odd W and W = 1 included, with the route each shape takes. The card
tests (``tests/test_torch_port_cuda.py``) hold the kernel itself.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

CU = Path(__file__).resolve().parents[1] / "maskcyclegan_vc_tpu_torch" / "csrc" / "pixel_shuffle.cu"
SOURCE = CU.read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert len(found) == 1, f"{name} not found once in csrc/pixel_shuffle.cu"
    return int(found[0])


VEC_BYTES = _constant("kVecBytes")
BLOCK_THREADS = _constant("kBlockThreads")
UNITS = _constant("kUnits")
INT32_MAX = 2 ** 31 - 1
VECTOR, PAIR = 0, 1  # enum Route

# The .cu expressions mirrored below, each verbatim.
FORMULAS = [
    "return (I)blockIdx.x * blockDim.y + threadIdx.y;",
    "const I q = R >> 1, i = R & 1;",
    "const I h = q - q / H * H;",
    "return 4 * q - 3 * h + 2 * i * H;",
    "const typename U::Shuffled* src = y + R * nU;",
    "typename U::Plane* dst0 = x + plane_row(R, H) * nU;",
    "typename U::Plane* dst1 = dst0 + H * nU;",
    "typename U::Shuffled* dst = y + R * nU;",
    "const typename U::Plane* src0 = x + plane_row(R, H) * nU;",
    "const typename U::Plane* src1 = src0 + H * nU;",
    "for (I u0 = threadIdx.x; u0 < nU; u0 += kUnits * blockDim.x) {",
    "const I u = u0 + k * blockDim.x;",
    "U::split(s[k], e, o);",
    "dst0[u] = e;",
    "dst1[u] = o;",
    "if (u < nU) dst[u] = U::join(e[k], o[k]);",
    "e = make_uint4(s.a.x, s.a.z, s.b.x, s.b.z);",
    "o = make_uint4(s.a.y, s.a.w, s.b.y, s.b.w);",
    "return {make_uint4(e.x, o.x, e.y, o.y), make_uint4(e.z, o.z, e.w, o.w)};",
    "lo = __byte_perm(p, q, 0x5410);",
    "hi = __byte_perm(p, q, 0x7632);",
    "transpose_halves(s.a.x, s.a.y, e.x, o.x);",
    "transpose_halves(s.a.z, s.a.w, e.y, o.y);",
    "transpose_halves(s.b.x, s.b.y, e.z, o.z);",
    "transpose_halves(s.b.z, s.b.w, e.w, o.w);",
    "transpose_halves(e.x, o.x, s.a.x, s.a.y);",
    "transpose_halves(e.y, o.y, s.a.z, s.a.w);",
    "transpose_halves(e.z, o.z, s.b.x, s.b.y);",
    "transpose_halves(e.w, o.w, s.b.z, s.b.w);",
    "e = s.x;",
    "o = s.y;",
    "return make_uint2(e, o);",
    "e = (uint16_t)(s & 0xFFFFu);",
    "o = (uint16_t)(s >> 16);",
    "return (uint32_t)e | ((uint32_t)o << 16);",
    "const I V = kVec ? kVecBytes / kElem : 1;",
    "const I rows = (I)B * C * 2 * H, nU = (I)W / V;",
    "const I per = (nU + kUnits - 1) / kUnits;",
    "const int tx = (int)(per < kBlockThreads ? per : kBlockThreads);",
    "const int ty = kBlockThreads / tx;",
    "const uint64_t blocks = ((uint64_t)rows + ty - 1) / ty;",
    "bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }",
    "const bool vec = (size_t)W * kElem % kVecBytes == 0 && aligned(src) && aligned(dst);",
    "*route = vec ? kVector : kPair;",
    "const bool narrow = n <= (size_t)INT32_MAX;",
]

# x shapes (B, 4C, H, W): the card tests' (odd W, W = 1, W x element size
# exactly 16 bytes in f32 and in bf16), and the main path's sites: a 1 x 320
# step's upSample1 and upSample2 inputs (batch 2) and a 1 x 192 step's
# upSample2 input.
SHAPES = [(2, 12, 3, 5), (1, 8, 4, 7), (3, 16, 5, 6), (1, 4, 1, 1), (2, 8, 3, 4),
          (2, 8, 3, 8), (1, 512, 40, 161), (2, 1024, 20, 80), (2, 512, 40, 160),
          (1, 512, 40, 96)]
THREADS = (32, 96, BLOCK_THREADS)
ALIGNED = 1 << 20  # a base address on a 16-byte boundary, as torch.empty gives


def test_formulas_are_the_kernels():
    for f in FORMULAS:
        assert f in SOURCE, f"not in csrc/pixel_shuffle.cu: {f}"


def route_of(W, esize, src_addr, dst_addr):
    """The C entry's route (``*route``) and offset width."""
    def aligned(p):
        return p % VEC_BYTES == 0
    vec = W * esize % VEC_BYTES == 0 and aligned(src_addr) and aligned(dst_addr)
    return VECTOR if vec else PAIR


def narrow_index(B, C, H, W):
    n = B * 4 * C * H * W
    return n <= INT32_MAX  # const bool narrow = n <= (size_t)INT32_MAX;


def geometry(B, C, H, W, esize, vec, threads):
    """The launch's rows, units a row, block shape and grid."""
    V = VEC_BYTES // esize if vec else 1     # const I V = kVec ? kVecBytes / kElem : 1;
    rows, nU = B * C * 2 * H, W // V         # const I rows = ..., nU = (I)W / V;
    per = (nU + UNITS - 1) // UNITS          # const I per = (nU + kUnits - 1) / kUnits;
    tx = per if per < threads else threads   # const int tx = (int)(per < kBlockThreads ? ...
    ty = threads // tx                       # const int ty = kBlockThreads / tx;
    blocks = (rows + ty - 1) // ty           # const uint64_t blocks = ...
    return V, rows, nU, tx, ty, blocks


def plane_row(R, H):
    q, i = R >> 1, R & 1                     # const I q = R >> 1, i = R & 1;
    h = q - q // H * H                       # const I h = q - q / H * H;
    return 4 * q - 3 * h + 2 * i * H         # return 4 * q - 3 * h + 2 * i * H;


def byte_perm(a, b, sel):
    """``__byte_perm`` on arrays of uint32: byte k of the result is byte
    (sel >> 4k) & 7 of the 8 bytes b:a."""
    pool = np.stack([(a >> np.uint32(8 * k)) & np.uint32(255) for k in range(4)]
                    + [(b >> np.uint32(8 * k)) & np.uint32(255) for k in range(4)])
    out = np.zeros_like(a)
    for k in range(4):
        out |= pool[(sel >> (4 * k)) & 7] << np.uint32(8 * k)
    return out


def transpose_halves(p, q):
    return byte_perm(p, q, 0x5410), byte_perm(p, q, 0x7632)  # lo, hi


def split(s, esize, vec):
    """U::split on a (n, words) array of shuffled units: (evens, odds)."""
    if vec and esize == 4:  # s = a.x a.y a.z a.w b.x b.y b.z b.w
        e = s[:, [0, 2, 4, 6]]  # make_uint4(s.a.x, s.a.z, s.b.x, s.b.z)
        o = s[:, [1, 3, 5, 7]]  # make_uint4(s.a.y, s.a.w, s.b.y, s.b.w)
        return e, o
    if vec:
        pairs = [transpose_halves(s[:, 2 * k], s[:, 2 * k + 1]) for k in range(4)]
        return (np.stack([p[0] for p in pairs], 1), np.stack([p[1] for p in pairs], 1))
    if esize == 4:  # uint2
        return s[:, :1], s[:, 1:]
    return ((s[:, :1] & np.uint32(0xFFFF)).astype(np.uint16),
            (s[:, :1] >> np.uint32(16)).astype(np.uint16))


def join(e, o, esize, vec):
    """U::join: two planes' units (evens, odds) to the shuffled unit."""
    if vec and esize == 4:
        return np.stack([e[:, 0], o[:, 0], e[:, 1], o[:, 1],
                         e[:, 2], o[:, 2], e[:, 3], o[:, 3]], 1)
    if vec:
        cols = []
        for k in range(4):
            cols.extend(transpose_halves(e[:, k], o[:, k]))
        return np.stack(cols, 1)
    if esize == 4:
        return np.concatenate([e, o], 1)
    return e.astype(np.uint32) | (o.astype(np.uint32) << np.uint32(16))


def words(bits: np.ndarray, esize: int, vec: bool, side: str):
    """A tensor's bits as the kernel's units: a (units, words) array. The
    shuffled side of a vector unit is 8 words, a plane's 4; the pair
    route's shuffled unit is one uint2 (f32) or one 32-bit word (bf16),
    its plane unit one element."""
    if esize == 2 and (vec or side == "shuffled"):
        bits = bits.view(np.uint32)  # bf16 pairs, little-endian
    per = {True: {"shuffled": 8, "plane": 4},
           False: {"shuffled": 2 if esize == 4 else 1, "plane": 1}}[vec][side]
    return bits.reshape(-1, per)


def emulate(kernel, src_bits, shape, esize, vec, threads):
    """One launch of ``inverse_pixel_shuffle_kernel`` (kernel "inv") or
    ``pixel_shuffle_kernel`` ("fwd") on the bits of a contiguous input;
    every thread of the grid steps through its units together."""
    B, C4, H, W = shape
    C = C4 // 4
    V, rows, nU, tx, ty, blocks = geometry(B, C, H, W, esize, vec, threads)
    assert tx * ty <= threads and blocks * ty >= rows
    out_side = "plane" if kernel == "inv" else "shuffled"
    in_side = "shuffled" if kernel == "inv" else "plane"
    src = words(src_bits, esize, vec, in_side)
    dt = np.uint16 if (esize == 2 and not vec and out_side == "plane") else np.uint32
    n_out_units = words(np.zeros(src_bits.size, src_bits.dtype), esize, vec, out_side).shape[0]
    width = words(np.zeros(src_bits.size, src_bits.dtype), esize, vec, out_side).shape[1]
    out = np.full((n_out_units, width), np.nan)
    written = np.zeros(n_out_units, np.int64)
    # every thread of the grid: (blockIdx.x, threadIdx.y, threadIdx.x)
    bx, ty_i, tx_i = np.meshgrid(np.arange(blocks), np.arange(ty), np.arange(tx), indexing="ij")
    R = (bx * ty + ty_i).ravel()  # return (I)blockIdx.x * blockDim.y + threadIdx.y;
    u0 = tx_i.ravel().copy()
    live = R < rows               # if (R >= rows) return;
    R, u0 = R[live], u0[live]
    prow = plane_row(R, H)
    while True:
        more = u0 < nU            # for (I u0 = threadIdx.x; u0 < nU; u0 += kUnits * blockDim.x)
        if not more.any():
            break
        R, u0, prow = R[more], u0[more], prow[more]
        for k in range(UNITS):
            u = u0 + k * tx       # const I u = u0 + k * blockDim.x;
            m = u < nU
            r, uu, p = R[m], u[m], prow[m]
            if kernel == "inv":
                s = src[r * nU + uu]                     # y + R * nU
                e, o = split(s, esize, vec)
                d0 = p * nU + uu                         # x + plane_row(R, H) * nU
                d1 = d0 + H * nU                         # dst0 + H * nU
                for d, v in ((d0, e), (d1, o)):
                    out[d] = v
                    written += np.bincount(d, minlength=len(written))
            else:
                s0 = p * nU + uu
                e, o = src[s0], src[s0 + H * nU]
                d = r * nU + uu
                out[d] = join(e, o, esize, vec)
                written += np.bincount(d, minlength=len(written))
        u0 = u0 + UNITS * tx
    assert (written == 1).all(), "a unit written twice or never"
    assert not np.isnan(out).any()
    got = out.astype(dt)
    return (got.view(np.uint16) if esize == 2 else got.view(np.uint32)).ravel()


def _bits(shape, esize, seed):
    """Random bit patterns of the element size, NaN payloads among them."""
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    if esize == 4:
        return rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return rs.randint(0, 2 ** 16, n, dtype=np.int64).astype(np.uint16)


def _torch_of(bits, shape, esize):
    t = torch.from_numpy(bits.view(np.int32 if esize == 4 else np.int16).reshape(shape).copy())
    return t.view(torch.float32 if esize == 4 else torch.bfloat16)


def _bits_of(t, esize):
    return t.contiguous().view(torch.int32 if esize == 4 else torch.int16).numpy().view(
        np.uint32 if esize == 4 else np.uint16).ravel()


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_unit_maps_are_the_shuffles(shape, esize):
    """K6 against ``F.pixel_unshuffle`` and K7 against ``F.pixel_shuffle``,
    bit for bit, on the route an aligned launch takes and on the pair
    route, at two or more block sizes; every output unit written once."""
    B, C4, H, W = shape
    C = C4 // 4
    big = B * C4 * H * W > 1 << 20
    threads = (THREADS[0], THREADS[-1]) if big else THREADS
    route = route_of(W, esize, ALIGNED, ALIGNED)
    x_bits = _bits(shape, esize, sum(shape) + esize)
    y_bits = _bits((B, C, 2 * H, 2 * W), esize, sum(shape) + esize + 1)
    want_y = _bits_of(F.pixel_shuffle(_torch_of(x_bits, shape, esize), 2), esize)
    want_x = _bits_of(F.pixel_unshuffle(_torch_of(y_bits, (B, C, 2 * H, 2 * W), esize), 2), esize)
    routes = (route,) if big or route == PAIR else (VECTOR, PAIR)
    for r in routes:
        for t in threads:
            got_x = emulate("inv", y_bits, shape, esize, r == VECTOR, t)
            np.testing.assert_array_equal(got_x, want_x)
            got_y = emulate("fwd", x_bits, shape, esize, r == VECTOR, t)
            np.testing.assert_array_equal(got_y, want_y)


# (x shape, element size, byte offset of the source from a 16-byte
# boundary, route): the main path's sites take the vector route; a row
# whose W elements do not fill whole 16-byte words, or a base two elements
# off a 16-byte boundary (a view at an offset of a flat buffer), the pair
# route.
ROUTE_CASES = [
    ((2, 1024, 20, 80), 4, 0, VECTOR), ((2, 512, 40, 160), 4, 0, VECTOR),
    ((1, 512, 40, 96), 4, 0, VECTOR), ((2, 512, 40, 160), 2, 0, VECTOR),
    ((2, 1024, 20, 80), 2, 0, VECTOR), ((1, 512, 40, 96), 2, 0, VECTOR),
    ((2, 8, 3, 4), 4, 0, VECTOR), ((2, 8, 3, 8), 2, 0, VECTOR),
    ((2, 8, 3, 4), 2, 0, PAIR), ((1, 512, 40, 161), 4, 0, PAIR), ((1, 4, 1, 1), 2, 0, PAIR),
    ((2, 12, 3, 5), 4, 0, PAIR), ((3, 16, 5, 6), 2, 0, PAIR),
    ((2, 512, 40, 160), 4, 8, PAIR), ((2, 512, 40, 160), 2, 4, PAIR),
]


@pytest.mark.parametrize("shape, esize, offset, route", ROUTE_CASES)
def test_routes(shape, esize, offset, route):
    """The route each shape and base takes, and 32-bit offsets at every
    site (64-bit only past INT32_MAX elements)."""
    B, C4, H, W = shape
    assert route_of(W, esize, ALIGNED + offset, ALIGNED) == route
    assert route_of(W, esize, ALIGNED, ALIGNED + offset) == route
    assert narrow_index(B, C4 // 4, H, W)
    V, rows, nU, tx, ty, blocks = geometry(B, C4 // 4, H, W, esize, route == VECTOR,
                                           BLOCK_THREADS)
    assert nU * V == W and blocks * ty >= rows > (blocks - 1) * ty


def test_wide_offsets_only_past_int32():
    assert narrow_index(1, 1 << 13, 1 << 8, 1 << 7)
    assert narrow_index(1, 1, 1, INT32_MAX // 4)
    assert not narrow_index(1, 1, 1, INT32_MAX // 4 + 1)
    assert not narrow_index(64, 512, 80, 320)
