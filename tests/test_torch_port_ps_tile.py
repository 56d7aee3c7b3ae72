"""The index maps of K4 and K5 (``csrc/ps_in_swish.cu``), emulated on the CPU.

One block owns one (sample, channel) row: the channel's four input rows,
S4 = 4HW contiguous elements of x, staged in shared memory (the backward
also stages the (2H, 2W) dy plane behind it). A thread takes units: input
rows q = 2i and 2i+1 at h, columns w0 .. w0+V-1 (V = 16 bytes of elements),
whose outputs are the 2V consecutive elements y[2h+i, 2w0 ..]. The forward
sums over the valid output columns ow = 2w+j < L from shared memory, then
writes each unit's outputs; the backward's pass A writes dz, rounded to the
element type, over the unit's own dy slots in shared memory, and pass B
reads it back and writes dx in x's layout.

This file mirrors those formulas in numpy, each beside the ``.cu``
expression it copies (``FORMULAS``, checked to appear in the source
verbatim), with shared memory an array that starts as NaN and outputs that
start as NaN: a read of an element the stage never wrote, or an output no
unit wrote, poisons the result. The unit loop runs per thread as the kernel
strides it, at several block sizes. The vector width and the block
constants are read from the ``.cu``. Each emulated block is held against
``pixel_shuffle_in_swish_plain`` and ``pixel_shuffle_in_swish_backward_plain``
at the card tests' shapes, odd W included, within the card tests'
tolerances. The card tests (``tests/test_torch_port_cuda.py``) hold the
kernel itself.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu_torch.ops.ps import (
    pixel_shuffle_in_swish_backward_plain,
    pixel_shuffle_in_swish_plain,
    pixel_shuffle_stats_plain,
)

CU = Path(__file__).resolve().parents[1] / "maskcyclegan_vc_tpu_torch" / "csrc" / "ps_in_swish.cu"
SOURCE = CU.read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert len(found) == 1, f"{name} not found once in csrc/ps_in_swish.cu"
    return int(found[0])


VEC_BYTES = _constant("kVecBytes")
MAX_THREADS = _constant("kMaxThreads")
EPS = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)       # tests/test_torch_port_cuda.py
ONE_BF16 = dict(atol=1e-5, rtol=2 ** -7)

# The .cu expressions mirrored below, each verbatim.
FORMULAS = [
    "const int oh = u / nW, wu = u - oh * nW;",
    "const int h = oh >> 1, i = oh & 1;",
    "t.w0 = wu * V;",
    "t.n = min(V, W - t.w0);",
    "t.src0 = (2 * i * H + h) * W + t.w0;",
    "t.src1 = t.src0 + H * W;",
    "t.dst = oh * 2 * W + 2 * t.w0;",
    "const int nW = (W + V - 1) / V, nU = 2 * H * nW;",
    "const int ow = 2 * (t.w0 + k);",
    "out[2 * k] = ow < L ? swish(x0[k] * a + sh) : 0.f;",
    "out[2 * k + 1] = ow + 1 < L ? swish(x1[k] * a + sh) : 0.f;",
    "store_run<kVec>(yr + t.dst, 2 * t.n, out);",
    "const float xv = (k & 1) ? x1[k >> 1] : x0[k >> 1];",
    "store_run<kVec>(park + t.dst, 2 * t.n, g);",
    "load_run<kVec>(park + t.dst, 2 * t.n, g);",
    "store_run<kVec>(dxr + t.src0, t.n, d0);",
    "store_run<kVec>(dxr + t.src1, t.n, d1);",
    "d0[k] = a * (d0[k] - mdz - (x0[k] - mean) * inv * mdzx);",
    "(uint32_t)((reinterpret_cast<uintptr_t>(p) % kVecBytes + bytes + kVecBytes - 1) /",
    "const uint32_t lead = reinterpret_cast<uintptr_t>(src[a]) % kVecBytes;",
    "dst[a] = reinterpret_cast<T*>(smem + lead);",
    "const uint32_t h = min(bytes, (kVecBytes - lead) % kVecBytes);",
    "body[a] = (bytes - h) / kVecBytes * kVecBytes;",
    "head[a] = h / sizeof(T);",
    "tail[a] = (h + body[a]) / sizeof(T);",
    "smem += staged_bytes(src[a], bytes);",
    "const int edge = head[a] + (n - tail[a]);",
    "const int e = k < head[a] ? k : tail[a] + k - head[a];",
    "p.route = bytes > (size_t)smem_limit() ? kStream : kBulk;",
]

# The card tests' K4 and K5 shapes (x: B, 4C, H, W), odd W among them, and
# two whose W is a multiple of both vector widths.
SHAPES = [(2, 8, 3, 5), (3, 12, 4, 7), (2, 132, 5, 9), (3, 12, 5, 7), (1, 4, 1, 1),
          (2, 8, 3, 8), (1, 16, 2, 16)]
THREADS = (32, 96, MAX_THREADS)


def test_formulas_are_the_kernels():
    for f in FORMULAS:
        assert f in SOURCE, f"not in csrc/ps_in_swish.cu: {f}"


def _round(a: np.ndarray, dtype) -> np.ndarray:
    """a rounded once to dtype, returned as f32 (store_run)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).float().numpy()


class Unit:
    def __init__(self, u, nW, H, W, V):
        oh = u // nW; wu = u - oh * nW                # const int oh = u / nW, wu = ...
        h = oh >> 1; i = oh & 1                       # const int h = oh >> 1, i = oh & 1;
        self.w0 = wu * V                              # t.w0 = wu * V;
        self.n = min(V, W - self.w0)                  # t.n = min(V, W - t.w0);
        self.src0 = (2 * i * H + h) * W + self.w0     # t.src0 = (2 * i * H + h) * W + t.w0;
        self.src1 = self.src0 + H * W                 # t.src1 = t.src0 + H * W;
        self.dst = oh * 2 * W + 2 * self.w0           # t.dst = oh * 2 * W + 2 * t.w0;


def _load_run(mem, off, m, kN, vec, V):
    """load_run: m elements at off, zeros after; a vector load reads whole
    16-byte words at an aligned offset."""
    if vec:
        assert m == kN and off % V == 0
    v = np.zeros(kN, np.float32)
    v[:m] = mem[off:off + m]
    return v


def _store_run(mem, off, m, v, vec, V, dtype):
    if vec:
        assert m == len(v) and off % V == 0
    mem[off:off + m] = _round(v[:m], dtype)


def _units(tid, threads, nU):
    return range(tid, nU, threads)  # for (int u = threadIdx.x; u < nU; u += blockDim.x)


def _swish(z):
    return z / (np.float32(1) + np.exp(-z))


def emulate_forward(x, scale, bias, lengths, threads):
    """ps_in_swish_kernel on every row: y, mean, inv."""
    B, C4, H, W = x.shape
    C, S4, W2 = C4 // 4, 4 * H * W, 2 * W
    dtype = x.dtype
    V = VEC_BYTES // x.element_size()
    nW = (W + V - 1) // V; nU = 2 * H * nW            # const int nW = (W + V - 1) / V, ...
    vec = W % V == 0
    xs = x.float().numpy().reshape(B, C, S4)
    y = np.full((B, C, S4), np.nan, np.float32)
    means, invs = np.zeros((B, C), np.float32), np.zeros((B, C), np.float32)
    for b in range(B):
        L = W2 if lengths is None else min(max(int(lengths[b]), 0), W2)
        inv_n = np.float32(1) / np.float32(max(2 * H * L, 1))
        for c in range(C):
            smem = np.full(S4 + 2 * V, np.nan, np.float32)  # dynamic shared memory
            smem[:S4] = xs[b, c]                            # stage<1>
            units = [Unit(u, nW, H, W, V) for u in range(nU)]

            def row_sum(center, square):
                parts = []
                for tid in range(threads):
                    s = np.float32(0)
                    for u in _units(tid, threads, nU):
                        t = units[u]
                        a = _load_run(smem, t.src0, t.n, V, vec, V)
                        bb = _load_run(smem, t.src1, t.n, V, vec, V)
                        for k in range(V):
                            ow = 2 * (t.w0 + k)     # const int ow = 2 * (t.w0 + k);
                            da, db = a[k] - center, bb[k] - center
                            if ow < L:
                                s += da * da if square else da
                            if ow + 1 < L:
                                s += db * db if square else db
                    parts.append(s)
                return np.float32(np.sum(parts, dtype=np.float32))

            mean = row_sum(np.float32(0), False) * inv_n
            inv = np.float32(1) / np.sqrt(row_sum(mean, True) * inv_n + np.float32(EPS))
            a_ = inv * np.float32(scale[c])
            sh = np.float32(bias[c]) - mean * a_
            means[b, c], invs[b, c] = mean, inv
            for tid in range(threads):
                for u in _units(tid, threads, nU):
                    t = units[u]
                    x0 = _load_run(smem, t.src0, t.n, V, vec, V)
                    x1 = _load_run(smem, t.src1, t.n, V, vec, V)
                    out = np.zeros(2 * V, np.float32)
                    for k in range(V):
                        ow = 2 * (t.w0 + k)
                        out[2 * k] = _swish(x0[k] * a_ + sh) if ow < L else 0.0
                        out[2 * k + 1] = _swish(x1[k] * a_ + sh) if ow + 1 < L else 0.0
                    _store_run(y[b, c], t.dst, 2 * t.n, out, vec, V, dtype)
    return torch.from_numpy(y.reshape(B, C, 2 * H, W2)).to(dtype), means, invs


def emulate_backward(x, dy, scale, bias, mean, inv, threads):
    """ps_in_swish_backward_kernel on every row: dx, dscale and dbias per
    sample."""
    B, C4, H, W = x.shape
    C, S4 = C4 // 4, 4 * H * W
    dtype = x.dtype
    V = VEC_BYTES // x.element_size()
    nW = (W + V - 1) // V; nU = 2 * H * nW
    vec = W % V == 0
    xs = x.float().numpy().reshape(B, C, S4)
    dys = dy.float().numpy().reshape(B, C, S4)
    dx = np.full((B, C, S4), np.nan, np.float32)
    dscale, dbias = np.zeros((B, C), np.float32), np.zeros((B, C), np.float32)
    for b in range(B):
        for c in range(C):
            smem = np.full(2 * S4 + 2 * V, np.nan, np.float32)
            smem[:S4], smem[S4:2 * S4] = xs[b, c], dys[b, c]  # stage<2>, both aligned
            park = smem[S4:]                                    # T* park = to[1];
            written = np.zeros(S4, bool)
            m, iv = np.float32(mean[b, c]), np.float32(inv[b, c])
            a_ = iv * np.float32(scale[c])
            sh = np.float32(bias[c]) - m * a_
            units = [Unit(u, nW, H, W, V) for u in range(nU)]
            sums = []
            for tid in range(threads):  # pass A
                s0 = s1 = np.float32(0)
                for u in _units(tid, threads, nU):
                    t = units[u]
                    x0 = _load_run(smem, t.src0, t.n, V, vec, V)
                    x1 = _load_run(smem, t.src1, t.n, V, vec, V)
                    g = _load_run(park, t.dst, 2 * t.n, 2 * V, vec, V)
                    for k in range(2 * V):
                        xv = x1[k >> 1] if k & 1 else x0[k >> 1]
                        z = xv * a_ + sh
                        sg = np.float32(1) / (np.float32(1) + np.exp(-z))
                        dz = g[k] * (sg + z * sg * (np.float32(1) - sg))
                        g[k] = dz
                        if (k >> 1) < t.n:
                            s0 += dz
                            s1 += dz * xv
                    _store_run(park, t.dst, 2 * t.n, g, vec, V, dtype)
                    assert not written[t.dst:t.dst + 2 * t.n].any()
                    written[t.dst:t.dst + 2 * t.n] = True
                sums.append((s0, s1))
            assert written.all()  # every dy slot holds its dz
            sdz = np.float32(np.sum([s[0] for s in sums], dtype=np.float32))
            sdzx = np.float32(np.sum([s[1] for s in sums], dtype=np.float32))
            dsc = iv * (sdzx - m * sdz)
            dscale[b, c], dbias[b, c] = dsc, sdz
            inv_n = np.float32(1) / np.float32(S4)
            mdz, mdzx = sdz * inv_n, dsc * inv_n
            for tid in range(threads):  # pass B
                for u in _units(tid, threads, nU):
                    t = units[u]
                    x0 = _load_run(smem, t.src0, t.n, V, vec, V)
                    x1 = _load_run(smem, t.src1, t.n, V, vec, V)
                    g = _load_run(park, t.dst, 2 * t.n, 2 * V, vec, V)
                    d0 = a_ * (g[0::2] - mdz - (x0 - m) * iv * mdzx)
                    d1 = a_ * (g[1::2] - mdz - (x1 - m) * iv * mdzx)
                    _store_run(dx[b, c], t.src0, t.n, d0, vec, V, dtype)
                    _store_run(dx[b, c], t.src1, t.n, d1, vec, V, dtype)
    return (torch.from_numpy(dx.reshape(x.shape)).to(dtype), dscale.sum(0), dbias.sum(0))


def _inputs(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    B, C4, H, W = shape
    x = torch.from_numpy((rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)).to(dtype)
    s = torch.from_numpy((rs.rand(C4 // 4) + 0.5).astype(np.float32))
    b = torch.from_numpy((rs.rand(C4 // 4) * 2.0 - 1.0).astype(np.float32))
    dy = torch.from_numpy(rs.randn(B, C4 // 4, 2 * H, 2 * W).astype(np.float32)).to(dtype)
    return x, s, b, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_maps(shape, dtype):
    """Every output written once, the statistics over the valid columns: y
    against the plain version unmasked and with lengths that cut a unit
    (odd, one past a unit's start, and 0), and the statistics against the
    plain ones."""
    B, C4, H, W = shape
    x, s, b, _ = _inputs(shape, dtype, sum(shape))
    tol = TOL if dtype == torch.float32 else ONE_BF16
    lengths = [2 * W - 1, W + 1, 0][:B]
    for threads, lens in ((THREADS[0], None), (THREADS[1], lengths), (THREADS[2], None)):
        y, mean, inv = emulate_forward(x, s, b, lens, threads)
        assert not y.isnan().any()
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
        want = pixel_shuffle_in_swish_plain(x, s, b, lt)
        torch.testing.assert_close(y.float(), want.float(), **tol)
        if lens is None:
            want_mean, want_inv = pixel_shuffle_stats_plain(x)
            torch.testing.assert_close(torch.from_numpy(mean), want_mean, **TOL)
            torch.testing.assert_close(torch.from_numpy(inv), want_inv, **TOL)


def _k5_dx_bound(x, dy, s, b, mean, inv, dx):
    """tests/test_torch_port_cuda.py's bound: 1e-5 + 2**-6 max(|dx|, |a dz|)
    in bf16, TOL in f32."""
    if x.dtype == torch.float32:
        return TOL["atol"] + TOL["rtol"] * dx.abs()
    B, C4, H, W = x.shape
    xs = x.float().reshape(B, C4 // 4, -1)
    a = s[None, :, None] * inv[..., None]
    z = xs * a + (b[None, :, None] - mean[..., None] * a)
    sg = torch.sigmoid(z)
    dys = torch.nn.functional.pixel_unshuffle(dy.float(), 2).reshape(xs.shape)
    a_dz = (a * dys * (sg + z * sg * (1 - sg))).reshape(x.shape)
    return 1e-5 + 2 ** -6 * torch.maximum(dx.float().abs(), a_dz.abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_maps(shape, dtype):
    """dz over the dy slots and dx in x's layout: dx within the card tests'
    bound of the plain version (which rounds the parked dz as K5 does),
    dscale and dbias within 1e-5 of the sum of their terms' size."""
    B, C4, H, W = shape
    x, s, b, dy = _inputs(shape, dtype, sum(shape) + 1)
    mean, inv = pixel_shuffle_stats_plain(x)
    want = pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    dz = torch.nn.functional.pixel_unshuffle(dy.float(), 2).reshape(B, C4 // 4, -1).abs()
    bound = 1e-5 * (4.0 * dz).sum((0, 2))
    for threads in (THREADS[0], THREADS[2]):
        dx, dsc, dbi = emulate_backward(x, dy, s, b, mean.numpy(), inv.numpy(), threads)
        assert not dx.isnan().any()
        diff = (dx.float() - want[0].float()).abs()
        assert (diff <= _k5_dx_bound(x, dy, s, b, mean, inv, want[0])).all()
        assert ((torch.from_numpy(dsc) - want[1]).abs() <= bound).all()
        assert ((torch.from_numpy(dbi) - want[2]).abs() <= bound).all()


def _staged_bytes(addr, nbytes):
    # (uint32_t)((reinterpret_cast<uintptr_t>(p) % kVecBytes + bytes + kVecBytes - 1) / ...
    return (addr % VEC_BYTES + nbytes + VEC_BYTES - 1) // VEC_BYTES * VEC_BYTES


def emulate_stage(addrs, n, esize, threads):
    """``stage<kCount>``: arrays of n elements of esize bytes at the byte
    addresses ``addrs`` into NaN shared memory of the plan's size. Device
    memory is one array of element indices, so a copy's source shows which
    element landed where; a bulk copy must be 16-byte aligned at both ends
    and stay inside its array. Returns shared memory and each array's
    element offset in it."""
    nbytes = n * esize
    smem = np.full(sum(_staged_bytes(a, nbytes) for a in addrs) // esize, np.nan)
    base, starts, copies = 0, [], np.zeros(len(smem), int)
    for j, addr in enumerate(addrs):
        lead = addr % VEC_BYTES               # const uint32_t lead = ... % kVecBytes;
        dst = (base + lead) // esize          # dst[a] = reinterpret_cast<T*>(smem + lead);
        h = min(nbytes, (VEC_BYTES - lead) % VEC_BYTES)
        body = (nbytes - h) // VEC_BYTES * VEC_BYTES   # body[a] = (bytes - h) / 16 * 16;
        head = h // esize                     # head[a] = h / sizeof(T);
        tail = (h + body) // esize            # tail[a] = (h + body[a]) / sizeof(T);
        src = j * 10 ** 6 + np.arange(n)      # the array's elements, by index
        # thread 0: cp.async.bulk of the body, in chunks, 16-byte aligned
        if body:
            assert (addr + h) % VEC_BYTES == 0 and ((base + lead + h) % VEC_BYTES == 0)
            assert body % VEC_BYTES == 0 and head + body // esize <= n
            smem[dst + head:dst + tail] = src[head:tail]
            copies[dst + head:dst + tail] += 1
        edge = head + (n - tail)              # const int edge = head[a] + (n - tail[a]);
        for tid in range(threads):
            for k in range(tid, edge, threads):
                e = k if k < head else tail + k - head
                smem[dst + e] = src[e]
                copies[dst + e] += 1
        starts.append(dst)
        base += _staged_bytes(addr, nbytes)   # smem += staged_bytes(src[a], bytes);
    return smem, starts, copies


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("count", [1, 2])
def test_stage_copies_each_element_once(esize, count):
    """Every lead (the row's start modulo 16 bytes) and lengths around a
    16-byte unit: each element lands once at its own offset, congruent to
    its source modulo 16 bytes, the bulk part aligned at both ends and
    inside its array; shared memory holds nothing else."""
    for lead in range(0, VEC_BYTES, esize):
        for lead2 in ((lead,) if count == 1 else range(0, VEC_BYTES, esize)):
            addrs = [4096 + lead, 65536 + lead2][:count]
            for n in (1, 2, 3, VEC_BYTES // esize - 1, VEC_BYTES // esize, 37, 160):
                smem, starts, copies = emulate_stage(addrs, n, esize, threads=32)
                for j, (addr, dst) in enumerate(zip(addrs, starts)):
                    assert (dst * esize - addr) % VEC_BYTES == 0
                    np.testing.assert_array_equal(smem[dst:dst + n], j * 10 ** 6 + np.arange(n))
                    assert (copies[dst:dst + n] == 1).all()
                assert copies.sum() == count * n
