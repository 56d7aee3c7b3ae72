"""The index maps of K1, K2 and K3 (``csrc/in_gate.cu``, ``in_staged_kernel``), emulated on the CPU.

A launch's plan gives each (sample, channel) row to a group of threads: a
row of up to ``kGroupMaxUnits`` 16-byte units to a group of 4-32 lanes, a
block holding several such rows of one sample; a longer row to a whole
block. A block's rows are staged once in shared memory (K1: its h rows and
its g rows, C*S elements further on), each run bulk-copied between its
16-byte boundaries with the head and tail copied by the block's threads; a
row past a block's shared memory streams from device memory instead. A
thread takes units: V = 16 bytes of consecutive columns of one line of its
row. The sums over the valid columns (w < L) leave in one group reduction
for h and g together, then the centred squares in another, then each unit's
outputs are written: K2's as they are, K3's through swish, K1's gated.

This file mirrors those formulas in numpy, each beside the ``.cu``
expression it copies (``FORMULAS``, checked to appear in the source
verbatim), with shared memory an array that starts as NaN and outputs that
start as NaN: a load of an element the stage never wrote fails, and so does
an output written twice or not at all. The plan is computed for an H100
(132 SMs, 232,448 bytes of shared memory a block may opt in to); the
vector width and the block constants are read from the ``.cu``. Each
emulated launch is held against ``instance_norm_glu_plain``,
``instance_norm_plain`` and ``instance_norm_swish_plain`` at the card
tests' shapes and tolerances,
with odd W, S % V != 0, lengths of 0, 1 and W, row groups that end inside
a block, and a tensor that starts off a 16-byte boundary. The card tests
(``tests/test_torch_port_cuda.py``) hold the kernel itself.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm_glu_plain,
    instance_norm_plain,
    instance_norm_swish_plain,
)

CU = Path(__file__).resolve().parents[1] / "maskcyclegan_vc_tpu_torch" / "csrc" / "in_gate.cu"
SOURCE = CU.read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr (?:int|uint32_t) {name} = (\d+);", SOURCE)
    assert len(found) == 1, f"{name} not found once in csrc/in_gate.cu"
    return int(found[0])


VEC_BYTES = _constant("kVecBytes")
MAX_THREADS = _constant("kMaxThreads")
THREADS_PER_SM = _constant("kThreadsPerSM")
MAX_BLOCKS_PER_SM = _constant("kMaxBlocksPerSM")
SMEM_PER_SM = _constant("kSmemPerSM")
BLOCK_RESERVE = _constant("kBlockReserve")
STATIC_SMEM = _constant("kStaticSmem")
MIN_GROUP = _constant("kMinGroup")
GROUP_UNITS = _constant("kGroupUnits")
GROUP_MAX_UNITS = _constant("kGroupMaxUnits")
GROUP_BLOCK_THREADS = _constant("kGroupBlockThreads")
SM_COUNT = 132                       # H100 SXM
SMEM_LIMIT = 232448 - STATIC_SMEM    # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
EPS = np.float32(1e-5)
TOL = dict(atol=1e-5, rtol=1e-5)       # tests/test_torch_port_cuda.py
ONE_BF16 = dict(atol=1e-5, rtol=2 ** -7)

# The .cu expressions mirrored below, each verbatim.
FORMULAS = [
    # plan
    "const int nU = (S / W) * ((W + V - 1) / V);",
    "p.vec = W % V == 0 && aligned16(x) && aligned16(y);",
    "while (p.gt * kGroupUnits < nU && p.gt < 32) p.gt <<= 1;",
    "while (p.gt < 32 && p.gt < nU &&",
    "(size_t)B * C * p.gt * 2 <= (size_t)sm_count() * kThreadsPerSM)",
    "const int least = 32 / p.gt;  // a block is whole warps",
    "per_block = kGroupBlockThreads / p.gt;",
    "(size_t)B * ((C + per_block - 1) / per_block) < (size_t)sm_count())",
    "per_block >>= 1;",
    "p.threads = per_block * p.gt;",
    "p.smem = arrays * staged_max(x, per_block * row, row);",
    "const size_t bytes = arrays * staged_max(x, row, row);",
    "const int per_row = (nU + 31) / 32 * 32;",
    "if (bytes > (size_t)smem_limit()) {",
    "p.threads = min(kMaxThreads, per_row);",
    "const int rows_per_sm = (B * C + sm_count() - 1) / sm_count();",
    "min(kMaxBlocksPerSM, kSmemPerSM / (int)(bytes + kBlockReserve + kStaticSmem));",
    "per_sm = max(1, min(per_sm, rows_per_sm));",
    "p.threads = max(32, min(min(kMaxThreads, kThreadsPerSM / per_sm / 32 * 32), per_row));",
    "p.gt = p.threads;",
    "p.blocks = B * ((C + per_block - 1) / per_block);",
    "staged_bytes(static_cast<const char*>(p) + k * stride, bytes);",
    # rows to threads
    "const int R = blockDim.x / gt;",
    "const int groups = (C + R - 1) / R;  // blocks a sample",
    "const int b = blockIdx.x / groups;",
    "const int c0 = (blockIdx.x - b * groups) * R;",
    "const int rows = min(R, C - c0);",
    "const int j = threadIdx.x / gt, t = threadIdx.x - j * gt;",
    "const bool live = j < rows;",
    "src[0] = x + ((size_t)b * A * C + c0) * S;",
    "if constexpr (kGated) src[1] = src[0] + (size_t)C * S;",
    "stage<A>(dyn, src, rows * S, row, &bar);",
    "for (int a = 0; a < A; ++a) row[a] += (size_t)j * S;",
    "T* yr = y + ((size_t)b * C + c) * S;",
    # units and statistics
    "const int L = lengths ? min(max(lengths[b], 0), W) : W;",
    "const int nW = (W + V - 1) / V, nU = H * nW;",
    "const float inv_n = 1.f / (float)max(H * L, 1);",
    "h = t / nW, wu = t - h * nW;",
    "dh = gt / nW, dw = gt - dh * nW;",
    "h += dh, wu += dw;",
    "if (wu >= nW) wu -= nW, ++h;",
    "const Walk start(t, gt, nW);",
    "for (int u = t; u < nU; u += gt, w.next(nW)) {",
    "const int w0 = w.wu * V, n = min(V, W - w0), off = w.h * W + w0;",
    "if (w0 + V <= L) {",
    "if (w0 + k < L) s[a] += kSquare ? d * d : d;",
    "for (int o = width >> 1; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);",
    "const int width = min(gt, 32);",
    "if (lane == 0) red[i * 32 + warp] = v[i];",
    "v[i] = warp_sum(lane < warps ? red[i * 32 + lane] : 0.f);",
    "group_sum(m, gt, red);",
    "group_sum(q, gt, red + A * 32);",
    "for (int a = 0; a < A; ++a) m[a] *= inv_n;",
    "const float ah = rsqrtf(q[0] * inv_n + kEps) * scale_h[c];",
    "const float bh = bias_h[c] - m[0] * ah;",
    "ag = rsqrtf(q[1] * inv_n + kEps) * scale_g[c];",
    "bg = bias_g[c] - m[1] * ag;",
    "if constexpr (kGated) z *= sigmoid(g[k] * ag + bg);",
    "else if constexpr (kEpilogue == kSwish) z = swish(z);",
    "return staged_forward<float, kNone>(x, scale, bias, nullptr, nullptr, lengths, y, B, C, S,",
    "return staged_forward<__nv_bfloat16, kNone>(x, scale, bias, nullptr, nullptr, lengths, y,",
    "const bool full = w0 + V <= L;",
    "out[k] = full || w0 + k < L ? z : 0.f;",
    "store_unit<kVec>(yr + off, n, out);",
    "__device__ __forceinline__ float swish(float z) { return __fdividef(z, 1.f + __expf(-z)); }",
    "return __fdividef(1.f, 1.f + __expf(-v));",
    # stage
    "(reinterpret_cast<uintptr_t>(p) % kVecBytes + bytes + kVecBytes - 1) / kVecBytes *",
    "const uint32_t lead = reinterpret_cast<uintptr_t>(src[a]) % kVecBytes;",
    "to[a] = reinterpret_cast<T*>(smem + lead);",
    "const uint32_t h = min(bytes, (kVecBytes - lead) % kVecBytes);",
    "body[a] = (bytes - h) / kVecBytes * kVecBytes;",
    "head[a] = h / sizeof(T);",
    "tail[a] = (h + body[a]) / sizeof(T);",
    "smem += staged_bytes(src[a], bytes);",
    "const int edge = head[a] + (n - tail[a]);",
    "const int e = k < head[a] ? k : tail[a] + k - head[a];",
]


def test_formulas_are_the_kernels():
    for f in FORMULAS:
        assert f in SOURCE, f"not in csrc/in_gate.cu: {f}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def staged_bytes(addr: int, nbytes: int) -> int:
    return (addr % VEC_BYTES + nbytes + VEC_BYTES - 1) // VEC_BYTES * VEC_BYTES


def staged_max(addr: int, nbytes: int, stride: int) -> int:
    return max(staged_bytes(addr + k * stride, nbytes) for k in range(VEC_BYTES))


def plan(x_addr, y_addr, B, C, S, W, esize, arrays, sm_count=SM_COUNT):
    """``plan`` of in_gate.cu for x and y at the byte addresses given, on a
    card of ``sm_count`` SMs."""
    V = VEC_BYTES // esize
    nU = (S // W) * _cdiv(W, V)
    row = S * esize
    p = dict(route="bulk", vec=W % V == 0 and x_addr % VEC_BYTES == 0 and y_addr % VEC_BYTES == 0)
    per_block = 1
    if nU <= GROUP_MAX_UNITS:
        gt = MIN_GROUP
        while gt * GROUP_UNITS < nU and gt < 32:
            gt <<= 1
        while gt < 32 and gt < nU and B * C * gt * 2 <= sm_count * THREADS_PER_SM:
            gt <<= 1
        least = 32 // gt
        per_block = GROUP_BLOCK_THREADS // gt
        while per_block > least and B * _cdiv(C, per_block) < sm_count:
            per_block >>= 1
        p.update(gt=gt, threads=per_block * gt,
                 smem=arrays * staged_max(x_addr, per_block * row, row))
    else:
        nbytes = arrays * staged_max(x_addr, row, row)
        per_row = (nU + 31) // 32 * 32
        if nbytes > SMEM_LIMIT:
            p.update(route="stream", smem=0, threads=min(MAX_THREADS, per_row))
        else:
            rows_per_sm = _cdiv(B * C, sm_count)
            per_sm = min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (nbytes + BLOCK_RESERVE + STATIC_SMEM))
            per_sm = max(1, min(per_sm, rows_per_sm))
            p.update(smem=nbytes, threads=max(32, min(min(MAX_THREADS,
                                                          THREADS_PER_SM // per_sm // 32 * 32),
                                                      per_row)))
        p["gt"] = p["threads"]
    p["blocks"] = B * _cdiv(C, per_block)
    return p


def emulate_stage(smem_bytes, addrs, n, esize, memory):
    """``stage<kCount>``: arrays of n elements of esize bytes, each given
    as (its byte address, its element offset in ``memory``), into NaN
    shared memory of the plan's ``smem_bytes``. A bulk copy must be 16-byte
    aligned at both ends and stay inside its array. Returns shared memory
    (f32 values) and each array's element offset in it."""
    smem = np.full(smem_bytes // esize, np.nan, np.float32)
    copies = np.zeros(len(smem), int)
    nbytes = n * esize
    base, starts = 0, []
    for addr, src in addrs:
        lead = addr % VEC_BYTES               # const uint32_t lead = ... % kVecBytes;
        dst = (base + lead) // esize          # to[a] = reinterpret_cast<T*>(smem + lead);
        h = min(nbytes, (VEC_BYTES - lead) % VEC_BYTES)
        body = (nbytes - h) // VEC_BYTES * VEC_BYTES  # body[a] = (bytes - h) / 16 * 16;
        head = h // esize                     # head[a] = h / sizeof(T);
        tail = (h + body) // esize            # tail[a] = (h + body[a]) / sizeof(T);
        assert base + staged_bytes(addr, nbytes) <= smem_bytes  # fits the plan's smem
        if body:  # thread 0: cp.async.bulk, 16-byte aligned at both ends
            assert (addr + h) % VEC_BYTES == 0 and (base + lead + h) % VEC_BYTES == 0
            smem[dst + head:dst + tail] = memory[src + head:src + tail]
            copies[dst + head:dst + tail] += 1
        edge = head + (n - tail)              # const int edge = head[a] + (n - tail[a]);
        ks = np.arange(edge)                  # for (k = threadIdx.x; k < edge; k += blockDim.x)
        e = np.where(ks < head, ks, tail + ks - head)  # const int e = k < head[a] ? ...
        smem[dst + e] = memory[src + e]
        np.add.at(copies, dst + e, 1)
        starts.append(dst)
        base += staged_bytes(addr, nbytes)    # smem += staged_bytes(src[a], bytes);
    for dst in starts:
        assert (copies[dst:dst + n] == 1).all()
    assert copies.sum() == len(starts) * n
    return smem, starts


def group_sum(v, gt, threads):
    """``group_sum``: v (kN, threads) per-thread values -> the totals every
    thread of each group receives."""
    lanes = np.arange(threads)
    width = min(gt, 32)
    o = width >> 1
    while o > 0:  # __shfl_xor_sync, within each warp
        v = v + v[:, lanes ^ o]
        o >>= 1
    if gt <= 32:
        return v
    warps = threads >> 5
    red = np.zeros((v.shape[0], 32), np.float32)
    red[:, :warps] = v[:, ::32]              # lane 0 of each warp
    o = 16
    while o > 0:
        red = red + red[:, np.arange(32) ^ o]
        o >>= 1
    return np.repeat(red[:, :1], threads, axis=1)


def walk(t, gt, nU, nW):
    """``Walk``: thread t's units u = t, t + gt, ... as (u, h, wu), with one
    division where the walk starts."""
    h = t // nW; wu = t - h * nW            # h = t / nW, wu = t - h * nW;
    dh = gt // nW; dw = gt - dh * nW        # dh = gt / nW, dw = gt - dh * nW;
    out = []
    for u in range(t, nU, gt):              # for (...; u += gt, w.next(nW))
        out.append((u, h, wu))
        h += dh; wu += dw                   # h += dh, wu += dw;
        if wu >= nW:                        # if (wu >= nW) wu -= nW, ++h;
            wu -= nW; h += 1
    return out


def _round(a: np.ndarray, dtype) -> np.ndarray:
    """a rounded once to dtype, returned as f32 (store_unit)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).float().numpy()


def emulate(kernel, x, vecs, lengths=None, lead=0, sm_count=SM_COUNT):
    """One launch of ``in_staged_kernel``, every block of its grid, with x at a
    byte address ``lead`` past a 16-byte boundary (y aligned, as
    ``torch.empty`` gives it), planned for a card of ``sm_count`` SMs.
    Returns y and the plan."""
    gated = kernel == "in_glu"
    A = 2 if gated else 1
    B, W = x.shape[0], x.shape[-1]
    C = x.shape[1] // A
    S = int(np.prod(x.shape[2:]))
    H = S // W
    esize = x.element_size()
    V = VEC_BYTES // esize
    x_addr, y_addr = 4096 + lead, 1 << 20
    p = plan(x_addr, y_addr, B, C, S, W, esize, A, sm_count)
    vec, gt, threads = p["vec"], p["gt"], p["threads"]
    memory = x.float().numpy().reshape(-1)  # device memory, element-indexed
    y = np.full(B * C * S, np.nan, np.float32)
    written = np.zeros(B * C * S, int)
    nW = _cdiv(W, V); nU = H * nW            # const int nW = (W + V - 1) / V, nU = H * nW;
    # Each thread's walk gives each of its units' line and column.
    h, wu = np.full(nU, -1), np.full(nU, -1)
    for t in range(gt):
        for uu, hh, ww in walk(t, gt, nU, nW):
            assert h[uu] == -1, "a unit walked twice"
            h[uu], wu[uu] = hh, ww
    assert (h >= 0).all() and (wu < nW).all(), "a unit no thread walked"
    w0 = wu * V                              # const int w0 = w.wu * V,
    n = np.minimum(V, W - w0)                # n = min(V, W - w0),
    off = h * W + w0                         # off = w.h * W + w0;
    k = np.arange(V)
    inside = k[None, :] < n[:, None]         # the unit's n elements; zeros past them
    idx = off[:, None] + np.where(inside, k[None, :], 0)
    if vec:
        assert (n == V).all()
    R = threads // gt                        # const int R = blockDim.x / gt;
    groups = _cdiv(C, R)                     # const int groups = (C + R - 1) / R;
    m_units = _cdiv(nU, gt)                  # units of a thread, at most
    scale = [v.numpy().astype(np.float32) for v in vecs]
    for blk in range(p["blocks"]):
        b = blk // groups                    # const int b = blockIdx.x / groups;
        c0 = (blk - b * groups) * R          # const int c0 = (blockIdx.x - b * groups) * R;
        rows = min(R, C - c0)                # const int rows = min(R, C - c0);
        src = [(b * A * C + c0) * S]         # src[0] = x + ((size_t)b * A * C + c0) * S;
        if gated:
            src.append(src[0] + C * S)       # src[1] = src[0] + (size_t)C * S;
        if p["route"] == "stream":
            buf, starts, buf_addr = memory, src, [x_addr + s * esize for s in src]
        else:
            buf, starts = emulate_stage(p["smem"], [(x_addr + s * esize, s) for s in src],
                                        rows * S, esize, memory)
            buf_addr = [d * esize for d in starts]  # dynamic shared memory is 128-aligned
        L = W if lengths is None else min(max(int(lengths[b]), 0), W)
        inv_n = np.float32(1) / np.float32(max(H * L, 1))
        valid = (w0[:, None] + k[None, :]) < L   # if (q.w0 + k < L)
        vals = []
        for a in range(A):
            row0 = starts[a] + np.arange(rows) * S   # row[a] += (size_t)j * S;
            v = buf[row0[:, None, None] + idx[None]]
            assert not np.isnan(v[:, inside]).any(), "read shared memory the stage never wrote"
            if vec:
                assert ((buf_addr[a] + (row0[:, None] - starts[a] + off[None]) * esize)
                        % VEC_BYTES == 0).all()
            vals.append(np.where(inside[None], v, np.float32(0)).astype(np.float32))

        def sums(center, square):
            """Each thread's sum over its units (u = t, t + gt, ...), then
            group_sum over the block, h and g together."""
            part = np.zeros((A, threads), np.float32)
            for a in range(A):
                d = vals[a] - center[a][:, None, None]
                d = np.where(valid[None], d * d if square else d, np.float32(0))
                per_unit = np.zeros((rows, m_units * gt), np.float32)
                per_unit[:, :nU] = d.sum(-1, dtype=np.float32)
                part[a, :rows * gt] = per_unit.reshape(rows, m_units, gt).sum(
                    1, dtype=np.float32).reshape(-1)
            total = group_sum(part, gt, threads)
            return total[:, np.arange(rows) * gt]  # (A, rows): thread j*gt of each row

        zero = [np.zeros(rows, np.float32)] * A
        mean = sums(zero, False) * inv_n         # m[a] *= inv_n
        q = sums(mean, True)
        c = c0 + np.arange(rows)
        ah = np.float32(1) / np.sqrt(q[0] * inv_n + EPS) * scale[0][c]
        bh = scale[1][c] - mean[0] * ah
        z = vals[0] * ah[:, None, None] + bh[:, None, None]
        with np.errstate(over="ignore"):  # exp(-z) = inf: swish -> -0, sigmoid -> 0
            if gated:
                ag = np.float32(1) / np.sqrt(q[1] * inv_n + EPS) * scale[2][c]
                bg = scale[3][c] - mean[1] * ag
                gz = vals[1] * ag[:, None, None] + bg[:, None, None]
                z = z * (np.float32(1) / (np.float32(1) + np.exp(-gz)))
            elif kernel == "in_swish":
                z = z / (np.float32(1) + np.exp(-z))
        out = np.where(valid[None], z, np.float32(0))
        yr = (b * C + c) * S                     # T* yr = y + ((size_t)b * C + c) * S;
        dst = (yr[:, None, None] + off[None, :, None] + k[None, None, :])[:, inside]
        if vec:
            assert ((y_addr + (yr[:, None] + off[None]) * esize) % VEC_BYTES == 0).all()
        y[dst] = _round(out[:, inside], x.dtype)
        np.add.at(written, dst, 1)
    assert (written == 1).all(), "an output written twice or not at all"
    shape = (B, C) + tuple(x.shape[2:])
    return torch.from_numpy(y.reshape(shape)).to(x.dtype), p


def _inputs(kernel, shape, dtype, seed):
    rs = np.random.RandomState(seed)
    A = 2 if kernel == "in_glu" else 1
    B, C = shape[:2]
    x = torch.from_numpy((rs.randn(B, A * C, *shape[2:]) * 2.0 + 0.5).astype(np.float32))
    vecs = [torch.from_numpy((rs.rand(C) + 0.5).astype(np.float32)) for _ in range(2 * A)]
    return x.to(dtype), vecs


PLAIN = {"in_glu": instance_norm_glu_plain, "in": instance_norm_plain,
         "in_swish": instance_norm_swish_plain}

# The card tests' shapes (tests/test_torch_port_cuda.py, SHAPES, as (B, C,
# *spatial) of the output), odd W and S % V != 0 among them, a row group
# that ends inside a block (C = 133 at 8 rows a block), and many short rows
# with a ragged unit at each line's end.
SHAPES = [(3, 5, 7), (2, 3, 4, 9), (1, 5120, 112), (2, 6, 1030), (1, 256, 40, 224),
          (2, 133, 9), (4, 7, 2, 16), (4, 600, 3, 20)]


def _lengths(B, W):
    """0, 1 and W valid frames, and one that cuts a unit."""
    return [[0, 1, W, W // 2 + 1][(b + B) % 4] for b in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_maps(kernel, shape, dtype):
    """Every output written once, from staged elements only, within the
    card tests' tolerance of the plain version: unmasked, with lengths of
    0, 1, W and W // 2 + 1, and from a tensor 4 bytes off a 16-byte
    boundary, whose launch reads the same values by scalar accesses and
    gives the same bits. The short rows also as a card of one SM would
    plan them: the fewest threads a row, several units each, and the most
    rows a block."""
    x, vecs = _inputs(kernel, shape, dtype, sum(shape))
    tol = TOL if dtype == torch.float32 else ONE_BF16
    lengths = torch.tensor(_lengths(shape[0], shape[-1]), dtype=torch.int32)
    runs = [(None, 0, SM_COUNT), (lengths, 0, SM_COUNT), (lengths, 4, SM_COUNT)]
    if x.numel() < 1 << 20:
        runs.append((lengths, 0, 1))
    for lens, lead, sms in runs:
        got, p = emulate(kernel, x, vecs, lens, lead, sms)
        assert p["route"] == "bulk" and (lead == 0 or not p["vec"])
        want = PLAIN[kernel](x, *vecs, lens)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if lens is not None:
            assert not got[(lens == 0).nonzero()[:, 0]].any()
            if lead:
                assert torch.equal(got, aligned)
            aligned = got


@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_route(kernel, dtype):
    """A row one element past a block's shared memory (W odd, so scalar
    accesses) streams from device memory, with the same maps; a row of
    exactly the limit's bytes is bulk-copied."""
    A = 2 if kernel == "in_glu" else 1
    esize = torch.finfo(dtype).bits // 8
    S = SMEM_LIMIT // (A * esize)
    assert A * S * esize == SMEM_LIMIT
    assert plan(4096, 8192, 1, 1, S, S, esize, A)["route"] == "bulk"
    x, vecs = _inputs(kernel, (1, 1, S + 1), dtype, 3)
    lengths = torch.tensor([S - 6], dtype=torch.int32)
    for lens in (None, lengths):
        got, p = emulate(kernel, x, vecs, lens)
        assert p["route"] == "stream" and not p["vec"] and p["smem"] == 0
        want = PLAIN[kernel](x, *vecs, lens)
        torch.testing.assert_close(got.float(), want.float(),
                                   **(TOL if dtype == torch.float32 else ONE_BF16))


# The main path's K1, K2 and K3 sites (input shapes), per step at 32 x 128
# and 1 x 64 (K2 at batch 1, 2 and 3: the pair forwards), and the 448-frame
# conversion bucket's K1 and K2 sites.
MAIN_SITES = {
    "in_glu": [(32, 512, 40, 64), (32, 512, 20, 32), (32, 1024, 32),
               (1, 512, 40, 32), (1, 512, 20, 16), (1, 1024, 16),
               (1, 512, 40, 224), (1, 512, 20, 112), (1, 1024, 112)],
    "in": [(32, 256, 32), (32, 5120, 32),
           (1, 256, 16), (1, 5120, 16), (2, 256, 16), (2, 5120, 16), (3, 256, 16),
           (3, 5120, 16),
           (1, 256, 112), (1, 5120, 112)],
    "in_swish": [(32, 256, 40, 64), (32, 512, 20, 32), (32, 1024, 10, 16),
                 (1, 256, 40, 32), (1, 512, 20, 16), (1, 1024, 10, 8)],
}


@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("esize", [4, 2])
def test_main_path_sites_take_the_bulk_route(kernel, esize):
    """Every main-path site is bulk-copied with 16-byte accesses, its
    block's shared memory within what an SM holds, and at most
    kThreadsPerSM threads an SM resident; an f32 K1 row of a conversion
    bucket past 1446 frames streams, and a K2 row only past 57,856 f32
    elements. K2's rows of 32 frames (32 x 128) are 8 f32 or 4 bf16 units,
    to a group of 4 lanes; those of 16 frames (1 x 64) 4 or 2 units; a
    448-frame conversion's rows of 112, 28 or 14 units."""
    A = 2 if kernel == "in_glu" else 1
    for shape in MAIN_SITES[kernel]:
        B, C, W = shape[0], shape[1] // A, shape[-1]
        S = int(np.prod(shape[2:]))
        p = plan(0, 0, B, C, S, W, esize, A)
        assert p["route"] == "bulk" and p["vec"], (shape, p)
        assert p["threads"] % 32 == 0 and p["threads"] <= MAX_THREADS
        assert p["smem"] + BLOCK_RESERVE + STATIC_SMEM <= SMEM_PER_SM
        if kernel == "in":
            assert p["gt"] <= 32 and p["gt"] * GROUP_UNITS >= S * esize // VEC_BYTES
    if kernel == "in_glu":
        for frames, route in ((1440, "bulk"), (1456, "stream")):
            p = plan(0, 0, 1, 256, 40 * frames // 2, frames // 2, esize, 2)
            assert p["route"] == (route if esize == 4 else "bulk")
    if kernel == "in":
        limit = SMEM_LIMIT // esize
        assert plan(0, 0, 1, 5120, limit, limit, esize, 1)["route"] == "bulk"
        assert plan(0, 0, 1, 5120, limit + 4, limit + 4, esize, 1)["route"] == "stream"
        if esize == 4:
            assert limit == 57856


@pytest.mark.parametrize("shape", [(2, 7, 13), (1, 3, 5, 3), (3, 256, 31)])
@pytest.mark.parametrize("lead", [0, 2, 6])
def test_k2_bf16_rows_of_odd_length(shape, lead):
    """K2 in bf16 with S odd: every row after the first starts off a
    16-byte boundary, so each block's run is bulk-copied between its
    boundaries with a head and a tail copied by the threads, and every unit
    takes scalar accesses; the output is the plain version's within one
    bf16 rounding, unmasked and masked, and the same bits from a tensor
    that starts 2 or 6 bytes off a boundary."""
    x, vecs = _inputs("in", shape, torch.bfloat16, 7)
    assert int(np.prod(shape[2:])) % 2 == 1
    lengths = torch.tensor(_lengths(shape[0], shape[-1]), dtype=torch.int32)
    for lens in (None, lengths):
        got, p = emulate("in", x, vecs, lens, lead)
        assert p["route"] == "bulk" and not p["vec"]
        torch.testing.assert_close(got.float(), instance_norm_plain(x, *vecs, lens).float(),
                                   **ONE_BF16)
        if lead:
            assert torch.equal(got, emulate("in", x, vecs, lens, 0)[0])


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("count", [1, 2])
def test_stage_copies_each_element_once(esize, count):
    """Every lead (the run's start modulo 16 bytes) and lengths around a
    16-byte unit: each element lands once at its own offset, congruent to
    its source modulo 16 bytes, the bulk part aligned at both ends and
    inside its array, within the plan's bound for any block's lead."""
    for lead in range(0, VEC_BYTES, esize):
        for n in (1, 2, 3, VEC_BYTES // esize - 1, VEC_BYTES // esize, 37, 160):
            # K1's g run starts C*S elements after its h run: C = 3 here
            addrs = [4096 + lead, 4096 + lead + 3 * n * esize][:count]
            memory = np.arange(4096 + 4 * n * esize, dtype=np.float32)
            pairs = [(a, (a - 4096) // esize) for a in addrs]
            smem_bytes = count * staged_max(4096 + lead, n * esize, n * esize)
            smem, starts = emulate_stage(smem_bytes, pairs, n, esize, memory)
            for (addr, src), dst in zip(pairs, starts):
                assert (dst * esize - addr) % VEC_BYTES == 0
                np.testing.assert_array_equal(smem[dst:dst + n], memory[src:src + n])


def test_group_sum_tree():
    """group_sum: each group of gt lanes (or the whole block) receives its
    own total."""
    rs = np.random.RandomState(0)
    for gt, threads in ((4, 32), (8, 64), (16, 256), (32, 96), (96, 96), (512, 512)):
        v = rs.randn(2, threads).astype(np.float32)
        got = group_sum(v, gt, threads)
        want = np.repeat(v.reshape(2, threads // gt, gt).sum(-1), gt, axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
