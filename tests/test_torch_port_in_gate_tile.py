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

from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm_backward_plain,
    instance_norm_glu_backward_plain,
    instance_norm_glu_plain,
    instance_norm_plain,
    instance_norm_swish_backward_plain,
    instance_norm_swish_plain,
)
from portbench import names

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
    "p.vec = W % V == 0 && aligned16(x) && aligned16(y) && (!dy || aligned16(dy));",
    "while (p.gt * kGroupUnits < nU && p.gt < 32) p.gt <<= 1;",
    "while (p.gt < 32 && p.gt < nU &&",
    "(size_t)B * C * p.gt * 2 <= (size_t)sm_count() * kThreadsPerSM)",
    "const int least = 32 / p.gt;  // a block is whole warps",
    "per_block = kGroupBlockThreads / p.gt;",
    "(size_t)B * ((C + per_block - 1) / per_block) < (size_t)sm_count())",
    "per_block >>= 1;",
    "p.threads = per_block * p.gt;",
    "p.smem = staged_rows(x, dy, arrays, per_block, row);",
    "return arrays * staged_max(x, rows * row, row) + (dy ? staged_max(dy, rows * row, row) : 0);",
    "const size_t bytes = staged_rows(x, dy, arrays, 1, row);",
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


# The backward's expressions (in_backward_kernel), each verbatim.
BACKWARD_FORMULAS = [
    "const Plan p = plan(x, dy, dx, B, C, S, W, sizeof(T), kEpilogue == kGlu ? 2 : 1);",
    "const Plan p = plan(x, nullptr, y, B, C, S, W, sizeof(T), kEpilogue == kGlu ? 2 : 1);",
    "src[A] = dy + ((size_t)b * C + c0) * S;",
    "stage<A + 1>(dyn, src, rows * S, run, &bar);",
    "for (int a = 0; a < A; ++a) row[a] = run[a] + (size_t)j * S;",
    "const T* dyr = run[A] + (size_t)j * S;",
    "const float inv_n = 1.f / (float)S;",
    "if (live) unit_sums<kVec, false>(row, start, t, gt, nU, nW, W, W, zero, m);",
    "if (live) unit_sums<kVec, true>(row, start, t, gt, nU, nW, W, W, m, q);",
    "group_sum(q, gt, red + 2 * A * 32);",
    "for (int a = 0; a < A; ++a) inv[a] = rsqrtf(q[a] * inv_n + kEps);",
    "ah = inv[0] * scale_h[c];",
    "if constexpr (kEpilogue != kNone) bh = bias_h[c];",
    "ag = inv[1] * scale_g[c];",
    "bg = bias_g[c];",
    "const float ch = h[k] - m[0], cg = kGated ? g[k] - m[A - 1] : 0.f;",
    "const float z = __fmaf_rn(ch, ah, bh), s = sigmoid(z);",
    "return __fmul_rn(d, __fmaf_rn(__fmul_rn(z, s), __fsub_rn(1.f, s), s));",
    "const float s = sigmoid(__fmaf_rn(cg, ag, bg)), yh = __fmaf_rn(ch, ah, bh);",
    "dzg = __fmul_rn(__fmul_rn(__fmul_rn(d, yh), s), __fsub_rn(1.f, s));",
    "return __fmul_rn(d, s);",
    "if (!kVec && k >= n) break;  // past a ragged unit's end: w >= W",
    "sums[0] += dzh * ch;",
    "sums[1] += dzh;",
    "sums[2] += dzg * cg;",
    "sums[3] += dzg;",
    "group_sum(sums, gt, red);",
    "const size_t bc = (size_t)B * C, at = (size_t)b * C + c;",
    "const float dsc = inv[a] * sums[2 * a];",
    "part[2 * a * bc + at] = dsc;",
    "part[(2 * a + 1) * bc + at] = sums[2 * a + 1];",
    "mdz[a] = sums[2 * a + 1] * inv_n;",
    "kx[a] = inv[a] * dsc * inv_n;",
    "T* dxr = dx + ((size_t)b * A * C + c) * S;",
    "oh[k] = ah * (dzh - mdz[0] - ch * kx[0]);",
    "if constexpr (kGated) og[k] = ag * (dzg - mdz[A - 1] - cg * kx[A - 1]);",
    "store_unit<kVec>(dxr + off, n, oh);",
    "if constexpr (kGated) store_unit<kVec>(dxr + (size_t)C * S + off, n, og);",
]


def test_formulas_are_the_kernels():
    for f in FORMULAS + BACKWARD_FORMULAS:
        assert f in SOURCE, f"not in csrc/in_gate.cu: {f}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def staged_bytes(addr: int, nbytes: int) -> int:
    return (addr % VEC_BYTES + nbytes + VEC_BYTES - 1) // VEC_BYTES * VEC_BYTES


def staged_max(addr: int, nbytes: int, stride: int) -> int:
    return max(staged_bytes(addr + k * stride, nbytes) for k in range(VEC_BYTES))


def staged_rows(x_addr, dy_addr, arrays, rows, row):
    """``staged_rows``: dy_addr None for a forward."""
    return arrays * staged_max(x_addr, rows * row, row) + (
        0 if dy_addr is None else staged_max(dy_addr, rows * row, row))


def plan(x_addr, y_addr, B, C, S, W, esize, arrays, sm_count=SM_COUNT, dy_addr=None):
    """``plan`` of in_gate.cu for x and y (a backward's dx) at the byte
    addresses given, and a backward's dy (None for a forward), on a card
    of ``sm_count`` SMs."""
    V = VEC_BYTES // esize
    nU = (S // W) * _cdiv(W, V)
    row = S * esize
    p = dict(route="bulk", vec=W % V == 0 and x_addr % VEC_BYTES == 0 and y_addr % VEC_BYTES == 0
             and (dy_addr is None or dy_addr % VEC_BYTES == 0))
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
                 smem=staged_rows(x_addr, dy_addr, arrays, per_block, row))
    else:
        nbytes = staged_rows(x_addr, dy_addr, arrays, 1, row)
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


def unit_maps(gt, H, W, V, vec):
    """Every unit of a row, as the threads' walks reach it: (nU, w0, n,
    off, k, inside, idx), with idx the row offset of each of a unit's V
    slots (its first element's past the unit's n elements)."""
    nW = _cdiv(W, V); nU = H * nW            # const int nW = (W + V - 1) / V, nU = H * nW;
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
    return nU, w0, n, off, k, inside, idx


def load_rows(buf, starts, buf_addr, rows, S, units, esize, vec):
    """Each run's ``rows`` rows, unit by unit, from ``buf`` (shared memory
    or, streaming, device memory): (rows, nU, V) f32 per run, zeros past a
    unit's end. A load of an element the stage never wrote fails, and with
    ``vec`` every unit's address must be 16-byte aligned."""
    _, _, _, off, _, inside, idx = units
    out = []
    for a, start in enumerate(starts):
        row0 = start + np.arange(rows) * S       # row[a] += (size_t)j * S;
        v = buf[row0[:, None, None] + idx[None]]
        assert not np.isnan(v[:, inside]).any(), "read shared memory the stage never wrote"
        if vec:
            assert ((buf_addr[a] + (row0[:, None] - start + off[None]) * esize)
                    % VEC_BYTES == 0).all()
        out.append(np.where(inside[None], v, np.float32(0)).astype(np.float32))
    return out


def thread_sums(terms, gt, threads):
    """``unit_sums`` and ``group_sum``: each thread's sum of ``terms`` (K,
    rows, nU, V; zero where no element counts) over its units u = t, t +
    gt, ..., then over its group: (K, rows), as thread j*gt of each row
    receives it."""
    K, rows, nU, _ = terms.shape
    m_units = _cdiv(nU, gt)                  # units of a thread, at most
    part = np.zeros((K, threads), np.float32)
    for a in range(K):
        per_unit = np.zeros((rows, m_units * gt), np.float32)
        per_unit[:, :nU] = terms[a].sum(-1, dtype=np.float32)
        part[a, :rows * gt] = per_unit.reshape(rows, m_units, gt).sum(
            1, dtype=np.float32).reshape(-1)
    total = group_sum(part, gt, threads)
    return total[:, np.arange(rows) * gt]


def _sigmoid(v):
    with np.errstate(over="ignore"):  # exp(-v) = inf: 0
        return np.float32(1) / (np.float32(1) + np.exp(-v))


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
    units = unit_maps(gt, H, W, V, vec)
    w0, off, k, inside = units[1], units[3], units[4], units[5]
    R = threads // gt                        # const int R = blockDim.x / gt;
    groups = _cdiv(C, R)                     # const int groups = (C + R - 1) / R;
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
        vals = load_rows(buf, starts, buf_addr, rows, S, units, esize, vec)

        def sums(center, square):
            """h and g together, over the valid columns."""
            d = [vals[a] - center[a][:, None, None] for a in range(A)]
            return thread_sums(np.stack([np.where(valid[None], t * t if square else t,
                                                  np.float32(0)) for t in d]), gt, threads)

        zero = [np.zeros(rows, np.float32)] * A
        mean = sums(zero, False) * inv_n         # m[a] *= inv_n
        q = sums(mean, True)
        c = c0 + np.arange(rows)
        ah = np.float32(1) / np.sqrt(q[0] * inv_n + EPS) * scale[0][c]
        bh = scale[1][c] - mean[0] * ah
        z = vals[0] * ah[:, None, None] + bh[:, None, None]
        if gated:
            ag = np.float32(1) / np.sqrt(q[1] * inv_n + EPS) * scale[2][c]
            bg = scale[3][c] - mean[1] * ag
            z = z * _sigmoid(vals[1] * ag[:, None, None] + bg[:, None, None])
        elif kernel == "in_swish":
            with np.errstate(over="ignore"):  # exp(-z) = inf: swish -> -0
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


def emulate_backward(kernel, x, dy, vecs, lead=0, dy_lead=0, sm_count=SM_COUNT):
    """One launch of ``in_backward_kernel``, every block of its grid, with x
    and dy at byte addresses ``lead`` and ``dy_lead`` past a 16-byte
    boundary (dx and the partials aligned, as ``torch.empty`` gives them),
    then the wrapper's sum of the (2A, B, C) partials over the batch.
    Returns (dx, dscale, dbias[, dscale_g, dbias_g]) and the plan."""
    gated = kernel == "in_glu"
    A = 2 if gated else 1
    B, W = x.shape[0], x.shape[-1]
    C = x.shape[1] // A
    S = int(np.prod(x.shape[2:]))
    H = S // W
    esize = x.element_size()
    V = VEC_BYTES // esize
    x_addr, dy_addr, dx_addr = 4096 + lead, (1 << 26) + dy_lead, 1 << 20
    p = plan(x_addr, dx_addr, B, C, S, W, esize, A, sm_count, dy_addr)
    vec, gt, threads = p["vec"], p["gt"], p["threads"]
    memory = np.concatenate([x.float().numpy().reshape(-1), dy.float().numpy().reshape(-1)])
    dy0 = x.numel()                          # dy's first element in ``memory``
    dx = np.full(x.numel(), np.nan, np.float32)
    part = np.full(2 * A * B * C, np.nan, np.float32)
    written, part_written = np.zeros(dx.size, int), np.zeros(part.size, int)
    units = unit_maps(gt, H, W, V, vec)
    off, k, inside = units[3], units[4], units[5]
    R = threads // gt
    groups = _cdiv(C, R)
    vec32 = [v.numpy().astype(np.float32) for v in vecs]
    inv_n = np.float32(1) / np.float32(S)    # const float inv_n = 1.f / (float)S;
    for blk in range(p["blocks"]):
        b = blk // groups
        c0 = (blk - b * groups) * R
        rows = min(R, C - c0)
        src = [(b * A * C + c0) * S]         # src[0] = x + ((size_t)b * A * C + c0) * S;
        if gated:
            src.append(src[0] + C * S)
        src.append(dy0 + (b * C + c0) * S)   # src[A] = dy + ((size_t)b * C + c0) * S;
        addrs = [x_addr + s * esize for s in src[:A]] + [dy_addr + (src[A] - dy0) * esize]
        if p["route"] == "stream":
            buf, starts, buf_addr = memory, src, addrs
        else:                                # stage<A + 1>(dyn, src, rows * S, run, &bar);
            buf, starts = emulate_stage(p["smem"], list(zip(addrs, src)), rows * S, esize, memory)
            buf_addr = [d * esize for d in starts]
        vals = load_rows(buf, starts, buf_addr, rows, S, units, esize, vec)
        d = vals[A]
        inn = inside[None]
        mean = thread_sums(np.stack([np.where(inn, vals[a], np.float32(0)) for a in range(A)]),
                           gt, threads) * inv_n
        cen = [vals[a] - mean[a][:, None, None] for a in range(A)]
        q = thread_sums(np.stack([np.where(inn, t * t, np.float32(0)) for t in cen]), gt,
                        threads)
        inv = np.float32(1) / np.sqrt(q * inv_n + EPS)  # inv[a] = rsqrtf(q[a] * inv_n + kEps);
        c = c0 + np.arange(rows)
        a_of = [inv[a] * vec32[2 * a][c] for a in range(A)]  # ah = inv[0] * scale_h[c];
        ah, bh = a_of[0][:, None, None], vec32[1][c][:, None, None]
        if kernel == "in":
            dz = [d]                         # return d;
        elif kernel == "in_swish":
            z = cen[0] * ah + bh             # z = __fmaf_rn(ch, ah, bh), s = sigmoid(z);
            s = _sigmoid(z)                  # d * fma(z * s, 1 - s, s)
            dz = [d * (z * s * (np.float32(1) - s) + s)]
        else:
            ag, bg = a_of[1][:, None, None], vec32[3][c][:, None, None]
            s = _sigmoid(cen[1] * ag + bg)   # s = sigmoid(__fmaf_rn(cg, ag, bg))
            dz = [d * s, d * (cen[0] * ah + bh) * s * (np.float32(1) - s)]
        terms = []
        for a in range(A):                   # sums[0] += dzh * ch; sums[1] += dzh;
            terms += [np.where(inn, dz[a] * cen[a], np.float32(0)), np.where(inn, dz[a], 0)]
        sums = thread_sums(np.stack(terms).astype(np.float32), gt, threads)
        at = b * C + c                       # at = (size_t)b * C + c
        for a in range(A):
            dsc = inv[a] * sums[2 * a]       # const float dsc = inv[a] * sums[2 * a];
            for i, v in ((2 * a, dsc), (2 * a + 1, sums[2 * a + 1])):
                part[i * B * C + at] = v     # part[2 * a * bc + at] = dsc; ...
                np.add.at(part_written, i * B * C + at, 1)
            mdz = sums[2 * a + 1] * inv_n    # mdz[a] = sums[2 * a + 1] * inv_n;
            kx = inv[a] * dsc * inv_n        # kx[a] = inv[a] * dsc * inv_n;
            out = a_of[a][:, None, None] * (dz[a] - mdz[:, None, None]
                                            - cen[a] * kx[:, None, None])
            dxr = (b * A * C + c) * S + a * C * S  # dxr + (size_t)C * S for g
            dst = (dxr[:, None, None] + off[None, :, None] + k[None, None, :])[:, inside]
            if vec:
                assert ((dx_addr + (dxr[:, None] + off[None]) * esize) % VEC_BYTES == 0).all()
            dx[dst] = _round(out[:, inside], x.dtype)
            np.add.at(written, dst, 1)
    assert (written == 1).all(), "an element of dx written twice or not at all"
    assert (part_written == 1).all(), "a partial written twice or not at all"
    part = torch.from_numpy(part.reshape(2 * A, B, C))
    got = (torch.from_numpy(dx.reshape(x.shape)).to(x.dtype),
           *(part[:, 0] if B == 1 else part.sum(1)))
    return got, p


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


# ---------- the backwards: in_backward_kernel ----------

PLAIN_BACKWARD = {"in_glu": instance_norm_glu_backward_plain, "in": instance_norm_backward_plain,
                  "in_swish": instance_norm_swish_backward_plain}


def _backward_inputs(kernel, shape, dtype, seed):
    """x of the forward's output ``shape`` (K1: 2C channels), its vectors
    (scales in [0.5, 1.5), biases in [-1, 1)) and dy, in ``dtype``."""
    rs = np.random.RandomState(seed)
    A = 2 if kernel == "in_glu" else 1
    B, C = shape[:2]
    x = torch.from_numpy((rs.randn(B, A * C, *shape[2:]) * 2.0 + 0.5).astype(np.float32))
    vecs = [torch.from_numpy((rs.rand(C) + (0.5 if i % 2 == 0 else -0.5)).astype(np.float32)
                             * (1 if i % 2 == 0 else 2)) for i in range(2 * A)]
    dy = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    return x.to(dtype), vecs, dy.to(dtype)


def _backward_bounds(kernel, x, dy, vecs):
    """1e-5 of sum |dz| (1 + |xhat|) per channel, for each (dscale, dbias)
    output: their sums run in another order than the plain formulas'."""
    A = 2 if kernel == "in_glu" else 1
    xs = x.float().reshape(x.shape[0], x.shape[1], -1)
    hat = (xs - xs.mean(-1, keepdim=True)) * torch.rsqrt(
        xs.var(-1, unbiased=False, keepdim=True) + 1e-5)
    d = dy.float().reshape(dy.shape[0], dy.shape[1], -1)
    hats = hat.split(d.shape[1], dim=1)
    z = [hats[a] * vecs[2 * a][:, None] + vecs[2 * a + 1][:, None] for a in range(A)]
    if kernel == "in":
        dz = [d]
    elif kernel == "in_swish":
        s = torch.sigmoid(z[0])
        dz = [d * (s + z[0] * s * (1 - s))]
    else:
        s = torch.sigmoid(z[1])
        dz = [d * s, d * z[0] * s * (1 - s)]
    return [1e-5 * (dz[a].abs() * (1 + hats[a].abs())).sum((0, 2)) for a in range(A)
            for _ in range(2)]


def _check_backward(kernel, x, dy, vecs, got):
    want = PLAIN_BACKWARD[kernel](x, dy, *vecs)
    assert got[0].dtype == want[0].dtype == x.dtype
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **(TOL if x.dtype == torch.float32 else ONE_BF16))
    for g, w, bound in zip(got[1:], want[1:], _backward_bounds(kernel, x, dy, vecs)):
        assert ((g - w).abs() <= bound).all(), ((g - w).abs() / bound).max().item()


# Output shapes (B, C, *spatial): odd W and S % V != 0, a row group that
# ends inside a block (C = 133), many short rows, rows of one element and
# a whole-block row.
BACKWARD_SHAPES = [(3, 5, 7), (2, 3, 4, 9), (2, 6, 1030), (2, 133, 9), (4, 7, 2, 16),
                   (1, 4, 1, 1), (2, 64, 20, 16), (1, 16, 40, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_backward_maps(kernel, shape, dtype):
    """Every element of dx and every partial written once, from staged
    elements only, within the plain backward's tolerance: x and dy aligned,
    x 4 bytes and dy 2 or 4 bytes off a boundary (scalar accesses, the same
    bits), and as a card of one SM would plan the small shapes."""
    x, vecs, dy = _backward_inputs(kernel, shape, dtype, sum(shape) + 1)
    got, p = emulate_backward(kernel, x, dy, vecs)
    assert p["route"] == "bulk"
    _check_backward(kernel, x, dy, vecs, got)
    shifted, p = emulate_backward(kernel, x, dy, vecs, 4, x.element_size())
    assert p["route"] == "bulk" and not p["vec"]
    assert all(torch.equal(a, b) for a, b in zip(got, shifted))
    if x.numel() < 1 << 16:
        one_sm, _ = emulate_backward(kernel, x, dy, vecs, sm_count=1)
        _check_backward(kernel, x, dy, vecs, one_sm)


@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_streaming_route(kernel, dtype):
    """A row whose x and dy rows together pass a block's shared memory
    (W odd: scalar accesses) streams from device memory, with the same
    maps; one 64 bytes an array inside it is bulk-copied."""
    A = 2 if kernel == "in_glu" else 1
    esize = torch.finfo(dtype).bits // 8
    S = SMEM_LIMIT // ((A + 1) * esize)
    assert plan(4096, 8192, 1, 1, S - 64 // esize, S - 64 // esize, esize, A,
                dy_addr=1 << 20)["route"] == "bulk"
    x, vecs, dy = _backward_inputs(kernel, (1, 1, S + 1 + S % 2), dtype, 5)
    got, p = emulate_backward(kernel, x, dy, vecs)
    assert p["route"] == "stream" and not p["vec"] and p["smem"] == 0
    _check_backward(kernel, x, dy, vecs, got)


# The backward sites of a training step (the forwards with grad): at 1 x 64
# (pair_forwards: G at batch 1, 2 and 3, D at 1 and 2), at 32 x 128, and a
# 1 x 320 step's largest (K1's downSample1 input, 76.8 KB of f32 x and dy
# a row).
BACKWARD_SITES = {
    "in_glu": [(B, 512, 40, 32) for B in (1, 2, 3)] + [(B, 512, 20, 16) for B in (1, 2, 3)]
              + [(B, 1024, 16) for B in (1, 2, 3)]
              + [(32, 512, 40, 64), (32, 512, 20, 32), (32, 1024, 32), (1, 512, 40, 160)],
    "in": [(B, C, 16) for B in (1, 2, 3) for C in (256, 5120)] + [(32, 256, 32), (32, 5120, 32)],
    "in_swish": [(B, 256, 40, 32) for B in (1, 2)] + [(B, 512, 20, 16) for B in (1, 2)]
                + [(B, 1024, 10, 8) for B in (1, 2)]
                + [(32, 256, 40, 64), (32, 512, 20, 32), (32, 1024, 10, 16)],
}


@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("esize", [4, 2])
def test_backward_main_path_sites_take_the_bulk_route(kernel, esize):
    """Every backward site of the main path stages x and dy with 16-byte
    accesses, its block's shared memory within what an SM holds; the
    1 x 320 step's K1 site takes 76.8 KB in f32."""
    A = 2 if kernel == "in_glu" else 1
    for shape in BACKWARD_SITES[kernel]:
        B, C, W = shape[0], shape[1] // A, shape[-1]
        S = int(np.prod(shape[2:]))
        p = plan(0, 0, B, C, S, W, esize, A, dy_addr=0)
        assert p["route"] == "bulk" and p["vec"], (shape, p)
        assert p["threads"] % 32 == 0 and p["threads"] <= MAX_THREADS
        assert p["smem"] + BLOCK_RESERVE + STATIC_SMEM <= SMEM_PER_SM
        if shape == (1, 512, 40, 160):
            assert p["smem"] == 3 * 6400 * esize


def _global_kernels():
    """(name, [parameter types]) of each __global__ template of in_gate.cu."""
    found = re.findall(r"__global__ void __launch_bounds__\(kMaxThreads\)\s*(\w+)\(([^)]*)\)",
                       SOURCE)
    out = []
    for name, params in found:
        types = []
        for p in params.split(","):
            t = re.sub(r"__restrict__|\b\w+\s*$", "", " ".join(p.split())).strip()
            t = re.sub(r"^const (\w+)\s*\*", r"\1 const*", t)
            types.append(t.replace(" *", "*"))
        out.append((name, types))
    return out


def _trace_names(name, types):
    """The names a trace may give every instance of the template ``name``:
    T f32 or bf16, each epilogue, each route and access width, the enum
    printed by value or by name, with the demangled parameter list."""
    names = []
    for T in ("float", "__nv_bfloat16"):
        args = ", ".join(t.replace("T", T) if re.fullmatch(r"T(?: const)?\*", t) else t
                         for t in types)
        for value, enum in ((0, "kNone"), (1, "kSwish"), (2, "kGlu")):
            for ep in (f"(<unnamed>::Epilogue){value}", f"(Epilogue){value}",
                       f"(anonymous namespace)::{enum}"):
                for stream in ("false", "true"):
                    for vec in ("false", "true"):
                        names.append((enum, f"void (anonymous namespace)::{name}<{T}, {ep}, "
                                            f"{stream}, {vec}>({args})"))
    return names


def test_kernel_names_keep_their_groups():
    """In the benchmark's name table (``portbench/names.py``), each
    instance of the forwards' template matches its own K1, K2 or K3
    pattern and no other, and each instance of the backwards' template
    falls in the eager group and matches no kernel pattern; the port's own
    table (``obs.profiler.KERNEL_NAMES``) names each by its ENTRIES key."""
    kernels = dict(_global_kernels())
    assert sorted(kernels) == ["in_backward_kernel", "in_staged_kernel"]
    own = {"kNone": "in", "kSwish": "in_swish", "kGlu": "in_glu"}
    for name, types in kernels.items():
        assert "T const*" in types and all("__restrict__" not in t for t in types)
        for enum, trace_name in _trace_names(name, types):
            matched = [k for k, pat in names.KERNEL_NAMES.items() if re.search(pat, trace_name)]
            mine = [k for k, pat in profiler.KERNEL_NAMES.items() if re.search(pat, trace_name)]
            if name == "in_staged_kernel":
                assert matched == [own[enum]] and names.group(trace_name) == "kernels", trace_name
                assert mine == [own[enum]], trace_name
            else:
                assert matched == [] and names.group(trace_name) == "eager", trace_name
                assert mine == [f"{own[enum]}_bwd"], trace_name
