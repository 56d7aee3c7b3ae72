"""The maps of K8 (``csrc/melspec.cu``, ``log_mel_kernel``), emulated on the CPU.

A cluster of 8 thread blocks takes one (batch, tile of 32 frames); block
``rank`` takes 68 bins, 17 n8 tiles of 8 columns: the 4 bins' cos columns
(from ``wc``), then their sin columns (from ``ws``). The tile's audio span
is copied into shared memory at a padded row stride, each chunk of the
block's bins of the bases by two bulk copies of the TMA into a ring; the
DFT runs as
3xTF32 ``mma.sync.m16n8k8`` products, two warps on the same units, each
over half of every chunk's k-steps into zeroed partials, their sums
meeting at the end; lanes t and t ^ 2 trade one row of each accumulator so
that each holds
re and im of two bins of one frame; the magnitudes go to shared memory,
each block projects its bins onto the 80 filters, and block ``rank`` sums
the cluster's 8 partials of its 320 outputs in rank order.

This file mirrors those maps in numpy, each beside the ``.cu`` expression
it copies (``FORMULAS``, checked to appear in the source verbatim), with
every shared-memory array tracked element by element: a read of an element
that no copy wrote fails, and so does an output written twice or not at
all. The splits into TF32 hi and lo are emulated bit for bit (the audio's
by integer rounding, NaN kept in hi; the bases come split from
``kernel_constants``); each warp's share of every
kFlushChunks chunks is summed exactly and rounded once to f32 (the tensor
cores' own summation order is not emulated). Each emulated launch is held
against JAX's ``log_mel_spectrogram_pallas(..., interpret=True)`` at the
JAX package's own frontend tolerance, atol 1e-5 in log10 units, at T = 1,
31, 32, 33 and 576. The constants are read from the ``.cu``. The card
tests (``tests/test_torch_port_cuda.py``) hold the kernel itself.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.ops.pallas.melspec_kernel import log_mel_spectrogram_pallas
from maskcyclegan_vc_tpu_torch.ops.melspec import kernel_constants, log_mel_spectrogram_plain

CU = Path(__file__).resolve().parents[1] / "maskcyclegan_vc_tpu_torch" / "csrc" / "melspec.cu"
SOURCE = CU.read_text()


def _constants() -> dict:
    """Every ``constexpr int`` of the .cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE):
        env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


K = _constants()
N_FFT, HOP, MELS = K["kNFft"], K["kHop"], K["kMels"]
CLUSTER, SLICE, BINS_PAD = K["kCluster"], K["kSliceBins"], K["kBinsPad"]
TILES, FRAMES = K["kTiles"], K["kFrames"]
COLS = 8 * TILES                                 # a block's columns of B
RUN, SIN, CHUNK_FLOATS = K["kRunFloats"], K["kSinOffset"], K["kChunkFloats"]
SPAN_ROWS, RS = K["kSpanRows"], K["kSpanStride"]
THREADS, WARPS_N, GROUPS_K, UNITS = K["kThreads"], K["kWarpsN"], K["kGroupsK"], K["kUnits"]
STEPS, FLUSH = K["kStepsPerGroup"], K["kFlushChunks"]
CHUNK, CHUNKS, PER_HOP, STAGES = K["kChunkK"], K["kChunks"], K["kChunksPerHop"], K["kStages"]
MAG_STRIDE, PART_STRIDE, PER_RANK = K["kMagStride"], K["kPartStride"], K["kPerRank"]
SPAN_FLOATS = K["kSpanFloats"]
TOL = dict(atol=1e-5, rtol=0)  # the JAX package's frontend tolerance (tests/test_pallas_melspec.py)

# The .cu expressions mirrored below, each verbatim.
FORMULAS = [
    # grid and tile
    "const dim3 grid((T + kFrames - 1) / kFrames * kCluster, B);",
    "const int t0 = (blockIdx.x / kCluster) * kFrames;",
    "const int rank = (int)cluster.block_rank();",
    # span
    "const float* a = audio + (size_t)b * L + (size_t)t0 * kHop;",
    "const int avail = L - t0 * kHop;  // samples of the span that exist",
    "if (reinterpret_cast<uintptr_t>(a) % 16 == 0) {",
    "for (int i = 4 * tid; i < kSpanRows * kHop; i += 4 * kThreads) {",
    "const int n = 4 * min(max(avail - i, 0), 4);",
    "cp_async16_fill(span + (i / kHop) * kSpanStride + i % kHop, n ? a + i : a, n);",
    "for (int i = tid; i < kSpanRows * kHop; i += kThreads)",
    "cp_async4_fill(span + (i / kHop) * kSpanStride + i % kHop, i < avail ? a + i : a,",
    "i < avail ? 4 : 0);",
    # B chunks
    "\"r\"(8 * kRunFloats)",
    "float* dst = ring + (c % kStages) * kChunkFloats;",
    "const size_t src = ((size_t)rank * kNFft + (size_t)c * kChunkK) * kSliceBins * 2;",
    "bulk_copy(dst, wc + src, 4 * kRunFloats, bar);",
    "bulk_copy(dst + kSinOffset, ws + src, 4 * kRunFloats, bar);",
    "for (int c = 0; c < kStages - 1; ++c) load_chunk(c);",
    "__syncthreads();  // chunk c - 1 done (and at c = 0 the span in)",
    "load_chunk(c + kStages - 1);",
    "wait_phase(&full[c % kStages], (c / kStages) & 1);",
    "const float* bs = ring + (c % kStages) * kChunkFloats;",
    # warps, k-steps, A fragments
    "const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;",
    "const int nw = warp % kWarpsN, kg = warp / kWarpsN;",
    "const int hop = c / kChunksPerHop, n0 = (c % kChunksPerHop) * kChunkK;",
    "const float* as = span + (g + hop) * kSpanStride + n0 + t;",
    "for (int s = 0; s < kStepsPerGroup; ++s) {",
    "const int kk = 8 * (kg * kStepsPerGroup + s);",
    "const float* p = as + 16 * mt * kSpanStride + kk;",
    "split(p[0], ah[mt][0], al[mt][0]);",
    "split(p[8 * kSpanStride], ah[mt][1], al[mt][1]);",
    "split(p[4], ah[mt][2], al[mt][2]);",
    "split(p[8 * kSpanStride + 4], ah[mt][3], al[mt][3]);",
    # B fragments and units
    "const uint2* p = reinterpret_cast<const uint2*>(bs + kSinOffset * (g >> 2)) +",
    "(kk + t) * kSliceBins + 4 * j + (g & 3);",
    "const uint2 v0 = p[0], v1 = p[4 * kSliceBins];",
    "bh[0] = v0.x, bl[0] = v0.y, bh[1] = v1.x, bl[1] = v1.y;",
    "for (int i = 0; i < 4; ++i) b_fragment(bs, kk, nw + kWarpsN * i, g, t, bh[i], bl[i]);",
    "mma_3xtf32(q, part[2 * i + mt], ah[mt], al[mt], bh[i], bl[i]);",
    "const bool extra = nw < 2;  // tile kTiles - 1 in m16 half `nw`",
    "b_fragment(bs, kk, kTiles - 1, g, t, bh[4], bl[4]);",
    "xh[r] = nw & 1 ? ah[1][r] : ah[0][r];",
    "mma_3xtf32(q, part[kUnits - 1], xh, xl, bh[4], bl[4]);",
    # the splits
    "return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;",
    "hi = isnan(v) ? __float_as_uint(v) : to_tf32(v);",
    "lo = to_tf32(v - __uint_as_float(hi));",
    "if (q == 0) mma_tf32(d, ah, bl);\n  else if (q == 1) mma_tf32(d, al, bh);\n  else mma_tf32(d, ah, bh);",
    "for (int q = 0; q < 3; ++q) {",
    "if (c % kFlushChunks == kFlushChunks - 1) {",
    "for (int r = 0; r < 4; ++r) acc[u][r] += part[u][r], part[u][r] = 0.f;",
    # the groups' sums meet
    "float* fb = ring + kXchFloats;",
    "const float* src = melT + (size_t)rank * kSliceBins * kMels;",
    "for (int i = 4 * tid; i < kSliceBins * kMels; i += 4 * kThreads) cp_async16(fb + i, src + i);",
    "const int lane_g = tid % kGroupThreads;",
    "for (int w = kGroupsK / 2; w > 0; w /= 2) {",
    "if (kg >= w && kg < 2 * w) {",
    "float* x = xch + (kg - w) * kUnits * 4 * kGroupThreads;",
    "for (int r = 0; r < 4; ++r) x[(4 * u + r) * kGroupThreads + lane_g] = acc[u][r];",
    "if (kg < w) {",
    "const float* x = xch + kg * kUnits * 4 * kGroupThreads;",
    "for (int r = 0; r < 4; ++r) acc[u][r] += x[(4 * u + r) * kGroupThreads + lane_g];",
    # magnitudes
    "const bool cos_lane = t < 2;",
    "const float r0 = __shfl_xor_sync(0xffffffffu, cos_lane ? d[2] : d[0], 2);",
    "const float r1 = __shfl_xor_sync(0xffffffffu, cos_lane ? d[3] : d[1], 2);",
    "const float re0 = cos_lane ? d[0] : r0, re1 = cos_lane ? d[1] : r1;",
    "const float im0 = cos_lane ? r0 : d[2], im1 = cos_lane ? r1 : d[3];",
    "const int f = 16 * mt + g + (cos_lane ? 0 : 8);",
    "float* m = mag + f * kMagStride + 4 * j + 2 * (t & 1);",
    "m[0] = sqrtf(re0 * re0 + im0 * im0 + 1e-24f);",
    "m[1] = sqrtf(re1 * re1 + im1 * im1 + 1e-24f);",
    "for (int mt = 0; mt < 2; ++mt) magnitudes(acc[2 * i + mt], mt, nw + kWarpsN * i, g, t, mag);",
    "if (extra) magnitudes(acc[kUnits - 1], nw, kTiles - 1, g, t, mag);",
    # the mel partial
    "float* mag = smem;                               // (kFrames, kMagStride)",
    "float* partial = smem + kFrames * kMagStride;    // (kMels, kPartStride)",
    "const int mg = tid & 15, fg = tid >> 4;",
    "for (int e = 0; e < 5; ++e) w[e] = fb[k * kMels + 5 * mg + e];",
    "for (int i = 0; i < 2; ++i) m[i] = mag[(2 * fg + i) * kMagStride + k];",
    "for (int e = 0; e < 5; ++e) s[i][e] = fmaf(m[i], w[e], s[i][e]);",
    "for (int e = 0; e < 5; ++e) partial[(5 * mg + e) * kPartStride + 2 * fg + i] = s[i][e];",
    # the cluster's reduction
    "for (int idx = rank * kPerRank + tid; idx < (rank + 1) * kPerRank; idx += kThreads) {",
    "const int m = idx / kFrames, f = idx % kFrames;",
    "for (int q = 0; q < kCluster; ++q) v += parts[q][m * kPartStride + f];",
    "if (t0 + f < T)",
    "out[((size_t)b * kMels + m) * T + t0 + f] = log10f(isnan(v) ? v : fmaxf(v, kFloor));",
]


def test_formulas_are_the_kernels():
    for f in FORMULAS:
        assert f in SOURCE, f"not in csrc/melspec.cu: {f}"


LANES = np.arange(32)
G, T_ = LANES >> 2, LANES & 3  # const int ... g = lane >> 2, t = lane & 3;
TF32_MASK = np.uint32(0xFFFFE000)


def to_tf32(v: np.ndarray) -> np.ndarray:
    """``to_tf32``: the bits of v rounded to TF32 (ties away), as uint32."""
    return (np.asarray(v, np.float32).view(np.uint32) + np.uint32(0x1000)) & TF32_MASK


def split(v: np.ndarray):
    """``split`` (the audio): (hi, lo) as f32 values, NaN kept in hi."""
    v = np.asarray(v, np.float32)
    hi = np.where(np.isnan(v), v.view(np.uint32), to_tf32(v)).view(np.float32)
    with np.errstate(invalid="ignore"):
        lo = to_tf32(v - hi).view(np.float32)  # lo = to_tf32(v - __uint_as_float(hi));
    return hi, lo


def units(warp: int):
    """A warp's m16n8 tiles (mt, j), in the order of its accumulators:
    tiles nw + kWarpsN * i in both halves, and tile kTiles - 1 in half nw
    for nw < 2 (nw = warp % kWarpsN: warps w and w + kWarpsN share units)."""
    nw = warp % WARPS_N                          # const int nw = warp % kWarpsN, ...
    out = [(mt, nw + WARPS_N * i) for i in range(4) for mt in range(2)]
    if nw < 2:                                   # const bool extra = nw < 2;
        out.append((nw, TILES - 1))
    return out


def k_steps(warp: int):
    """The k-steps (kk) of each chunk that warp takes: its group's share."""
    kg = warp // WARPS_N                         # kg = warp / kWarpsN
    return [8 * (kg * STEPS + s) for s in range(STEPS)]  # kk = 8 * (kg * kStepsPerGroup + s)


def a_addresses() -> np.ndarray:
    """(kFrames, 1024): the span offset each A element (frame, sample) is
    read from, from every warp's fragment loads; each element loaded by the
    kWarpsN warps of the group that owns its k-step, from one address."""
    addr = np.full((FRAMES, N_FFT), -1)
    loads = np.zeros((FRAMES, N_FFT), int)
    for warp in range(WARPS_N * GROUPS_K):
        for c in range(CHUNKS):
            hop, n0 = c // PER_HOP, (c % PER_HOP) * CHUNK
            base = (G + hop) * RS + n0 + T_      # as = span + (g + hop) * kSpanStride + n0 + t
            for kk in k_steps(warp):
                for mt in range(2):
                    p = base + 16 * mt * RS + kk  # p = as + 16 * mt * kSpanStride + kk
                    # a {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}: p[0], p[8 RS], p[4], p[8 RS + 4]
                    for off, dr, dk in ((0, 0, 0), (8 * RS, 8, 0), (4, 0, 4),
                                        (8 * RS + 4, 8, 4)):
                        m, k = 16 * mt + G + dr, c * CHUNK + kk + T_ + dk
                        assert ((addr[m, k] == -1) | (addr[m, k] == p + off)).all()
                        addr[m, k] = p + off
                        loads[m, k] += 1
    assert (loads == WARPS_N).all(), "an A element not loaded by its group's warps"
    return addr


def b_addresses() -> np.ndarray:
    """(kChunkK, kCols): the offset in a staged chunk each B element (row,
    column of the block) is read from, over every unit of every warp."""
    addr = np.full((CHUNK, COLS), -1)
    for warp in range(WARPS_N * GROUPS_K):
        for j in sorted({j for _, j in units(warp)}):
            for kk in k_steps(warp):
                # p = (uint2*)(bs + kSinOffset * (g >> 2)) + (kk + t) * kSliceBins + 4 * j + (g & 3)
                p = SIN // 2 * (G >> 2) + (kk + T_) * SLICE + 4 * j + (G & 3)
                for off, dk in ((0, 0), (4 * SLICE, 4)):  # b {(t, g), (t+4, g)}
                    k, n = kk + T_ + dk, 8 * j + G
                    assert ((addr[k, n] == -1) | (addr[k, n] == p + off)).all()
                    addr[k, n] = p + off
    assert (addr >= 0).all()
    return addr


def stage_span(audio_b: np.ndarray, t0: int, L: int, aligned: bool):
    """The span copies of one block: the 16-byte pieces (zero-filled past
    the audio's end) where the tile's audio is 16-byte aligned, else 4-byte
    ones. Each span element is written once; the pad columns never."""
    span = np.full(SPAN_FLOATS, np.nan, np.float32)
    wrote = np.zeros(SPAN_FLOATS, int)
    a = audio_b[t0 * HOP:]                        # a = audio + b * L + t0 * kHop
    avail = L - t0 * HOP
    width = 4 if aligned else 1
    for i in range(0, SPAN_ROWS * HOP, width):    # every thread's i
        n = 4 * min(max(avail - i, 0), 4) if aligned else (4 if i < avail else 0)
        dst = (i // HOP) * RS + i % HOP
        vals = np.zeros(width, np.float32)
        vals[:n // 4] = a[i:i + n // 4]           # n bytes read, the rest zero-filled
        span[dst:dst + width] = vals
        wrote[dst:dst + width] += 1
    assert set(np.unique(wrote)) == {0, 1}
    return span, wrote.astype(bool)


def stage_chunk(c: int, rank: int, wc: np.ndarray, ws: np.ndarray) -> np.ndarray:
    """``load_chunk(c)``: the chunk's buffer as the two bulk copies write it,
    the block's cos rows (kChunkK x 68 (hi, lo) pairs of wc, one run) and,
    kSinOffset floats on, its sin rows; both 16-byte aligned at both ends,
    each float written once (the 16 between them never), and the bytes
    announced on the mbarrier are the bytes copied. Returns (floats / 2, 2)
    pairs."""
    buf = np.full(CHUNK_FLOATS, np.nan, np.float32)
    written = np.zeros(CHUNK_FLOATS, int)
    src = (rank * N_FFT + c * CHUNK) * SLICE * 2  # (... (size_t)c * kChunkK) * kSliceBins * 2
    for dst, arr in ((0, wc), (SIN, ws)):         # dst, dst + kSinOffset
        assert (4 * dst) % 16 == 0 and (4 * src) % 16 == 0 and (4 * RUN) % 16 == 0
        buf[dst:dst + RUN] = arr.reshape(-1)[src:src + RUN]
        written[dst:dst + RUN] += 1
    assert written.max() == 1 and written.sum() * 4 == 8 * RUN
    return buf.reshape(-1, 2)


def fma_f32(a, b, c):
    """fmaf: a * b + c rounded once (the f64 product of two f32 is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


A_ADDR = a_addresses()
B_ADDR = b_addresses()


def block_b(rank: int, wc, ws) -> np.ndarray:
    """(1024, kCols, 2): the block's B as its fragments read it, (hi, lo)
    pairs, chunk by chunk."""
    out = np.empty((N_FFT, COLS, 2), np.float32)
    for c in range(CHUNKS):
        buf = stage_chunk(c, rank, wc, ws)
        out[c * CHUNK:(c + 1) * CHUNK] = buf[B_ADDR]
    return out


def emulate(audio: np.ndarray, T: int) -> np.ndarray:
    """One launch of ``log_mel_kernel`` on padded audio (B, L): every block
    of every cluster. Returns (B, 80, T)."""
    Bn, L = audio.shape
    wc, ws, melT = (c.numpy() for c in kernel_constants("cpu"))
    n_tiles = -(-T // FRAMES)
    out = np.full((Bn, MELS, T), np.nan, np.float32)
    written = np.zeros((Bn, MELS, T), int)
    splits = []
    for rank in range(CLUSTER):                   # bh = v.x, bl = v.y
        pairs = block_b(rank, wc, ws)
        splits.append((pairs[..., 0], pairs[..., 1]))
    for b in range(Bn):
        for tile in range(n_tiles):
            t0 = tile * FRAMES                   # t0 = (blockIdx.x / kCluster) * kFrames
            aligned = (4 * (b * L + t0 * HOP)) % 16 == 0
            span, staged = stage_span(audio[b], t0, L, aligned)
            assert staged[A_ADDR].all(), "an A fragment read shared memory the span never wrote"
            ah, al = split(span[A_ADDR])
            partials = []
            for rank in range(CLUSTER):
                bh, bl = splits[rank]
                sums = []
                for kg in range(GROUPS_K):       # warps kg * kWarpsN ..: their k-steps
                    acc = np.zeros((FRAMES, COLS), np.float32)
                    ks = np.concatenate([kk + np.arange(8) for kk in k_steps(kg * WARPS_N)])
                    for c0 in range(0, CHUNKS, FLUSH):  # a zeroed partial every kFlushChunks
                        kc = np.concatenate([c * CHUNK + ks for c in range(c0, c0 + FLUSH)])
                        A = [x[:, kc].astype(np.float64) for x in (ah, al)]
                        W = [x[kc].astype(np.float64) for x in (bh, bl)]
                        part = A[0] @ W[1] + A[1] @ W[0] + A[0] @ W[0]
                        acc = (acc + part.astype(np.float32)).astype(np.float32)
                    sums.append(acc)
                w = GROUPS_K // 2                 # the fixed tree: group kg + w into kg
                while w:
                    for kg in range(w):
                        sums[kg] = (sums[kg] + sums[kg + w]).astype(np.float32)
                    w //= 2
                acc = sums[0]
                partials.append(block_mels(acc, melT, rank))
            for rank in range(CLUSTER):
                idx = np.arange(rank * PER_RANK, (rank + 1) * PER_RANK)
                m, f = idx // FRAMES, idx % FRAMES
                v = np.zeros(len(idx), np.float32)
                for q in range(CLUSTER):          # rank order, the same sum every run
                    v = (v + partials[q][m * PART_STRIDE + f]).astype(np.float32)
                keep = t0 + f < T
                with np.errstate(invalid="ignore"):
                    val = np.log10(np.where(np.isnan(v), v, np.maximum(v, np.float32(1e-5))))
                out[b, m[keep], t0 + f[keep]] = val[keep]
                np.add.at(written, (b, m[keep], t0 + f[keep]), 1)
    assert (written == 1).all(), "an output written twice or not at all"
    return out


def lane_magnitudes(acc: np.ndarray, mt: int, j: int):
    """``magnitudes`` for unit (mt, j) over the 32 lanes: the accumulator's
    fragment, the t ^ 2 trade; returns each lane's (frame, first bin) and
    its two (re, im) pairs."""
    r0, c0 = 16 * mt + G, 8 * j + 2 * T_
    d = [acc[r0, c0], acc[r0, c0 + 1], acc[r0 + 8, c0], acc[r0 + 8, c0 + 1]]
    cos_lane = T_ < 2
    x0 = np.where(cos_lane, d[2], d[0])[LANES ^ 2]   # __shfl_xor_sync(..., 2)
    x1 = np.where(cos_lane, d[3], d[1])[LANES ^ 2]
    re0, re1 = np.where(cos_lane, d[0], x0), np.where(cos_lane, d[1], x1)
    im0, im1 = np.where(cos_lane, x0, d[2]), np.where(cos_lane, x1, d[3])
    f = 16 * mt + G + np.where(cos_lane, 0, 8)
    return f, 4 * j + 2 * (T_ & 1), ((re0, im0), (re1, im1))


def block_mels(acc: np.ndarray, melT: np.ndarray, rank: int) -> np.ndarray:
    """A block's summed accumulators (kFrames, kCols) -> magnitudes through
    the first group's lane maps -> its partial (kMels x kPartStride)."""
    mag = np.zeros(FRAMES * MAG_STRIDE, np.float32)
    wrote = np.zeros(FRAMES * MAG_STRIDE, int)
    for warp in range(WARPS_N):                   # if (kg == 0)
        for mt, j in units(warp):
            f, bin0, pairs = lane_magnitudes(acc, mt, j)
            at = f * MAG_STRIDE + bin0
            for off, (re, im) in enumerate(pairs):
                mag[at + off] = np.sqrt(re * re + im * im + np.float32(1e-24))
                np.add.at(wrote, at + off, 1)
    mag2 = mag.reshape(FRAMES, MAG_STRIDE)
    assert (wrote.reshape(FRAMES, MAG_STRIDE)[:, :SLICE] == 1).all()
    fb = melT[rank * SLICE:(rank + 1) * SLICE]    # staged from src = melT + rank * 68 * 80
    tid = np.arange(THREADS)
    mg, fg = tid & 15, tid >> 4                   # const int mg = tid & 15, fg = tid >> 4;
    partial = np.full(MELS * PART_STRIDE, np.nan, np.float32)
    for i in range(2):
        for e in range(5):
            s = np.zeros(THREADS, np.float32)
            for k in range(SLICE):
                s = fma_f32(mag2[2 * fg + i, k], fb[k, 5 * mg + e], s)
            at = (5 * mg + e) * PART_STRIDE + 2 * fg + i
            assert np.isnan(partial[at]).all()
            partial[at] = s
    return partial


def _audio(T: int, extra: int, seed: int, batch: int = 1) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, N_FFT + HOP * (T - 1) + extra) * 0.3).astype(np.float32)


@pytest.mark.parametrize("T, extra, batch", [(1, 0, 1), (31, 100, 1), (32, 255, 2),
                                             (33, 0, 1), (576, 17, 1)])
def test_emulated_kernel_matches_jax(T, extra, batch):
    """The emulated launch against JAX's kernel in interpret mode and the
    port's plain version, atol 1e-5 log10 units: one frame, tiles of 31, 32
    and 33 frames (a tail of 1), the preprocess run's largest bucket, and
    samples past the last frame that no frame reads; at batch 2 with L odd
    the second sample's span takes the 4-byte copies."""
    audio = _audio(T, extra, T)
    audio = np.concatenate([audio] + [_audio(T, extra, T + 1 + k) for k in range(batch - 1)])
    got = emulate(audio, T)
    want = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(audio), interpret=True, pad=False))
    assert got.shape == want.shape == (batch, MELS, T)
    np.testing.assert_allclose(got, want, **TOL)
    plain = log_mel_spectrogram_plain(torch.from_numpy(audio), pad=False).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


def test_nan_sample_reaches_its_frames_only():
    """A NaN sample makes every mel of the frames that hold it NaN (via hi,
    which keeps it) and no other frame's, as in the plain version."""
    audio = _audio(40, 0, 5)
    audio[0, 256 * 33 + 5] = np.nan   # frames 30-33: the tile of 32 and its tail
    got = emulate(audio, 40)
    bad = np.zeros(40, bool)
    bad[30:34] = True
    assert np.isnan(got[0][:, bad]).all() and np.isfinite(got[0][:, ~bad]).all()
    plain = log_mel_spectrogram_plain(torch.from_numpy(audio), pad=False).numpy()
    np.testing.assert_array_equal(np.isnan(plain), np.isnan(got))


def test_split_is_tf32_pairs():
    """hi and lo are TF32 values (the low 13 bits zero), hi rounds to
    nearest with ties away, hi + lo is v to 2^-22, and NaN stays in hi."""
    rs = np.random.RandomState(0)
    v = np.concatenate([rs.randn(10000).astype(np.float32) * 10.0 ** rs.randint(-6, 6, 10000),
                        np.float32([0.0, -0.0, 1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12])])
    hi, lo = split(v)
    for x in (hi, lo):
        assert not (x.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_allclose(hi.astype(np.float64) + lo, v, rtol=2.0 ** -21, atol=0)
    assert hi[-2] == np.float32(1 + 2 ** -10)        # the tie 1 + 2^-11 rounds away
    hi, lo = split(np.float32([np.nan]))
    assert np.isnan(hi).all()


def test_units_cover_every_tile_once():
    """Each group's warps cover every (m16 half, n8 tile) of the block once,
    9, 9, 8 and 8 units; the groups take disjoint quarters of every
    chunk's k-steps; the groups' accumulators fit the ring beside the
    filter rows."""
    for kg in range(GROUPS_K):
        warps = range(kg * WARPS_N, (kg + 1) * WARPS_N)
        seen = [u for w in warps for u in units(w)]
        assert sorted(seen) == [(mt, j) for mt in range(2) for j in range(TILES)]
        assert [len(units(w)) for w in warps] == [9, 9, 8, 8]
    assert max(len(units(w)) for w in range(THREADS // 32)) == UNITS
    assert sorted(kk for kg in range(GROUPS_K) for kk in k_steps(kg * WARPS_N)) == list(
        range(0, CHUNK, 8))
    assert K["kXchFloats"] + SLICE * MELS <= STAGES * CHUNK_FLOATS


def test_interleaved_columns_and_bins():
    """Column 8 j + e of block ``rank`` is the cos (e < 4) or the sin
    (e >= 4) of bin 68 rank + 4 j + e % 4; the t ^ 2 trade gives lane (g, t)
    re and im of bins 4 j + 2 (t & 1) and +1 in frame g (t < 2) or g + 8,
    and every (frame, bin) of a block to one lane of one unit."""
    wc, ws, _ = (c.numpy() for c in kernel_constants("cpu"))
    flat = {a: x.transpose(1, 0, 2, 3).reshape(N_FFT, BINS_PAD, 2)
            for a, x in (("c", wc), ("s", ws))}
    for rank in (0, 3, CLUSTER - 1):
        B = block_b(rank, wc, ws)
        for j in range(TILES):
            for e in range(8):
                bin_ = rank * SLICE + 4 * j + e % 4
                np.testing.assert_array_equal(B[:, 8 * j + e], flat["c" if e < 4 else "s"][:, bin_])
    # A made-up accumulator: re = 1000 * frame + bin, im = -(that)
    acc = np.zeros((FRAMES, COLS), np.float32)
    for j in range(TILES):
        for e in range(4):
            val = 1000 * np.arange(FRAMES) + 4 * j + e
            acc[:, 8 * j + e] = val
            acc[:, 8 * j + 4 + e] = -val
    seen = np.zeros((FRAMES, MAG_STRIDE), int)
    for warp in range(WARPS_N):
        for mt, j in units(warp):
            f, bin0, pairs = lane_magnitudes(acc, mt, j)
            for off, (re, im) in enumerate(pairs):
                np.testing.assert_array_equal(re, 1000 * f + bin0 + off)
                np.testing.assert_array_equal(im, -(1000 * f + bin0 + off))
                np.add.at(seen, (f, bin0 + off), 1)
    assert (seen[:, :SLICE] == 1).all()


def test_span_stride_spreads_a_fragments_over_the_banks():
    """At the padded stride every A-fragment load of one mma (32 lanes, one
    register) hits 32 distinct banks: its 8 rows g fall in 8 distinct groups
    of 4 banks. At a stride of 256 the 8 rows share one group (8-way
    conflicts). B fragments, (hi, lo) pairs, load 16 distinct pairs of banks
    in each half warp (4 t + g % 4 + 4 j)."""
    def banks(stride):
        out = []
        for off in (0, 8 * stride, 4, 8 * stride + 4):
            for kk in (0, 8, 16, 24):
                out.append(((G + 1) * stride + 32 + T_ + kk + off) % 32)
        return out
    for bank in banks(RS):
        assert len(set(bank)) == 32 and len(set(bank // 4)) == 8
    for bank in banks(HOP):
        assert len(set(bank // 4)) == 1 and len(set(bank)) == 4
    for kk in range(0, CHUNK, 8):
        for j in range(TILES):
            for off in (0, 4 * SLICE):
                p = SIN // 2 * (G >> 2) + (kk + T_) * SLICE + 4 * j + (G & 3) + off
                for half in (p[:16], p[16:]):      # 8-byte loads: a half warp a wavefront
                    assert len(set(half % 16)) == 16
    assert RS % 32 in (4, 12, 20, 28) and SLICE % 16 == 4


def test_ring_is_never_overwritten_while_read():
    """The ring: at iteration c, after the barrier that ends chunk c - 1,
    warp 0 loads chunk c + kStages - 1 into buffer (c - 1) % kStages, which
    no later iteration reads before it is loaded again; chunk c is then
    awaited on buffer c % kStages's mbarrier in phase (c / kStages) & 1, the
    number of loads that buffer had before chunk c."""
    loads = {st: 0 for st in range(STAGES)}
    for c in range(STAGES - 1):                    # the prologue's loads
        loads[c % STAGES] += 1
    for c in range(CHUNKS):
        nxt = c + STAGES - 1                       # load_chunk(c + kStages - 1)
        if nxt < CHUNKS:
            assert nxt % STAGES == (c - 1) % STAGES
            assert all(k % STAGES != nxt % STAGES for k in range(c, nxt))
            loads[nxt % STAGES] += 1
        st = c % STAGES
        assert loads[st] == c // STAGES + 1        # chunk c's load is this buffer's next phase
        assert (c // STAGES) & 1 == (loads[st] - 1) & 1
    assert SPAN_FLOATS * 4 % 16 == 0 and CHUNK_FLOATS * 4 % 16 == 0  # the chunks are aligned
    assert 4 * (SPAN_FLOATS + STAGES * CHUNK_FLOATS) <= 113 * 1024  # two blocks an SM
