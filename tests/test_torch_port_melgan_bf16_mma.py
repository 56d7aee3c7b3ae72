"""The lane-level index maps of K9's bf16 kernel, emulated on the CPU.

``csrc/melgan_stack.cu``'s ``resblock_bf16_kernel`` runs each ResnetBlock's
two products as implicit GEMMs on ``mma.sync.m16n8k16`` in bf16: M =
positions, N = output channels, K = tap x ci. Its activations sit in shared
memory position-major, ``[p][c]``; ``ldmatrix.x4`` reads the A fragments
from rows ``p + tap * d`` of the mirrored lrelu(x) tile, ``ldmatrix.trans``
the B fragments from the weight chunks ``[k][co]``, and lrelu(h)'s D
fragments are written back as bf16x2 words into the rows lrelu(x) held.

This file mirrors those address formulas, each beside the ``.cu`` line it
copies, in one flat shared-memory array that starts as NaN (a read of a
word the kernel never wrote poisons the result). ``ldmatrix`` and ``mma``
are emulated from their PTX definitions: ``ldmatrix`` hands lane l the
elements (l / 4, 2 (l % 4) .. +1) of each 8 x 8 matrix (``.trans``: (2 (l %
4) .. +1, l / 4)), matrix i's rows at the addresses of lanes 8i..8i+7; the
MMA's A, B and D registers hold the elements the PTX ISA lists for
m16n8k16 bf16. Sums are taken in f64: bf16 products are exact there and in
the tensor cores' f32, so only the order of the sum differs from cuDNN's.

Two checks. Each product's sum before its bf16 rounding (h = b1 + the
dilated conv, and the merged 1x1 conv plus bm) against ``F.conv1d`` on the
same bf16 values, rtol 1e-6 plus 1e-6 of the scale: a wrong lane map misses
by whole products. The whole stage against ``melgan_resstack_plain_bf16``
within two bf16 roundings of the output's scale (``STAGE_TOL_BF16`` of
``chip_smoke.py``). The card tests (``tests/test_torch_port_cuda.py``) hold
the kernel itself."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.melgan_stack import (
    DILATIONS,
    leaky_relu,
    melgan_resstack_plain_bf16,
    pack_weights,
    reflect_pad,
)

CU = Path(__file__).resolve().parents[1] / "maskcyclegan_vc_tpu_torch" / "csrc" / "melgan_stack.cu"


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert len(found) == 1, f"{name} not found once in csrc/melgan_stack.cu"
    return int(found[0])


TILES = (_constant("kTileOutBf16"), _constant("kTileOutBf16Large"))  # outputs of a block
CHUNK_K = _constant("kChunkKBf16")   # weight rows of a chunk, at most
STAGES = _constant("kStagesBf16")    # weight chunks in shared memory
WARPS = 8  # kTcThreads / 32
STAGE_TOL_BF16 = 2 * 2 ** -7  # chip_smoke.py, tests/test_torch_port_cuda.py TWO_BF16_OF_SCALE
SUM_RTOL = 1e-6


def ldm_stride(n: int) -> int:
    """melgan_stack.cu:442: an odd number of 16-byte units."""
    return n if n // 8 % 2 else n + 8


class Shape:
    """``Bf16Shape<C, TILE>``, melgan_stack.cu:444-467."""

    def __init__(self, C: int, tile: int):
        self.C = C
        self.NP = max(C, 8)
        self.CK = max(C, 16)
        self.TW = tile // self.NP
        self.WN = min(self.NP, 32)
        self.NT = self.WN // 8
        self.WARPS_N = self.NP // self.WN
        self.MT = self.TW // 16 // (WARPS // self.WARPS_N)
        self.SR = ldm_stride(self.CK)
        self.SW = ldm_stride(self.NP)
        self.KC = min(self.CK, CHUNK_K)
        self.N1, self.N2 = 3 * self.CK // self.KC, 2 * self.CK // self.KC
        self.SY = self.TW + 8
        assert WARPS % self.WARPS_N == 0 and self.MT >= 1 and (self.NT == 1 or self.NT % 2 == 0)
        assert C * self.SY <= 2 * self.TW * self.SR


def rnd(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest even), held in f64."""
    return t.to(torch.bfloat16).double()


def reflect(p: torch.Tensor, W: int) -> torch.Tensor:
    """melgan_stack.cu ``reflect``: past W = 9 ``mirror_once``, the mirror
    of p clamped for positions a ragged tile computes past W and never
    stores; up to 9 the mirror repeating with period 2 (W - 1) (0 at
    W = 1)."""
    if W > 9:
        p = torch.where(p < 0, -p, p)
        p = torch.where(p >= W, 2 * (W - 1) - p, p)
        return p.clamp(0, W - 1)
    if W == 1:
        return torch.zeros_like(p)
    period = 2 * (W - 1)
    p = p.remainder(period)
    return torch.where(p < W, p, period - p)


LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4


def ldmatrix(sh: torch.Tensor, addrs: torch.Tensor, n: int, trans: bool) -> torch.Tensor:
    """``ldmatrix.m8n8.x{n}[.trans].b16``: addrs (32,) the element offset of
    each lane's row (lanes 8i..8i+7 give matrix i's rows). Returns (32, n, 2):
    register i of lane l, its lower and upper bf16."""
    out = torch.empty(32, n, 2, dtype=sh.dtype)
    for i in range(n):
        rows = addrs[8 * i:8 * i + 8]
        assert (rows % 8 == 0).all(), "ldmatrix rows must be 16-byte aligned"
        m = sh[rows[:, None] + torch.arange(8)[None, :]]  # (8 rows, 8 columns)
        if trans:
            out[:, i, 0], out[:, i, 1] = m[2 * T, G], m[2 * T + 1, G]
        else:
            out[:, i, 0], out[:, i, 1] = m[G, 2 * T], m[G, 2 * T + 1]
    return out


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """``mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32``, acc (32, 4) += A . B
    with A, B and D laid out over the lanes as the PTX ISA lists
    (melgan_stack.cu:488-500)."""
    A = torch.empty(16, 16, dtype=a.dtype)
    B = torch.empty(16, 8, dtype=b.dtype)
    for j in (0, 1):
        A[G, 2 * T + j], A[G + 8, 2 * T + j] = a[:, 0, j], a[:, 1, j]
        A[G, 2 * T + 8 + j], A[G + 8, 2 * T + 8 + j] = a[:, 2, j], a[:, 3, j]
        B[2 * T + j, G], B[2 * T + 8 + j, G] = b[:, 0, j], b[:, 1, j]
    D = A @ B
    acc[:, 0] += D[G, 2 * T]
    acc[:, 1] += D[G, 2 * T + 1]
    acc[:, 2] += D[G + 8, 2 * T]
    acc[:, 3] += D[G + 8, 2 * T + 1]


def d_rows_cols(s: Shape, m0: int, n0: int, mt: int, nt: int):
    """Position and channel of each lane's four D elements (32, 4)."""
    p = m0 + mt * 16 + G[:, None] + 8 * torch.tensor([0, 0, 1, 1])[None, :]
    co = n0 + nt * 8 + 2 * T[:, None] + torch.tensor([0, 1, 0, 1])[None, :]
    return p, co


def set_bias(s: Shape, acc, bias: torch.Tensor, n0: int) -> None:
    """melgan_stack.cu:502-516: channel co's accumulators to bias[co], 0 past C."""
    for mt in range(s.MT):
        for nt in range(s.NT):
            _, co = d_rows_cols(s, 0, n0, mt, nt)
            acc[mt][nt][:] = torch.where(co < s.C, bias[co.clamp(max=s.C - 1)], 0.0)


def mma_chunk(s: Shape, sh, acc, a: int, wc: int, n0: int) -> None:
    """melgan_stack.cu:518-552 (``mma_chunk_bf16``)."""
    ar = a + (LANE % 16) * s.SR + (LANE // 16) * 8                     # :527
    br = wc + (LANE % 16) * s.SW + n0 + ((LANE // 16) * 8 if s.NT > 1 else 0)  # :528
    for kk in range(0, s.KC, 16):
        af = [ldmatrix(sh, ar + mt * 16 * s.SR + kk, 4, False) for mt in range(s.MT)]
        if s.NT == 1:
            bfr = [ldmatrix(sh, br + kk * s.SW, 2, True)]
        else:
            bfr = []
            for np_ in range(s.NT // 2):
                r = ldmatrix(sh, br + kk * s.SW + np_ * 16, 4, True)
                bfr += [r[:, 0:2], r[:, 2:4]]
        for mt in range(s.MT):
            for nt in range(s.NT):
                mma(acc[mt][nt], af[mt], bfr[nt])


def block_tile(s: Shape, x: torch.Tensor, w1, b1, wm, bm, d: int, w0: int, emit: bool,
               sums: dict):
    """One thread block of ``resblock_bf16_kernel`` (melgan_stack.cu:558-758)
    on the tile from w0 of one batch row x (C, W): returns the tile's (C, TW)
    output and records the pre-rounding sums of its positions in ``sums``."""
    C, W = x.shape
    TW, SR, SW, KC, CK = s.TW, s.SR, s.SW, s.KC, s.CK
    xr, xs = 0, TW * SR                           # :568-569
    ws = xs + (TW + 2 * d) * SR                   # :570
    ys = 0                                        # :571
    sh = torch.full((ws + STAGES * KC * SW,), float("nan"), dtype=torch.float64)
    chunks = s.N1 + s.N2

    def load_chunk(c: int) -> None:               # :579-604
        if c >= chunks:
            return
        first = c < s.N1
        src = w1 if first else wm
        k0 = (c if first else c - s.N1) * KC
        dst = ws + (c % STAGES) * KC * SW
        for r in range(KC):
            part, ci = (k0 + r) // CK, (k0 + r) % CK
            row = dst + r * SW + torch.arange(s.NP)
            if ci >= C:
                sh[row] = 0.0
            else:
                sh[row] = torch.cat([src[part * C + ci], torch.zeros(s.NP - C, dtype=src.dtype)])

    for c in range(STAGES - 1):
        load_chunk(c)
    HW = TW + 2 * d                               # :608-694
    c_idx = torch.arange(CK)[:, None].expand(CK, HW)
    p_idx = torch.arange(HW)[None, :].expand(CK, HW)
    v = torch.zeros(CK, HW, dtype=torch.float64)
    v[:C] = x[:, reflect(w0 - d + torch.arange(HW), W)]
    sh[xs + p_idx * SR + c_idx] = rnd(leaky_relu(v))
    inner = (p_idx >= d) & (p_idx < d + TW)
    sh[xr + (p_idx[inner] - d) * SR + c_idx[inner]] = v[inner]

    warps = []
    for warp in range(WARPS):                     # :696-699
        n0, m0 = (warp % s.WARPS_N) * s.WN, (warp // s.WARPS_N) * s.MT * 16
        acc = [[torch.zeros(32, 4, dtype=torch.float64) for _ in range(s.NT)]
               for _ in range(s.MT)]
        set_bias(s, acc, b1, n0)
        warps.append((m0, n0, acc))

    def record(key: str) -> None:
        for m0, n0, acc in warps:
            for mt in range(s.MT):
                for nt in range(s.NT):
                    p, co = d_rows_cols(s, m0, n0, mt, nt)
                    keep = (co < C) & (w0 + p < W)
                    sums[key][co[keep], w0 + p[keep]] = acc[mt][nt][keep]

    for c in range(chunks):                       # :701-729
        load_chunk(c + STAGES - 1)
        if c == s.N1:
            record("h")
            for m0, n0, acc in warps:             # :705-722
                for mt in range(s.MT):
                    for nt in range(s.NT):
                        p, co = d_rows_cols(s, m0, n0, mt, nt)
                        val = torch.where(co < C, rnd(leaky_relu(acc[mt][nt])), 0.0)
                        sh[xs + (p + d) * SR + co] = val
                set_bias(s, acc, bm, n0)
        k0 = (c if c < s.N1 else c - s.N1) * KC   # :723-728
        part, ci0 = k0 // CK, k0 % CK
        for m0, n0, acc in warps:
            if c < s.N1:
                a = xs + (m0 + part * d) * SR + ci0
            else:
                a = (xr + m0 * SR if part == 0 else xs + (m0 + d) * SR) + ci0
            mma_chunk(s, sh, acc, a, ws + (c % STAGES) * KC * SW, n0)
    record("y")

    sh[:ws] = float("nan")  # the staging overwrites x and lrelu(x) (:731-743)
    for m0, n0, acc in warps:
        for mt in range(s.MT):
            for nt in range(s.NT):
                p, co = d_rows_cols(s, m0, n0, mt, nt)
                v = rnd(acc[mt][nt])
                v = rnd(leaky_relu(v)) if emit else v
                keep = co < C
                sh[ys + co[keep] * s.SY + p[keep]] = v[keep]
    co = torch.arange(C)[:, None]                 # :745-758
    p = torch.arange(TW)[None, :]
    return sh[ys + co * s.SY + p]


def emulated_stage(x: torch.Tensor, blocks, emit: bool, tile: int):
    """The three blocks over every tile and batch row, as ``launch_k``
    (grid (ceil(W / TW), B)). Returns the stage output (B, C, W) in bf16
    values and each block's input and pre-rounding sums."""
    B, C, W = x.shape
    s = Shape(C, tile)
    w1, b1, wm, bm, _, _ = pack_weights(blocks, dtype=torch.bfloat16)
    cur = x.double()
    trace = []
    for j, d in enumerate(DILATIONS):
        last = j == len(DILATIONS) - 1
        out = torch.empty(B, C, W, dtype=torch.float64)
        sums = {"h": torch.full((B, C, W), float("nan"), dtype=torch.float64),
                "y": torch.full((B, C, W), float("nan"), dtype=torch.float64)}
        for b in range(B):
            per = {k: v[b] for k, v in sums.items()}
            for w0 in range(0, W, s.TW):
                tile = block_tile(s, cur[b], w1[j].reshape(3 * C, C).double(), b1[j].double(),
                                  wm[j].double(), bm[j].double(), d, w0, emit and last, per)
                n = min(s.TW, W - w0)
                out[b, :, w0:w0 + n] = tile[:, :n]
        trace.append((cur, sums))
        cur = out
    return cur, trace


def conv_sums(x: torch.Tensor, bp, d: int):
    """The two products on the same bf16 values in f64, biases as the kernel
    adds them: h = conv3_dil_d(lrelu(x)) + b1 and y = [shortcut | conv2] .
    [x ; lrelu(h)] + (bs + b2), bm summed in bf16."""
    h = F.conv1d(reflect_pad(rnd(leaky_relu(x)), d), rnd(bp["conv1.weight"]),
                 rnd(bp["conv1.bias"]), dilation=d)
    wm = torch.cat([rnd(bp["shortcut.weight"]), rnd(bp["conv2.weight"])], dim=1)
    bm = (bp["shortcut.bias"].to(torch.bfloat16) + bp["conv2.bias"].to(torch.bfloat16)).double()
    y = F.conv1d(torch.cat([x, rnd(leaky_relu(h))], dim=1), wm, bm)
    return h, y


def _stage_inputs(B: int, C: int, W: int, seed: int):
    """The card tests' ``_stage`` drawn with numpy: unit-gain weights,
    biases 0.1, x standard normal in bf16."""
    rs = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * scale).astype(np.float32))

    blocks = [{"conv1.weight": r(C, C, 3, scale=(3 * C) ** -0.5), "conv1.bias": r(C, scale=0.1),
               "conv2.weight": r(C, C, 1, scale=C ** -0.5), "conv2.bias": r(C, scale=0.1),
               "shortcut.weight": r(C, C, 1, scale=C ** -0.5),
               "shortcut.bias": r(C, scale=0.1)} for _ in range(3)]
    return r(B, C, W).bfloat16(), blocks


def _ragged_width(C: int, tile: int) -> int:
    """Two whole tiles and a ragged third of 13 positions."""
    return 2 * Shape(C, tile).TW + 13


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("C", [256, 128, 64, 32, 16, 8, 4])
def test_ldmatrix_phases_hit_distinct_banks(C, tile):
    """Every 8-lane phase of an A (``ldmatrix.x4``) or B (``.trans``) read
    covers 8 distinct groups of 4 banks, at every tap shift and chunk
    offset: the padded strides (melgan_stack.cu:442, :453-454)."""
    s = Shape(C, tile)
    for stride, rows in ((s.SR, s.TW + 2 * max(DILATIONS)), (s.SW, s.KC)):
        assert stride % 8 == 0
        for r0 in range(rows - 8 + 1):
            for col in range(0, (s.CK if stride == s.SR else s.NP), 8):
                groups = {((r0 + i) * stride + col) // 8 % 8 for i in range(8)}
                assert len(groups) == 8, (stride, r0, col)


@pytest.mark.parametrize("C, B, tile", [(C, B, tile) for tile in TILES
                                         for C, B in [(32, 1), (16, 2), (8, 1), (4, 1)]]
                         + [(64, 1, TILES[0])])
def test_emulated_sums_match_conv1d(C, B, tile):
    """Both products' sums before rounding, every block of a ragged stage,
    against F.conv1d on the same bf16 values: the lane maps pick every
    product exactly once (tiles at both sequence ends take the mirror)."""
    W = _ragged_width(C, tile)
    x, blocks = _stage_inputs(B, C, W, 100 + C)
    with torch.no_grad():
        _, trace = emulated_stage(x, blocks, emit=False, tile=tile)
        for (cur, sums), d, bp in zip(trace, DILATIONS, blocks):
            h, y = conv_sums(cur, {k: v.double() for k, v in bp.items()}, d)
            for got, want in ((sums["h"], h), (sums["y"], y)):
                assert not got.isnan().any()
                torch.testing.assert_close(got, want, rtol=SUM_RTOL,
                                           atol=SUM_RTOL * want.abs().max().item())


@pytest.mark.parametrize("C, emit, tile", [(32, False, TILES[0]), (32, True, TILES[1]),
                                           (16, True, TILES[0]), (16, False, TILES[1])])
def test_emulated_stage_matches_plain_bf16(C, emit, tile):
    """The emulated kernel's stage against ``melgan_resstack_plain_bf16``
    within two bf16 roundings of the output's scale."""
    W = _ragged_width(C, tile)
    x, blocks = _stage_inputs(1, C, W, 200 + C)
    with torch.no_grad():
        got, _ = emulated_stage(x, blocks, emit=emit, tile=tile)
        want = melgan_resstack_plain_bf16(x, blocks, emit_lrelu=emit).double()
    assert not got.isnan().any()
    assert torch.equal(got, rnd(got))  # bf16 values
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=STAGE_TOL_BF16 * scale)


@pytest.mark.parametrize("W", [1, 2, 5, 8])
def test_emulated_sums_at_narrow_widths(W):
    """A stage narrower than its pad of 9 (a mel of 1 frame reaches the first
    stage at W = 8): the halo reflects again, as ``reflect_pad`` does."""
    x, blocks = _stage_inputs(1, 16, W, 300 + W)
    with torch.no_grad():
        _, trace = emulated_stage(x, blocks, emit=False, tile=TILES[0])
        for (cur, sums), d, bp in zip(trace, DILATIONS, blocks):
            h, y = conv_sums(cur, {k: v.double() for k, v in bp.items()}, d)
            for got, want in ((sums["h"], h), (sums["y"], y)):
                assert not got.isnan().any()
                torch.testing.assert_close(got, want, rtol=SUM_RTOL,
                                           atol=SUM_RTOL * want.abs().max().item())
