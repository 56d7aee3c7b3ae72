"""The arithmetic of K9's f32 kernel, emulated on the CPU: 3xTF32 products.

``csrc/melgan_stack.cu`` computes the MelGAN stage's products on the tensor
cores in TF32, which keeps 10 of f32's 23 mantissa bits. To stay at f32's
accuracy it splits every operand v into hi = tf32(v) and lo = tf32(v - hi)
(round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and takes
each product a.b as a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, the small terms
first. The emulation here lives in this file, not in the package: each conv
is a sum of such products in f64 (TF32 times TF32 is exact there), rounded
to f32, and the chain is held against the same chain in f64. At the card
tests' weight scales (``tests/test_torch_port_cuda.py`` ``_stage``) and
their tolerance (1e-4 of the output's scale plus rtol 1e-4), 3xTF32 must
pass and one TF32 product alone must not: the card tests' inputs tell a
kernel that drops the correction terms from one that keeps them. The
emulation does not model the tensor cores' own accumulation: on the card one
accumulator over a whole product added ~12x the f32 chain's error, which
the kernel avoids by summing each 32-row chunk apart and adding the chunks
in f32 (PERF.md). The card tests hold the kernel itself."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskcyclegan_vc_tpu_torch.ops.melgan_stack import DILATIONS, leaky_relu, reflect_pad

STAGE_TOL = 1e-4  # the card tests' and chip_smoke.py's K9 tolerance


def tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 holding the TF32 value, as cvt.rna.tf32.f32: add half of
    the 13 dropped bits' unit to the magnitude and clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def conv_1x(x, w, dilation=1):
    return F.conv1d(tf32(x).double(), tf32(w).double(), dilation=dilation)


def conv_3x(x, w, dilation=1):
    (xh, xl), (wh, wl) = split(x), split(w)

    def c(a, b):
        return F.conv1d(a.double(), b.double(), dilation=dilation)

    return c(xh, wl) + c(xl, wh) + c(xh, wh)


def conv_f64(x, w, dilation=1):
    return F.conv1d(x.double(), w.double(), dilation=dilation)


def stage(x, blocks, conv):
    """Three ResnetBlocks with the kernel's products: lrelu(h) and each
    block's output in f32, every conv summed by ``conv`` from f32 operands
    and rounded to f32, biases added in f32 after."""
    out_dtype = torch.float64 if conv is conv_f64 else torch.float32
    x = x.to(out_dtype)
    for d, bp in zip(DILATIONS, blocks):
        h = conv(reflect_pad(leaky_relu(x), d), bp["conv1.weight"], d).to(out_dtype)
        h = h + bp["conv1.bias"][:, None].to(out_dtype)
        y = (conv(x, bp["shortcut.weight"]) + conv(leaky_relu(h), bp["conv2.weight"]))
        x = y.to(out_dtype) + (bp["shortcut.bias"] + bp["conv2.bias"])[:, None].to(out_dtype)
    return x


def _stage_inputs(C, W, seed):
    """``_stage`` of the card tests, drawn with numpy: unit-gain weights,
    biases 0.1, x standard normal."""
    rs = np.random.RandomState(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * scale).astype(np.float32))

    blocks = [{"conv1.weight": rnd(C, C, 3, scale=(3 * C) ** -0.5), "conv1.bias": rnd(C, scale=0.1),
               "conv2.weight": rnd(C, C, 1, scale=C ** -0.5), "conv2.bias": rnd(C, scale=0.1),
               "shortcut.weight": rnd(C, C, 1, scale=C ** -0.5),
               "shortcut.bias": rnd(C, scale=0.1)} for _ in range(3)]
    return rnd(1, C, W), blocks


def _within_stage_tol(got, want) -> bool:
    want = want.float()
    return torch.allclose(got.float(), want, atol=STAGE_TOL * want.abs().max().item(),
                          rtol=STAGE_TOL)


def test_split_is_exact_to_tf32():
    """hi and lo carry no bit below TF32's 10, hi + lo is v to 2^-22 of v,
    and ties round away from zero."""
    rs = np.random.RandomState(0)
    v = torch.from_numpy(rs.standard_normal(4096).astype(np.float32) * 10.0 ** rs.uniform(
        -3, 3, 4096).astype(np.float32))
    hi, lo = split(v)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - v.double()).abs()
    assert (err <= v.double().abs() * 2.0 ** -22).all()
    assert ((hi - v).abs() <= v.abs() * 2.0 ** -11).all()
    one_ulp = 2.0 ** -10  # of TF32 at 1
    ties = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2)], dtype=torch.float32)
    assert tf32(ties).tolist() == [1 + one_ulp, -(1 + one_ulp)]


@pytest.mark.parametrize("offset", [0.0, 4.0])
def test_3xtf32_holds_the_stage_tolerance_and_1xtf32_does_not(offset):
    """A C = 256 stage (the widest of a decode) at the card tests' scales,
    x as drawn and offset by +4: the 3xTF32 chain and the f32 chain within
    the tolerance of the f64 chain; the TF32 chain outside it."""
    x, blocks = _stage_inputs(256, 384, 5 + int(offset))
    x = x + offset
    with torch.no_grad():
        want = stage(x, blocks, conv_f64)
        three = stage(x, blocks, conv_3x)
        one = stage(x, blocks, conv_1x)
        f32 = stage(x, blocks, lambda a, w, d=1: F.conv1d(a.float(), w, dilation=d))
    scale = want.abs().max().item()
    assert _within_stage_tol(three, want), (three.double() - want).abs().max().item() / scale
    assert _within_stage_tol(f32, want)
    assert not _within_stage_tol(one, want), (one.double() - want).abs().max().item() / scale
