"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where PyTorch sees no GPU. On a machine
with one (``--noconftest``: the suite's conftest configures JAX, which this
file does not use):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Shapes cover every launch mode of csrc/in_gate.cu (K1, K2 and K3: rows
staged in shared memory, a group of 4-32 lanes per short row and a block
per longer one, or streamed from device memory past a block's shared
memory), batches above 1,
and lengths that are full, partial, odd, two frames and zero. Tolerance atol = rtol = 1e-5 (f32,
only the order of the sums differs). A row with one valid frame is
ill-conditioned and has its own test and bound. The fused backward's
dscale and dbias are sums of n = 4HW terms per (sample, channel), summed
again over the batch, in another order than the plain version's: f32
summation error grows with the sum of the terms' magnitudes, so their bound
is 1e-5 of that sum (see ``_sum_bound``). The mel frontend (K8) and the
MelGAN stage (K9) have their tolerances stated beside their tests. The
shuffles (K6, K7) are permutations and must be exact. Then the train step
as CUDA-graph replays against the same steps run eagerly, and the trainer's
epochs with and without capture. The bf16 entries
have their own section and tolerances at the end.
"""

import re

import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu_torch.data.dataset import MelBank, sample_batch, step_generator
from maskcyclegan_vc_tpu_torch.models import Discriminator, Generator
from maskcyclegan_vc_tpu_torch.ops import in_gate, ps
from maskcyclegan_vc_tpu_torch.ops.cuda_lib import CSRC
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import LOGGED_METRICS, make_train_step, make_update
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return resolve_device("cuda")


def _inputs(device, shape, C, n_vecs, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=g) * 2.0 + 0.5
    vecs = [torch.rand(C, device=device, generator=g) + 0.5 for _ in range(n_vecs)]
    return x, vecs


def _lengths(device, B, W, kind):
    if kind is None:
        return None
    full = [W, W // 2 + 1, 2, 0][:B] if kind == "mixed" else [W] * B
    return torch.tensor(full, dtype=torch.int32, device=device)


SHAPES = [(3, 5, 7), (2, 3, 4, 9), (1, 5120, 112), (2, 6, 1030), (1, 256, 40, 224)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", [None, "full", "mixed"])
def test_instance_norm_kernel(device, shape, kind):
    x, (s, b) = _inputs(device, shape, shape[1], 2, 0)
    lengths = _lengths(device, shape[0], shape[-1], kind)
    before = in_gate.IN_KERNEL.launches
    got = in_gate.instance_norm(x, s, b, lengths)
    torch.cuda.synchronize()
    assert in_gate.IN_KERNEL.launches == before + 1
    torch.testing.assert_close(got, in_gate.instance_norm_plain(x, s, b, lengths), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", [None, "mixed"])
def test_instance_norm_glu_kernel(device, shape, kind):
    C = shape[1]
    x, vecs = _inputs(device, (shape[0], 2 * C) + shape[2:], C, 4, 1)
    lengths = _lengths(device, shape[0], shape[-1], kind)
    got = in_gate.instance_norm_glu(x, *vecs, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, in_gate.instance_norm_glu_plain(x, *vecs, lengths), **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 3, 5), (3, 12, 4, 7), (1, 1024, 20, 112),
                                   (1, 512, 40, 224)])
@pytest.mark.parametrize("kind", [None, "mixed"])
def test_pixel_shuffle_in_swish_kernel(device, shape, kind):
    x, (s, b) = _inputs(device, shape, shape[1] // 4, 2, 2)
    lengths = _lengths(device, shape[0], 2 * shape[-1], kind)
    before = ps.PS_IN_SWISH_KERNEL.launches
    got = ps.pixel_shuffle_in_swish(x, s, b, lengths)
    torch.cuda.synchronize()
    assert ps.PS_IN_SWISH_KERNEL.launches == before + 1
    torch.testing.assert_close(got, ps.pixel_shuffle_in_swish_plain(x, s, b, lengths), **TOL)


@pytest.mark.parametrize("shape", SHAPES + [(2, 1024, 10, 8)])  # D downSample3 at 64 frames
@pytest.mark.parametrize("kind", [None, "full", "mixed"])
def test_instance_norm_swish_kernel(device, shape, kind):
    x, (s, b) = _inputs(device, shape, shape[1], 2, 5)
    lengths = _lengths(device, shape[0], shape[-1], kind)
    before = in_gate.IN_SWISH_KERNEL.launches
    got = in_gate.instance_norm_swish(x, s, b, lengths)
    torch.cuda.synchronize()
    assert in_gate.IN_SWISH_KERNEL.launches == before + 1
    torch.testing.assert_close(got, in_gate.instance_norm_swish_plain(x, s, b, lengths),
                               **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 3, 5), (3, 1024, 20, 16), (1, 512, 40, 224)])
def test_pixel_shuffle_in_swish_statistics(device, shape):
    x, (s, b) = _inputs(device, shape, shape[1] // 4, 2, 6)
    y, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    torch.cuda.synchronize()
    want_mean, want_inv = ps.pixel_shuffle_stats_plain(x)
    torch.testing.assert_close(y, ps.pixel_shuffle_in_swish_plain(x, s, b), **TOL)
    torch.testing.assert_close(mean, want_mean, **TOL)
    torch.testing.assert_close(inv, want_inv, **TOL)


def _sum_bound(terms: torch.Tensor) -> torch.Tensor:
    """1e-5 of the sum of |terms| per channel: terms (B, C, n)."""
    return 1e-5 * terms.abs().sum((0, 2))


# upSample1 and upSample2 of the full-width generator at 64 frames.
@pytest.mark.parametrize("chw", [(256, 20, 16), (128, 40, 32)])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_pixel_shuffle_in_swish_backward_kernel(device, chw, B):
    C, H, W = chw
    x, (s, b) = _inputs(device, (B, 4 * C, H, W), C, 2, 7)
    g = torch.Generator(device=device).manual_seed(8)
    dy = torch.randn((B, C, 2 * H, 2 * W), device=device, generator=g)
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    before = ps.PS_IN_SWISH_BWD_KERNEL.launches
    dx, dsc, dbi = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    torch.cuda.synchronize()
    assert ps.PS_IN_SWISH_BWD_KERNEL.launches == before + 1
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    torch.testing.assert_close(dx, want[0], **TOL)
    # Against autograd through the plain forward, its own statistics.
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    auto = torch.autograd.grad(ps.pixel_shuffle_in_swish_plain(xr, sr, br), (xr, sr, br), dy)
    torch.testing.assert_close(dx, auto[0], **TOL)
    dz = torch.nn.functional.pixel_unshuffle(dy, 2).reshape(B, C, -1).abs()
    for got, plain, autograd_ in ((dsc, want[1], auto[1]), (dbi, want[2], auto[2])):
        # 4|dy| stands for the terms' size: |dz| <= 1.1 |dy|, and |xhat| is
        # mostly under 4 for these inputs.
        bound = _sum_bound(dz * 4.0)
        assert ((got - plain).abs() <= bound).all()
        assert ((got - autograd_).abs() <= bound).all()


def test_backward_noncontiguous_cotangent(device):
    """A batch slice of a larger cotangent, as out_ab[:B] hands it over."""
    x, (s, b) = _inputs(device, (2, 32, 4, 6), 8, 2, 9)
    big = torch.randn((4, 8, 8, 12), device=device).transpose(0, 1).contiguous().transpose(0, 1)
    dy = big[:2]
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    dx = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)[0]
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy.contiguous(), s, b, mean, inv)[0]
    torch.testing.assert_close(dx, want, **TOL)


# ---------- K6 and K7, the inverse shuffle and the shuffle ----------

def _shuffle_inputs(device, shape, dtype, offset, seed):
    """x (B, 4C, H, W) and y (B, C, 2H, 2W) in ``dtype``, each a contiguous
    view ``offset`` elements into a flat buffer."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, C4, H, W = shape
    out = []
    for shp in (shape, (B, C4 // 4, 2 * H, 2 * W)):
        n = int(np.prod(shp))
        buf = torch.randn(n + offset, device=device, generator=g).to(dtype)
        out.append(buf[offset:].view(shp))
    return out


def _shuffle_routes():
    return {k: {d: dict(r) for d, r in by.items()} for k, by in ps.SHUFFLE_ROUTES.items()}


def _check_shuffles(x, y):
    """K7 on x and K6 on y against their plain versions, bit for bit; the
    route each launch took, as its C entry reported it."""
    before = _shuffle_routes()
    got_y, got_x = ps.pixel_shuffle(x), ps.inverse_pixel_shuffle(y)
    torch.cuda.synchronize()
    assert got_y.dtype == got_x.dtype == x.dtype
    assert torch.equal(got_y, ps.pixel_shuffle_plain(x))
    assert torch.equal(got_x, ps.inverse_pixel_shuffle_plain(y))
    taken = {}
    for k, by in ps.SHUFFLE_ROUTES.items():
        delta = {r: n - before[k][x.dtype][r] for r, n in by[x.dtype].items()}
        assert sum(delta.values()) == 1
        taken[k] = next(r for r, n in delta.items() if n)
    return taken


def _shuffle_route(shape, esize, offset):
    """The vector route where a row's W elements fill whole 16-byte words
    and the base lies on a 16-byte boundary, else the pair route."""
    return "vector" if shape[3] * esize % 16 == 0 and offset * esize % 16 == 0 else "pair"


# (x shape (B, 4C, H, W), offset in elements): odd and even W; W x 4 bytes
# exactly 16; the full-width upSample1 and upSample2 inputs of a 1 x 320
# step's batch-2 forward, and the upSample2 input of a 1 x 192 step; a base
# two elements (8 bytes) off a 16-byte boundary, which takes the pair route.
@pytest.mark.parametrize("shape, offset", [
    ((2, 12, 3, 5), 0), ((1, 8, 4, 7), 0), ((3, 16, 5, 6), 0), ((2, 8, 3, 4), 0),
    ((2, 1024, 20, 80), 0), ((2, 512, 40, 160), 0), ((1, 512, 40, 161), 0),
    ((1, 512, 40, 96), 0), ((2, 512, 40, 160), 2), ((2, 8, 3, 4), 2)])
def test_shuffle_kernels_exact(device, shape, offset):
    x, y = _shuffle_inputs(device, shape, torch.float32, offset, 10)
    before = (ps.SHUFFLE_KERNEL.launches, ps.INV_SHUFFLE_KERNEL.launches)
    route = _shuffle_route(shape, 4, offset)
    assert _check_shuffles(x, y) == {"shuffle": route, "inv_shuffle": route}
    assert (ps.SHUFFLE_KERNEL.launches, ps.INV_SHUFFLE_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_1x320_sites_take_the_vector_route(device, dtype):
    """The split route's K6 at a 1 x 320 step's upSample1 and upSample2
    sites (batch 2), and K7 at the same shapes: the vector route, by the
    route counters."""
    for shape in ((2, 1024, 20, 80), (2, 512, 40, 160)):
        x, (s, b) = _inputs(device, shape, shape[1] // 4, 2, 27)
        x = x.to(dtype)
        dy = torch.randn((shape[0], shape[1] // 4, 2 * shape[2], 2 * shape[3]),
                         device=device, generator=torch.Generator(device=device).manual_seed(28))
        before = _shuffle_routes()
        ps.pixel_shuffle_in_swish_backward_split(x, dy.to(dtype), s, b)
        ps.pixel_shuffle(x)
        torch.cuda.synchronize()
        for k in ("inv_shuffle", "shuffle"):
            assert {r: n - before[k][dtype][r] for r, n in ps.SHUFFLE_ROUTES[k][dtype].items()} \
                == {"vector": 1, "pair": 0}


def test_inverse_shuffle_gradient_is_the_shuffle(device):
    g = torch.Generator(device=device).manual_seed(12)
    y = torch.randn((2, 8, 6, 10), device=device, generator=g).requires_grad_()
    dx = torch.randn((2, 32, 3, 5), device=device, generator=g)
    before = ps.SHUFFLE_KERNEL.launches
    (got,) = torch.autograd.grad(ps.inverse_pixel_shuffle(y), y, dx)
    torch.cuda.synchronize()
    assert ps.SHUFFLE_KERNEL.launches == before + 1
    assert torch.equal(got, ps.pixel_shuffle_plain(dx))


# upSample2 and upSample1 of a 1 x 320 step (batch 2), and a small ragged case.
@pytest.mark.parametrize("shape", [(2, 512, 40, 160), (2, 1024, 20, 80), (3, 16, 5, 7)])
def test_split_backward_matches_fused(device, shape):
    """The split route (K6, then eager PyTorch from one-pass statistics)
    against K5 (the forward's two-pass statistics) on the same (x, dy):
    each output within 1e-5 of its largest magnitude."""
    B, C4, H, W = shape
    x, (s, b) = _inputs(device, shape, C4 // 4, 2, 13)
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device,
                     generator=torch.Generator(device=device).manual_seed(14))
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    before = ps.INV_SHUFFLE_KERNEL.launches
    split = ps.pixel_shuffle_in_swish_backward_split(x, dy, s, b)
    fused = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    torch.cuda.synchronize()
    assert ps.INV_SHUFFLE_KERNEL.launches == before + 1
    for got, want in zip(split, fused):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def test_gradient_past_the_budget_takes_the_split_route(device):
    """upSample2 at 1 x 192: 6 x 4 x 512 x 40 x 96 bytes, past 32 MiB."""
    x, (s, b) = _inputs(device, (1, 512, 40, 96), 128, 2, 15)
    x.requires_grad_()
    assert ps.pixel_shuffle_in_swish_backward_bytes(x) > ps.BWD_BUDGET_BYTES
    before = (ps.INV_SHUFFLE_KERNEL.launches, ps.PS_IN_SWISH_BWD_KERNEL.launches)
    y = ps.pixel_shuffle_in_swish(x, s, b)
    dy = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert (ps.INV_SHUFFLE_KERNEL.launches, ps.PS_IN_SWISH_BWD_KERNEL.launches) == \
        (before[0] + 1, before[1])
    want = ps.pixel_shuffle_in_swish_backward_split(x.detach(), dy, s, b)[0]
    assert torch.equal(dx, want)


def _rel_close(grads_got, grads_want, bound: float):
    """Per-leaf ||got - want|| < bound * scale, the scale being the leaf's own
    gradient norm or, for a bias, the larger of it and its layer's weight
    gradient norm: a conv bias ahead of an InstanceNorm has zero gradient in
    exact arithmetic, so its computed value is rounding noise at the scale
    of the gradients that flow through that layer."""
    for name, want in grads_want.items():
        scale = want.norm()
        if name.endswith(".bias"):
            scale = max(scale, grads_want[name[:-len("bias")] + "weight"].norm())
        rel = ((grads_got[name].cpu() - want).norm() / scale.clamp_min(1e-30)).item()
        assert rel < bound, (name, rel)


@pytest.mark.parametrize("which", ["G", "D"])
def test_model_backward_matches_cpu(device, which):
    """One loss.backward() on the card (kernels, their Functions, K5,
    cuDNN with TF32 off) against the CPU (plain versions, the same
    Functions) on the same weights and inputs. Bound: per-leaf relative
    norm error 1e-4 (``_rel_close``); the two differ only in the
    convolutions' and reductions' summation order, which chained norms
    amplify."""
    torch.manual_seed(0)
    if which == "G":
        model = Generator(16, 8, 2, generator=torch.Generator().manual_seed(1))
        x = torch.randn(3, 16, 32)
        mask = torch.ones_like(x)
        mask[1, :, 4:11] = 0.0
        args = (x, mask)
    else:
        model = Discriminator(8, generator=torch.Generator().manual_seed(2))
        args = (torch.randn(3, 16, 32),)
    gpu = type(model)(*((16, 8, 2) if which == "G" else (8,)), device=device)
    gpu.load_state_dict(model.state_dict())
    w = torch.randn(model(*args).shape)
    grads = {}
    for m, dev in ((model, "cpu"), (gpu, device)):
        loss = (m(*(a.to(dev) for a in args)) * w.to(dev)).sum()
        live = [(n, p) for n, p in m.named_parameters() if not n.startswith("downSample4.")]
        grads[dev if dev == "cpu" else "cuda"] = dict(
            zip([n for n, _ in live], torch.autograd.grad(loss, [p for _, p in live])))
    _rel_close(grads["cuda"], grads["cpu"], 1e-4)


def test_single_valid_frame(device):
    """One valid frame: the variance is 0, so a = scale/sqrt(eps) ~ 316*scale,
    and the folded affine x*a + (bias - mean*a) (the JAX package's form,
    which both versions keep) cancels two terms of size |x*a| ~ 1e3. The
    kernel's fused multiply-add rounds once where the plain multiply and
    add round twice, so the two differ by up to one rounding of |x*a|:
    the bound is 2 ulp of max |x*a|."""
    x, (s, b) = _inputs(device, (2, 6, 9), 6, 2, 4)
    lengths = torch.tensor([1, 1], dtype=torch.int32, device=device)
    got = in_gate.instance_norm(x, s, b, lengths)
    want = in_gate.instance_norm_plain(x, s, b, lengths)
    xa = (x[..., :1].abs() * s[None, :, None] / 1e-5 ** 0.5).max().item()
    torch.testing.assert_close(got, want, atol=2 * xa * 2.0 ** -23, rtol=0)
    assert not got[..., 1:].any()


def test_wrappers_raise_instead_of_falling_back(device):
    x, (s, b) = _inputs(device, (1, 4, 8), 4, 2, 3)
    with pytest.raises(ValueError):  # vectors on another device
        in_gate.instance_norm(x, s.cpu(), b.cpu())
    with pytest.raises(ValueError):  # lengths as int64
        in_gate.instance_norm(x, s, b, torch.tensor([3], device=device))
    with pytest.raises(NotImplementedError):  # the masked form has no backward
        in_gate.instance_norm(x.requires_grad_(), s, b,
                              torch.tensor([5], dtype=torch.int32, device=device))


# ---------- K8, the mel frontend ----------
#
# Tolerance 5e-5 in log10 units (1.2e-4 relative in mel power): each bin's
# DFT sums 1024 windowed products (3xTF32 on the tensor cores, each chunk of
# 32 into an f32 partial) and each mel 513 magnitudes in f32, in another
# order than cuBLAS in the plain version. Audio is broadband noise,
# so no bin sits near the 1e-5 floor, where log10 would amplify rounding.
MEL_TOL = dict(atol=5e-5, rtol=0)


@pytest.mark.parametrize("B, L, pad", [(1, 576 * 256 + 768, False),  # the 576-frame bucket
                                       (1, 173 * 256, True),  # 173 frames: a ragged tile
                                       (2, 260 * 256 + 100, True),
                                       (3, 1024, False)])  # one frame
def test_log_mel_kernel(device, B, L, pad):
    from maskcyclegan_vc_tpu_torch.ops import melspec

    g = torch.Generator(device=device).manual_seed(L)
    audio = torch.randn((B, L), device=device, generator=g) * 0.3
    before = melspec.LOG_MEL_KERNEL.launches
    got = melspec.log_mel_spectrogram_fused(audio, pad=pad)
    torch.cuda.synchronize()
    assert melspec.LOG_MEL_KERNEL.launches == before + 1
    want = melspec.log_mel_spectrogram_plain(audio, pad=pad)
    assert got.shape == want.shape and got.shape[:2] == (B, 80)
    torch.testing.assert_close(got, want, **MEL_TOL)


@pytest.mark.parametrize("T", [1, 7, 31, 32, 33, 192, 576, 2000])
def test_log_mel_kernel_frames(device, T):
    """K8 (3xTF32 mma.sync, a cluster of 8 blocks a tile of 32 frames) at
    batch 3 and T frames of pre-padded audio, with samples past the last
    frame: one launch a call, within MEL_TOL of the plain version, and the
    same bits in a second run (the cluster sums its partials in rank
    order)."""
    from maskcyclegan_vc_tpu_torch.ops import melspec

    g = torch.Generator(device=device).manual_seed(T)
    audio = torch.randn((3, 1024 + 256 * (T - 1) + 77), device=device, generator=g) * 0.3
    before = melspec.LOG_MEL_KERNEL.launches
    got = melspec.log_mel_spectrogram_fused(audio, pad=False)
    again = melspec.log_mel_spectrogram_fused(audio, pad=False)
    torch.cuda.synchronize()
    assert melspec.LOG_MEL_KERNEL.launches == before + 2
    assert got.shape == (3, 80, T) and torch.equal(got, again)
    torch.testing.assert_close(got, melspec.log_mel_spectrogram_plain(audio, pad=False),
                               **MEL_TOL)


def test_log_mel_kernel_nan_sample(device):
    """A NaN sample makes every mel of the four frames that hold it NaN,
    and no other, as in the plain version."""
    from maskcyclegan_vc_tpu_torch.ops import melspec

    g = torch.Generator(device=device).manual_seed(9)
    audio = torch.randn((2, 1024 + 256 * 99), device=device, generator=g) * 0.3
    audio[1, 256 * 33 + 5] = float("nan")  # frames 30-33, across a tile's edge
    got = melspec.log_mel_spectrogram_fused(audio, pad=False)
    want = melspec.log_mel_spectrogram_plain(audio, pad=False)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert got[1, :, 30:34].isnan().all() and not got[0].isnan().any()
    ok = ~want.isnan()
    torch.testing.assert_close(got[ok], want[ok], **MEL_TOL)


# ---------- K9, the MelGAN stage ----------
#
# Weights at unit gain (std 1/sqrt(fan_in)), so activations stay O(1) over
# the three blocks. Tolerance 1e-4 of the output's largest magnitude plus
# rtol 1e-4: a block sums up to 5C = 1280 f32 products per output in
# another order than cuDNN, and three blocks chain. The f32 kernel's margin
# on an H100 (PERF.md): its worst stage of a 431-frame decode lands 1.3e-6
# of the scale from the plain chain, ~75x inside, as the f32-core kernel
# before it did; with one tensor-core accumulator over a whole product
# (no f32 partial sums) it was 1.6e-5, ~6x inside.


def _stage(device, B, C, W, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=device, generator=g) * scale

    blocks = [{"conv1.weight": rnd(C, C, 3, scale=(3 * C) ** -0.5), "conv1.bias": rnd(C, scale=0.1),
               "conv2.weight": rnd(C, C, 1, scale=C ** -0.5), "conv2.bias": rnd(C, scale=0.1),
               "shortcut.weight": rnd(C, C, 1, scale=C ** -0.5),
               "shortcut.bias": rnd(C, scale=0.1)} for _ in range(3)]
    tail = (rnd(1, C, 7, scale=(7 * C) ** -0.5), rnd(1, scale=0.1))
    return rnd(B, C, W), blocks, tail


# The f32 kernel's tile: kTileOut outputs, max(C, 32) channels (C < 32
# padded with zero weights) x kTileOut / max(C, 32) positions, read from the
# source so that the edge cases follow the constant.
_K9_TILE = re.findall(r"constexpr int kTileOut = (\d+);",
                      (CSRC / "melgan_stack.cu").read_text())
assert len(_K9_TILE) == 1, "kTileOut not found once in csrc/melgan_stack.cu"


def _tile_positions(C):
    return int(_K9_TILE[0]) // max(C, 32)


# Every width the kernel takes at a whole number of its tiles and one position
# past it (a last tile of one position), and batches with a ragged last tile.
TILE_EDGES = ([(1, C, 3 * _tile_positions(C) + e) for C in (4, 8, 16, 32, 64, 128, 256)
               for e in (0, 1)]
              + [(3, 256, 3 * 32 + 5), (3, 128, 3 * 64 + 7), (2, 16, 3 * 256 + 3)])


# Stages no wider than the pad of 9, whose halo reflects again (a mel of 1
# frame reaches the first stage at W = 8).
NARROW = [(2, 256, 8), (1, 32, 1), (3, 64, 2), (1, 128, 5), (2, 16, 9)]


# The four stages of a 431-frame decode, then ragged, narrow and batched
# cases, then the tile edges. One f32 call counts one f32 launch and no bf16
# one.
@pytest.mark.parametrize("B, C, W", [(1, 256, 3448), (1, 128, 27584), (1, 64, 55168),
                                     (1, 32, 110336), (2, 256, 100), (1, 64, 10),
                                     (3, 32, 4099), (1, 4, 1025)] + NARROW + TILE_EDGES)
@pytest.mark.parametrize("mode", ["plain", "emit_lrelu", "tail"])
def test_melgan_stage_kernel(device, B, C, W, mode):
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    x, blocks, tail = _stage(device, B, C, W, C + W)
    kw = dict(emit_lrelu=mode == "emit_lrelu", tail=tail if mode == "tail" else None)
    before = _k9_launches()
    with torch.inference_mode():
        got = melgan_stack.melgan_resstack(x, blocks, **kw)
        torch.cuda.synchronize()
        want = melgan_stack.melgan_resstack_plain(x, blocks, **kw)
    assert _k9_launches() == (before[0] + 1, before[1])
    assert got.shape == want.shape == ((B, W) if mode == "tail" else (B, C, W))
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=1e-4)


@pytest.mark.parametrize("B, C, W", [(1, 256, 3448), (1, 128, 4099)])
def test_melgan_stage_kernel_offset_input(device, B, C, W):
    """x offset by +4, so lrelu(x) and x carry a large common part: products
    in TF32 alone (without the split's correction terms) miss the stage
    tolerance here by about 6x (tests/test_torch_port_melgan_tf32.py); the
    3xTF32 kernel must hold it."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    x, blocks, _ = _stage(device, B, C, W, 11 * C + W)
    x = x + 4.0
    before = _k9_launches()
    with torch.inference_mode():
        got = melgan_stack.melgan_resstack(x, blocks, emit_lrelu=True)
        torch.cuda.synchronize()
        want = melgan_stack.melgan_resstack_plain(x, blocks, emit_lrelu=True)
    assert _k9_launches() == (before[0] + 1, before[1])
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=1e-4)


@pytest.mark.parametrize("C", [256, 16])
@pytest.mark.parametrize("mode", ["emit_lrelu", "tail"])
def test_melgan_stage_kernel_nan_input(device, C, mode):
    """NaN in x, as the card makes it (0/0 gives 0x7FFFFFFF) and with the
    sign set (0xFFFFFFFF), at a tile's first position and inside another
    tile: the output is NaN exactly where the plain version's is (the TF32
    split must not round such a NaN to -0), and within the stage tolerance
    elsewhere. The plain version runs on the CPU, whose direct convolutions
    spread a NaN only over each output's receptive field."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    tw = _tile_positions(C)
    x, blocks, tail = _stage(device, 1, C, 6 * tw + 40, 5 * C)
    x[0, 1, 2 * tw] = torch.zeros((), device=device) / 0.0
    x.view(torch.int32)[0, C - 1, 4 * tw + 7] = -1  # 0xFFFFFFFF
    on_cpu = [{k: v.cpu() for k, v in bp.items()} for bp in blocks]
    with torch.inference_mode():
        if mode == "tail":
            got = melgan_stack.melgan_resstack(x, blocks, tail=tail).cpu()
            want = melgan_stack.melgan_resstack_plain(x.cpu(), on_cpu,
                                                      tail=tuple(t.cpu() for t in tail))
        else:
            got = melgan_stack.melgan_resstack(x, blocks, emit_lrelu=True).cpu()
            want = melgan_stack.melgan_resstack_plain(x.cpu(), on_cpu, emit_lrelu=True)
    nan = want.isnan()
    assert nan.any() and not nan.all()
    assert torch.equal(got.isnan(), nan)
    torch.testing.assert_close(got[~nan], want[~nan], atol=1e-4 * want[~nan].abs().max().item(),
                               rtol=1e-4)


def test_melgan_stage_reflect_edges(device):
    """Spikes 5 positions from the start and 3 from the end, where the d = 9
    taps read mirrored positions (-m -> m, W-1+m -> W-1-m): the kernel's
    mirror must be the plain chain's reflect pad."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    x, blocks, _ = _stage(device, 1, 8, 40, 1)
    x = torch.zeros_like(x)
    x[0, :, 5] = 1.0
    x[0, :, 36] = -2.0
    with torch.inference_mode():
        got = melgan_stack.melgan_resstack(x, blocks)
        want = melgan_stack.melgan_resstack_plain(x, blocks)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_vocoder_decode_on_the_card_matches_cpu(device):
    """The whole MelGAN (cuDNN up-convs, four K9 calls) on the card against
    the CPU plain path, at ngf 8: rounding only."""
    from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    cpu = MelGANGenerator(80, 8, generator=torch.Generator().manual_seed(3))
    gpu = MelGANGenerator(80, 8, device=device)
    gpu.load_state_dict(cpu.state_dict())
    mel = torch.randn(2, 80, 37, generator=torch.Generator().manual_seed(4))
    before = melgan_stack.MELGAN_STACK_KERNEL.launches
    with torch.inference_mode():
        got = gpu(mel.to(device)).cpu()
        want = cpu(mel)
    assert melgan_stack.MELGAN_STACK_KERNEL.launches == before + 4
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_vocoder_decodes_a_one_frame_mel_on_the_card(device):
    """A 1-frame mel reaches the first stage at W = 8, narrower than its pad
    of 9: all four stages still run K9, and the waveform equals the CPU's
    within the whole decode's bound."""
    from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    cpu = MelGANGenerator(80, 8, generator=torch.Generator().manual_seed(7))
    gpu = MelGANGenerator(80, 8, device=device)
    gpu.load_state_dict(cpu.state_dict())
    mel = torch.randn(2, 80, 1, generator=torch.Generator().manual_seed(8))
    before = melgan_stack.MELGAN_STACK_KERNEL.launches
    with torch.inference_mode():
        got = gpu(mel.to(device)).cpu()
        assert melgan_stack.MELGAN_STACK_KERNEL.launches == before + 4
        want = cpu(mel)
    assert got.shape == (2, 256)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_hifigan_v1_decode_on_the_card_matches_the_reference(device):
    """A published-width HiFi-GAN V1 decode of a 517-frame mel on the card
    (``melgan.decode_mel``: 78 cuDNN convolutions, no K9) against the plain
    reference (``portbench/reference/hifigan.py``) on the card, both f32 with
    TF32 off: only the convolutions' algorithms and the order of the bias
    add and of the MRF sum differ (sums of up to 512 x 7 products), so 1e-5
    of the waveform's peak."""
    from maskcyclegan_vc_tpu_torch.models import hifigan
    from maskcyclegan_vc_tpu_torch.models.melgan import decode_mel
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack
    from portbench import traffic
    from portbench.reference.hifigan import HiFiGAN

    ref = HiFiGAN(80, hifigan.V1)
    ref.load_state_dict(traffic.uniform_init(ref, "", torch.Generator().manual_seed(11), "cpu",
                                             weight_gain=1.5))
    ref = ref.to(device).eval()
    port = hifigan.HiFiGANGenerator(80, hifigan.V1, device=device).eval()
    port.load_state_dict(ref.state_dict())
    rs = np.random.RandomState(12)
    mel = rs.randn(1, 80, 517).astype(np.float32)
    mean = (rs.randn(80, 1) * 0.5 - 2.5).astype(np.float32)
    std = (rs.rand(80, 1) * 0.5 + 0.5).astype(np.float32)
    convs, k9 = dict(hifigan.CONVS), melgan_stack.MELGAN_STACK_KERNEL.launches
    got = decode_mel(port, mel, mean, std)
    assert {k: hifigan.CONVS[k] - convs[k] for k in hifigan.CONV_KINDS} == \
        {"pre": 1, "up": 4, "mrf": 72, "post": 1}
    assert melgan_stack.MELGAN_STACK_KERNEL.launches == k9
    with torch.no_grad():
        x = torch.from_numpy(mel * std + mean).to(device)
        want = ref(x * hifigan.LN10)
    assert got.shape == want.shape == (1, 517 * 256)
    assert 0.05 < float(want.abs().max()) < 0.99
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# ---------- the train step as CUDA-graph replays ----------
#
# Against the same steps run eagerly from the host. Batches bit for bit;
# losses to 1e-5 relative; Adam's first moments per leaf within the bounds
# chip_smoke.py holds the card against the CPU with (MOMENT_BOUND), though
# here only cuDNN's summation order and the capturable Adam's f32 bias
# corrections differ.
MOMENT_BOUND = {"g": 5e-3, "d": 1e-2}


def _tiny_training(device, remat=False, dtype=None, fused_norms=True):
    rs = np.random.RandomState(0)
    banks = [MelBank.from_list([rs.randn(16, t).astype(np.float32) for t in (40, 47, 52, 63)],
                               32, device) for _ in range(2)]
    sched = ScheduleConfig(n_samples=4, batch_size=1, stop_identity_after=2)
    cfg = TrainConfig(schedule=sched, n_mels=16, num_frames=32, residual_channels=8,
                      remat=remat, dtype=dtype, fused_norms=fused_norms)
    return cfg, banks


def _runner(cfg, banks, state):
    updates = {wi: make_update(cfg, wi) for wi in (True, False)}
    cutoff = cfg.schedule.stop_identity_after // cfg.schedule.batch_size
    return StepRunner(cfg, lambda step: updates[step <= cutoff], *banks, 0, 1, 32, 25)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_graph_batches_equal_the_eager_samplers(device, dtype):
    """Steps 0 and 3 run eagerly (each variant's first), 1, 2, 4 and 5 as
    replays."""
    cfg, banks = _tiny_training(device, dtype=dtype)
    state = create_train_state(cfg, 0, device, capturable=True)
    runner = _runner(cfg, banks, state)
    for step in range(6):
        runner.run(state, 1)
        torch.cuda.synchronize()
        want = sample_batch(step_generator(0, step, device), *banks, 1, 32, 25)
        for k, v in want.items():
            assert torch.equal(runner.batch[k], v), (step, k)
    assert runner.replays == 4


def _moment_errors(got, want, names):
    """Per leaf ||got - want|| over the leaf's norm or, for a bias, its
    layer's largest leaf norm (a bias ahead of an InstanceNorm has a
    gradient of rounding noise)."""
    norms = {n: want[n].norm().item() for n in names}
    layer = {}
    for n in names:
        layer[n.rsplit(".", 1)[0]] = max(layer.get(n.rsplit(".", 1)[0], 0.0), norms[n])
    return {n: (got[n] - want[n]).norm().item()
            / max(layer[n.rsplit(".", 1)[0]] if n.endswith("bias") else norms[n], 1e-30)
            for n in names}


def _first_moments(state, side):
    models, opt = (state.g, state.g_opt) if side == "g" else (state.d, state.d_opt)
    return {f"{m}.{n}": opt.state[p]["exp_avg"] for m, model in models.items()
            for n, p in model.named_parameters() if p in opt.state}


@pytest.mark.parametrize("remat", [False, True])
def test_graph_trajectory_matches_eager(device, remat):
    """Six steps: the identity variant's first eagerly, then two replays;
    past the cutoff the other variant's first eagerly, then two replays."""
    cfg, banks = _tiny_training(device, remat)
    eager = create_train_state(cfg, 0, device)
    graphed = create_train_state(cfg, 0, device, capturable=True)
    steps = {wi: make_train_step(cfg, wi) for wi in (True, False)}
    cutoff = cfg.schedule.stop_identity_after
    want = []
    for step in range(6):
        batch = sample_batch(step_generator(0, step, device), *banks, 1, 32, 25)
        _, m = steps[step <= cutoff](eager, batch)
        want.append([m[k].item() for k in LOGGED_METRICS])
    runner = _runner(cfg, banks, graphed)
    got = runner.run(graphed, 6).cpu().tolist()
    assert runner.replays == 4 and graphed.step == eager.step == 6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for side in ("g", "d"):
        a, b = _first_moments(graphed, side), _first_moments(eager, side)
        assert a.keys() == b.keys()
        errs = _moment_errors(a, b, list(b))
        assert max(errs.values()) < MOMENT_BOUND[side], max(errs.items(), key=lambda e: e[1])


# ---------- the train step on cuDNN's autotuned algorithms ----------
#
# At full width, 1 x 64, with deterministic cuDNN (whose autotuner then times
# deterministic engines only), in f32 and, though ``utils.device.autotunes``
# keeps bf16 steps on the heuristics, in bf16 with the autotuner forced on.
# ``StepRunner.run`` runs inside ``utils.device.autotune_scope``: its eager
# first step times every conv problem, its capture and its replays time
# nothing. The eager steps that the
# graph's are held against run afterwards, outside the scope, on the plans
# cuDNN cached for the same problems, and on a capturable state as the
# graph's is, so that only the graph differs: each loss within chip_smoke.py's
# bounds for steps as graph replays against steps a step at a time (f32 1e-5;
# bf16 1e-5 before any update, its DIST_BF16_RTOL after one).
AUTOTUNED_RTOL = {None: 1e-5, torch.bfloat16: 1e-3}


@pytest.fixture
def deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.fixture
def fresh_problems(monkeypatch):
    """A process's first conv problems, as ``conv.autotuned`` counts them;
    the runner's steps autotuned in either dtype."""
    from maskcyclegan_vc_tpu_torch.ops import layers
    from maskcyclegan_vc_tpu_torch.train import graphs
    from maskcyclegan_vc_tpu_torch.utils import device as device_mod

    mine = device_mod.ConvAutotune()
    monkeypatch.setattr(device_mod, "CONV_AUTOTUNE", mine)
    monkeypatch.setattr(layers, "CONV_AUTOTUNE", mine)
    monkeypatch.setattr(graphs, "autotunes", lambda dtype: True)
    return mine


def _full_width_training(device, dtype):
    rs = np.random.RandomState(0)
    banks = [MelBank.from_list([rs.randn(80, t).astype(np.float32) for t in (173, 260, 371, 517)],
                               64, device) for _ in range(2)]
    cfg = TrainConfig(schedule=ScheduleConfig(n_samples=4, batch_size=1), dtype=dtype)
    update = make_update(cfg)
    return cfg, banks, update, StepRunner(cfg, lambda step: update, *banks, 0, 1, 64, 25)


def _autotuned():
    from maskcyclegan_vc_tpu_torch.obs import profiler

    return profiler.counters().get("conv.autotuned", 0)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_autotuned_graph_steps_match_eager_steps(device, dtype, deterministic_cudnn,
                                                 fresh_problems):
    cfg, banks, update, runner = _full_width_training(device, dtype)
    graphed = create_train_state(cfg, 0, device, capturable=True)
    counts = []
    capture = runner.capture

    def counted(*args):
        counts.append(_autotuned())
        out = capture(*args)
        counts.append(_autotuned())
        return out

    runner.capture = counted
    n0 = _autotuned()
    got = runner.run(graphed, 3).cpu().numpy()
    runner.run(graphed, 10)
    torch.cuda.synchronize()
    assert runner.replays == 12 and torch.backends.cudnn.benchmark is False
    assert counts[0] > n0 and counts == [counts[0]] * 2 and _autotuned() == counts[0]
    assert counts[0] - n0 == len(fresh_problems.problems)
    eager = create_train_state(cfg, 0, device, capturable=True)
    step = make_train_step(cfg)
    want = []
    for i in range(3):
        _, m = step(eager, sample_batch(step_generator(0, i, device), *banks, 1, 64, 25))
        want.append([m[k].item() for k in LOGGED_METRICS])
    want = np.array(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1:], want[1:], rtol=AUTOTUNED_RTOL[dtype], atol=0)


def _snapshot(state):
    """(tensor, copy) of every parameter and Adam state tensor."""
    out = []
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                out.append((p, p.detach().clone()))
                out += [(v, v.clone()) for v in opt.state[p].values()
                        if isinstance(v, torch.Tensor)]
    return out


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_autotuned_replays_from_one_state_are_bit_identical(device, dtype, deterministic_cudnn,
                                                            fresh_problems):
    cfg, _, _, runner = _full_width_training(device, dtype)
    state = create_train_state(cfg, 0, device, capturable=True)
    runner.run(state, 1)  # eager, autotuned, then captured
    assert fresh_problems.problems
    saved = _snapshot(state)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)
        state.step = 1
        rows = runner.run(state, 1)
        runs.append((rows.cpu(), [t.detach().clone() for t, _ in saved]))
    assert runner.replays == 2
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert not all(torch.equal(a, v) for a, (_, v) in zip(runs[0][1], saved))


# ---------- the trainer's one loop, captured and not ----------

def test_trainer_scan_epochs_modes_run_one_adam(device, deterministic_cudnn, tmp_path):
    """Two trainers on the card, f32 1 x 64 at full width, --scan_epochs 1
    and 0, three steps each, with deterministic cuDNN: both states' Adams
    are capturable, the eager runner captures nothing, and the logged
    losses agree within 1e-5 relative, the bound chip_smoke.py's train
    phase holds the two CLI runs to."""
    from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker
    from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs

    rs = np.random.RandomState(0)
    for sid in ("SA", "SB"):
        save_speaker(str(tmp_path / "pre"), sid,
                     [rs.randn(80, t).astype(np.float32) for t in (173, 260, 371)],
                     rs.randn(80, 1).astype(np.float32),
                     (rs.rand(80, 1) + 0.5).astype(np.float32))
    losses, runners = {}, {}
    for scan in (True, False):
        trainer = Trainer(TrainerArgs(
            name=f"scan{int(scan)}", save_dir=str(tmp_path / "out"), speaker_A_id="SA",
            speaker_B_id="SB", preprocessed_data_dir=str(tmp_path / "pre"), num_epochs=1,
            batch_size=1, num_frames=64, epochs_per_save=100, epochs_per_plot=100,
            steps_per_print=1, async_save=False, scan_epochs=scan, device="cuda"))
        assert all(group["capturable"] for opt in (trainer.state.g_opt, trainer.state.d_opt)
                   for group in opt.param_groups)
        rows, log_iter = [], trainer.logger.log_iter

        def logged(step, epoch, row, rows=rows, log_iter=log_iter, **kw):
            rows.append([row[k] for k in LOGGED_METRICS])
            log_iter(step, epoch, row, **kw)

        trainer.logger.log_iter = logged
        trainer.train()
        losses[scan], runners[scan] = np.array(rows), trainer._runner
    assert losses[True].shape == losses[False].shape == (3, len(LOGGED_METRICS))
    assert runners[True].replays == 2 and runners[True].graph is not None
    assert runners[False].replays == 0 and runners[False].graph is None
    rel = np.abs(losses[True] - losses[False]) / np.abs(losses[False])
    print(f"--scan_epochs 1 against 0, f32 1 x 64, deterministic cuDNN: logged losses of "
          f"steps 1-3 within {rel.max():.3g} relative (bound 1e-5)")
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=0)


# ---------- the data-parallel step at a world of one card ----------

def test_grad_sync_step_at_world_one_equals_the_plain_step(device):
    """``parallel.mesh.explicit_sync_fns`` over an NCCL group of this one
    card, with deterministic cuDNN: three steps a step at a time, and six as
    CUDA-graph replays (the all-reduces captured), equal the unsynced steps
    bit for bit (losses and Adam's first moments): the bucket's premultiplied
    sum over one rank is x * 1.0 and the division is by 1."""
    import socket

    import torch.distributed as dist

    from maskcyclegan_vc_tpu_torch.parallel.mesh import explicit_sync_fns

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, banks = _tiny_training(device)
        grad_sync, metric_sync = explicit_sync_fns("float32")
        syncs = {"synced": dict(grad_sync=grad_sync, metric_sync=metric_sync), "plain": {}}
        eager, graphed = {}, {}
        for name, sync in syncs.items():
            state = create_train_state(cfg, 0, device)
            step = make_train_step(cfg, True, **sync)
            rows = []
            for i in range(3):
                _, m = step(state, sample_batch(step_generator(0, i, device), *banks, 1, 32, 25))
                rows.append([m[k].item() for k in LOGGED_METRICS])
            eager[name] = (rows, _first_moments(state, "g"), _first_moments(state, "d"))
            state = create_train_state(cfg, 0, device, capturable=True)
            updates = {wi: make_update(cfg, wi, **sync) for wi in (True, False)}
            cutoff = cfg.schedule.stop_identity_after
            runner = StepRunner(cfg, lambda s: updates[s <= cutoff], *banks, 0, 1, 32, 25)
            rows = runner.run(state, 6).cpu().tolist()
            assert runner.replays == 4
            graphed[name] = (rows, _first_moments(state, "g"), _first_moments(state, "d"))
        for runs in (eager, graphed):
            (rows, g, d), (want_rows, want_g, want_d) = runs["synced"], runs["plain"]
            assert rows == want_rows
            for got, want in ((g, want_g), (d, want_d)):
                assert got.keys() == want.keys()
                for k in want:
                    assert torch.equal(got[k], want[k]), k
    finally:
        torch.backends.cudnn.deterministic = saved
        dist.destroy_process_group()


def test_bf16_wire_at_world_one_rounds_the_gradients(device):
    """The bf16 wire over an NCCL group of this one card: the synced
    gradients are the raw ones rounded to bf16 (one rounding, 2**-8 of each
    value), not scaled, not zeroed."""
    import socket

    import torch.distributed as dist

    from maskcyclegan_vc_tpu_torch.parallel.mesh import explicit_sync_fns

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        grad_sync, metric_sync = explicit_sync_fns("bfloat16")
        g = torch.Generator(device=device).manual_seed(0)
        grads = [torch.randn(s, device=device, generator=g) * 1e-3 for s in ((7, 5), (300,))]
        got = grad_sync(grads)
        for a, b in zip(got, grads):
            assert a.dtype == torch.float32 and a.shape == b.shape
            assert torch.equal(a, b.bfloat16().float())
        m = {"g_loss": torch.tensor(3.5, device=device), "d_loss": torch.tensor(0.25, device=device)}
        assert {k: v.item() for k, v in metric_sync(m).items()} == {"g_loss": 3.5, "d_loss": 0.25}
    finally:
        dist.destroy_process_group()


# ---------- the bf16 entries ----------
#
# bf16 x, y, dy and dx; f32 vectors, statistics, dscale and dbias. Each bf16
# entry against its plain version on the same bf16 inputs: both compute in
# f32 and round once to bf16 (nearest even), so their outputs are at most
# one bf16 rounding apart, rtol 2**-7 plus atol 1e-5 for values that f32
# cancellation leaves near 0. K5's dx is computed from the dz it parks in dx
# rounded to bf16, which the two may round to neighbouring values: that
# difference reaches dx times a = scale * inv, so dx is held to 2**-6 of the
# larger of |dx| and |a dz| (``_k5_dx_bound``). f32 outputs as in f32. K6
# and K7 move bits: exact.
ONE_BF16 = dict(atol=1e-5, rtol=2 ** -7)
BF16_SHAPES = [(3, 5, 7), (2, 3, 4, 9), (1, 5120, 16), (2, 6, 1030), (1, 256, 40, 32),
               (2, 33, 1, 17)]


def _bf16_inputs(device, shape, C, n_vecs, seed):
    x, vecs = _inputs(device, shape, C, n_vecs, seed)
    return x.bfloat16(), vecs


def _entry_launches(kernel):
    """Launches of the f32 and the bf16 entry of ``kernel`` (an ENTRIES key)."""
    entries = in_gate.ENTRIES.get(kernel) or ps.ENTRIES[kernel]
    return entries[torch.float32].launches, entries[torch.bfloat16].launches


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("kind", [None, "full", "mixed"])
@pytest.mark.parametrize("kernel", ["in", "in_swish", "in_glu"])
def test_row_kernels_bf16(device, shape, kind, kernel):
    """K2, K3 and K1: bf16 in and out, the bf16 entry launched once and the
    f32 entry not at all."""
    C = shape[1]
    gated = kernel == "in_glu"
    x, vecs = _bf16_inputs(device, ((shape[0], 2 * C) + shape[2:]) if gated else shape, C,
                           4 if gated else 2, 20)
    lengths = _lengths(device, shape[0], shape[-1], kind)
    fn, plain = {"in": (in_gate.instance_norm, in_gate.instance_norm_plain),
                 "in_swish": (in_gate.instance_norm_swish, in_gate.instance_norm_swish_plain),
                 "in_glu": (in_gate.instance_norm_glu, in_gate.instance_norm_glu_plain)}[kernel]
    f32, bf16 = _entry_launches(kernel)
    got = fn(x, *vecs, lengths)
    torch.cuda.synchronize()
    assert _entry_launches(kernel) == (f32, bf16 + 1)
    want = plain(x, *vecs, lengths)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **ONE_BF16)


def test_single_valid_frame_bf16(device):
    """One valid frame in bf16: the f32 results differ by up to one rounding
    of |x*a| (``test_single_valid_frame``), then each rounds to bf16."""
    x, (s, b) = _bf16_inputs(device, (2, 6, 9), 6, 2, 4)
    lengths = torch.tensor([1, 1], dtype=torch.int32, device=device)
    got = in_gate.instance_norm(x, s, b, lengths)
    want = in_gate.instance_norm_plain(x, s, b, lengths)
    xa = (x[..., :1].float().abs() * s[None, :, None] / 1e-5 ** 0.5).max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=2 * xa * 2.0 ** -23 + 1e-5,
                               rtol=2 ** -7)
    assert not got[..., 1:].any()


@pytest.mark.parametrize("shape", [(2, 8, 3, 5), (3, 12, 4, 7), (1, 1024, 20, 16),
                                   (1, 512, 40, 32), (2, 132, 5, 9)])
@pytest.mark.parametrize("kind", [None, "mixed"])
def test_pixel_shuffle_in_swish_kernel_bf16(device, shape, kind):
    """K4's bf16 entry, with and without its f32 statistics."""
    x, (s, b) = _bf16_inputs(device, shape, shape[1] // 4, 2, 21)
    lengths = _lengths(device, shape[0], 2 * shape[-1], kind)
    before = _entry_launches("ps_in_swish")
    got = ps.pixel_shuffle_in_swish(x, s, b, lengths)
    y, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    torch.cuda.synchronize()
    assert _entry_launches("ps_in_swish") == (before[0], before[1] + 2)
    assert got.dtype == y.dtype == torch.bfloat16 and mean.dtype == inv.dtype == torch.float32
    torch.testing.assert_close(got.float(), ps.pixel_shuffle_in_swish_plain(x, s, b, lengths)
                               .float(), **ONE_BF16)
    torch.testing.assert_close(y.float(), ps.pixel_shuffle_in_swish_plain(x, s, b).float(),
                               **ONE_BF16)
    want_mean, want_inv = ps.pixel_shuffle_stats_plain(x)
    torch.testing.assert_close(mean, want_mean, **TOL)
    torch.testing.assert_close(inv, want_inv, **TOL)


def _k5_dx_bound(x, dy, s, b, mean, inv, dx):
    """1e-5 + 2**-6 max(|dx|, |a dz|), elementwise in x's layout, f32."""
    B, C4, H, W = x.shape
    xs = x.float().reshape(B, C4 // 4, -1)
    a = s[None, :, None] * inv[..., None]
    z = xs * a + (b[None, :, None] - mean[..., None] * a)
    sg = torch.sigmoid(z)
    dys = torch.nn.functional.pixel_unshuffle(dy.float(), 2).reshape(xs.shape)
    a_dz = (a * dys * (sg + z * sg * (1 - sg))).reshape(x.shape)
    return 1e-5 + 2 ** -6 * torch.maximum(dx.float().abs(), a_dz.abs())


@pytest.mark.parametrize("shape", [(1, 1024, 20, 16), (3, 1024, 20, 16), (1, 512, 40, 32),
                                   (2, 512, 40, 32), (3, 12, 5, 7), (1, 4, 1, 1)])
def test_pixel_shuffle_in_swish_backward_kernel_bf16(device, shape):
    """K5's bf16 entry against its plain version, which rounds the parked dz
    as K5 does, and against autograd through the plain forward, which does
    not: dx within ``_k5_dx_bound``; dscale and dbias as in f32."""
    B, C4, H, W = shape
    C = C4 // 4
    x, (s, b) = _bf16_inputs(device, shape, C, 2, 22)
    g = torch.Generator(device=device).manual_seed(23)
    dy = torch.randn((B, C, 2 * H, 2 * W), device=device, generator=g).bfloat16()
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    before = _entry_launches("ps_in_swish_bwd")
    dx, dsc, dbi = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    torch.cuda.synchronize()
    assert _entry_launches("ps_in_swish_bwd") == (before[0], before[1] + 1)
    assert dx.dtype == torch.bfloat16 and dsc.dtype == dbi.dtype == torch.float32
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    auto = torch.autograd.grad(ps.pixel_shuffle_in_swish_plain(xr, sr, br), (xr, sr, br), dy)
    bound = _k5_dx_bound(x, dy, s, b, mean, inv, want[0])
    dz = torch.nn.functional.pixel_unshuffle(dy.float(), 2).reshape(B, C, -1).abs()
    for ref in (want, auto):
        assert ((dx.float() - ref[0].float()).abs() <= bound).all()
        for got, r in ((dsc, ref[1]), (dbi, ref[2])):
            assert ((got - r).abs() <= _sum_bound(dz * 4.0)).all()


# As test_shuffle_kernels_exact, with W x 2 bytes exactly 16 and a base two
# elements (4 bytes) off a 16-byte boundary.
@pytest.mark.parametrize("shape, offset", [
    ((2, 12, 3, 5), 0), ((1, 8, 4, 7), 0), ((2, 8, 3, 8), 0), ((2, 8, 3, 4), 0),
    ((2, 1024, 20, 80), 0), ((2, 512, 40, 160), 0), ((1, 512, 40, 161), 0),
    ((1, 512, 40, 96), 0), ((2, 512, 40, 160), 2), ((2, 8, 3, 8), 2)])
def test_shuffle_kernels_exact_bf16(device, shape, offset):
    """K7 and K6 on bf16: bit-exact, dtype kept, the bf16 entries only."""
    x, y = _shuffle_inputs(device, shape, torch.bfloat16, offset, 24)
    before = _entry_launches("shuffle") + _entry_launches("inv_shuffle")
    route = _shuffle_route(shape, 2, offset)
    assert _check_shuffles(x, y) == {"shuffle": route, "inv_shuffle": route}
    assert _entry_launches("shuffle") + _entry_launches("inv_shuffle") == \
        (before[0], before[1] + 1, before[2], before[3] + 1)


def test_bf16_gradient_past_the_budget_takes_bf16_k6(device):
    """upSample2 at 1 x 320 in bf16: 6 x 2 x 512 x 40 x 160 bytes, past
    32 MiB, so the split route runs the bf16 K6; upSample1 there stays
    within it."""
    x, (s, b) = _bf16_inputs(device, (1, 512, 40, 160), 128, 2, 26)
    x.requires_grad_()
    assert ps.pixel_shuffle_in_swish_backward_bytes(x) > ps.BWD_BUDGET_BYTES
    up1 = torch.empty((1, 1024, 20, 80), dtype=torch.bfloat16, device="meta")
    assert ps.pixel_shuffle_in_swish_backward_bytes(up1) <= ps.BWD_BUDGET_BYTES
    before = _entry_launches("inv_shuffle") + _entry_launches("ps_in_swish_bwd")
    y = ps.pixel_shuffle_in_swish(x, s, b)
    dy = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert _entry_launches("inv_shuffle") + _entry_launches("ps_in_swish_bwd") == \
        (before[0], before[1] + 1, before[2], before[3])
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, ps.pixel_shuffle_in_swish_backward_split(x.detach(), dy, s, b)[0])


def test_wrappers_raise_on_bf16_vectors(device):
    x, (s, b) = _bf16_inputs(device, (1, 4, 8), 4, 2, 3)
    with pytest.raises(ValueError):  # the vectors are f32 in every entry
        in_gate.instance_norm(x, s.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):  # dy in another dtype than x
        ps.pixel_shuffle_in_swish_backward(
            torch.zeros((1, 8, 2, 3), dtype=torch.bfloat16, device=device),
            torch.zeros((1, 2, 4, 6), device=device), s[:2], b[:2],
            torch.zeros((1, 2), device=device), torch.ones((1, 2), device=device))


def _all_launches():
    """{(kernel, dtype): launches} over every entry of K1-K7."""
    return {(k, d): e.launches for k, entries in (*in_gate.ENTRIES.items(), *ps.ENTRIES.items())
            for d, e in entries.items()}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fused_norms_off_launches_no_kernel(device, dtype):
    """``fused_norms=False``: two train steps on the card run the plain
    versions and launch no entry of K1-K7. With the kernels the same steps
    launch only the entries of the compute dtype. The first step's losses
    agree: f32 to 1e-4 (summation order), bf16 to 2e-2 (the plain and kernel
    forms may round each norm's output to neighbouring bf16 values)."""
    losses = {}
    for fused in (False, True):
        cfg, banks = _tiny_training(device, dtype=dtype, fused_norms=fused)
        state = create_train_state(cfg, 0, device)
        step = make_train_step(cfg)
        before = _all_launches()
        for i in range(2):
            state, m = step(state, sample_batch(step_generator(0, i, device), *banks, 1, 32, 25))
            losses.setdefault(fused, [m[k].item() for k in LOGGED_METRICS])
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _all_launches().items()}
        want = dtype or torch.float32
        if fused:
            assert sum(launched.values()) > 0
            assert not any(n for (_, d), n in launched.items() if d != want)
        else:
            assert not any(launched.values())
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-2 if dtype else 1e-4)


# ---------- K9's bf16 form and the bf16 vocoder ----------
#
# The bf16 entry against the bf16 plain version on the card: both compute
# in f32 from the same bf16 values and round at the same points, so most
# elements are bit-equal; a sum within f32 rounding of a bf16 tie rounds
# one ulp apart, and the later blocks spread that ulp. Bound: two bf16
# roundings (2**-7 each) of the output's largest magnitude, the bound
# chip_smoke.py holds every call of the main path to.
TWO_BF16_OF_SCALE = 2 * 2 ** -7


def _k9_launches():
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    return tuple(melgan_stack.ENTRIES[d].launches for d in (torch.float32, torch.bfloat16))


# The bf16 kernel's tiles: kTileOutBf16 and kTileOutBf16Large outputs,
# max(C, 8) channels (C < 8 padded with zero weights) x TILE / max(C, 8)
# positions, read from the source as for the f32 kernel. A call takes the
# large tile where its grid gives every SM two thread blocks (132 SMs on an
# H100: 264 blocks).
_K9_TILES_BF16 = [re.findall(rf"constexpr int {name} = (\d+);",
                             (CSRC / "melgan_stack.cu").read_text())
                  for name in ("kTileOutBf16", "kTileOutBf16Large")]
assert all(len(t) == 1 for t in _K9_TILES_BF16), "the bf16 tiles not found once in melgan_stack.cu"


def _bf16_tile_positions(C, large=False):
    return int(_K9_TILES_BF16[int(large)][0]) // max(C, 8)


# Every width at a whole number of the small tiles and one position past it;
# a batch of 3 with a ragged last tile; and a batch of 66 at 4 large tiles
# and one position past (264 and 330 large tiles).
TILE_EDGES_BF16 = ([(1, C, 3 * _bf16_tile_positions(C) + e)
                    for C in (4, 8, 16, 32, 64, 128, 256) for e in (0, 1)]
                   + [(3, C, 2 * _bf16_tile_positions(C) + 5)
                      for C in (4, 8, 16, 32, 64, 128, 256)]
                   + [(66, C, 4 * _bf16_tile_positions(C, large=True) + e)
                      for C in (4, 8, 16, 32, 64, 128, 256) for e in (0, 1)])


@pytest.mark.parametrize("B, C, W", [(1, 256, 3448), (1, 128, 27584), (1, 64, 55168),
                                     (1, 32, 110336), (2, 256, 100), (1, 64, 10),
                                     (3, 32, 4099), (1, 4, 1025)] + NARROW
                         + TILE_EDGES_BF16)
@pytest.mark.parametrize("mode", ["plain", "emit_lrelu", "tail"])
@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_melgan_stage_kernel_bf16(device, B, C, W, mode, weights):
    """The bf16 entry, with f32 weights or with the bf16 ones the bf16
    vocoder passes, at the four stages of a 431-frame decode, ragged,
    narrow and batched cases and the tile edges: bf16 out, the bf16 entry
    launched once."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    x, blocks, tail = _stage(device, B, C, W, C + W + 1)
    if weights == "bf16":
        blocks = [{k: v.bfloat16() for k, v in b.items()} for b in blocks]
        tail = tuple(t.bfloat16() for t in tail)
    kw = dict(emit_lrelu=mode == "emit_lrelu", tail=tail if mode == "tail" else None)
    x = x.bfloat16()
    f32, bf16 = _k9_launches()
    with torch.inference_mode():
        got = melgan_stack.melgan_resstack(x, blocks, **kw)
        torch.cuda.synchronize()
        want = melgan_stack.melgan_resstack_plain_bf16(x, blocks, **kw)
    assert _k9_launches() == (f32, bf16 + 1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == ((B, W) if mode == "tail" else (B, C, W))
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TWO_BF16_OF_SCALE * scale)


@pytest.mark.parametrize("C", [256, 16])
@pytest.mark.parametrize("mode", ["emit_lrelu", "tail"])
def test_melgan_stage_kernel_nan_input_bf16(device, C, mode):
    """The bf16 twin of ``test_melgan_stage_kernel_nan_input``: a NaN (and
    one with the sign set, 0xFFFF) at a tile's first position and inside
    another tile reaches the output as NaN exactly where the plain
    version's is, with the bf16 entry launched once, and the rest is
    within two bf16 roundings of the scale."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    tw = _bf16_tile_positions(C)
    x, blocks, tail = _stage(device, 1, C, 6 * tw + 40, 5 * C + 1)
    x = x.bfloat16()
    x[0, 1, 2 * tw] = torch.zeros((), device=device) / 0.0
    x.view(torch.int16)[0, C - 1, 4 * tw + 7] = -1  # 0xFFFF
    on_cpu = [{k: v.cpu() for k, v in bp.items()} for bp in blocks]
    before = _k9_launches()
    with torch.inference_mode():
        if mode == "tail":
            got = melgan_stack.melgan_resstack(x, blocks, tail=tail).cpu()
            want = melgan_stack.melgan_resstack_plain_bf16(x.cpu(), on_cpu,
                                                           tail=tuple(t.cpu() for t in tail))
        else:
            got = melgan_stack.melgan_resstack(x, blocks, emit_lrelu=True).cpu()
            want = melgan_stack.melgan_resstack_plain_bf16(x.cpu(), on_cpu, emit_lrelu=True)
    assert _k9_launches() == (before[0], before[1] + 1)
    nan = want.isnan()
    assert nan.any() and not nan.all()
    assert torch.equal(got.isnan(), nan)
    scale = want[~nan].float().abs().max().item()
    torch.testing.assert_close(got[~nan].float(), want[~nan].float(), rtol=0,
                               atol=TWO_BF16_OF_SCALE * scale)


def test_melgan_stage_reflect_edges_bf16(device):
    """The mirrored halo in bf16: spikes near both ends, exact values that
    bf16 holds, so every rounding is on values the two sides share."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    _, blocks, _ = _stage(device, 1, 8, 40, 1)
    x = torch.zeros((1, 8, 40), dtype=torch.bfloat16, device=device)
    x[0, :, 5] = 1.0
    x[0, :, 36] = -2.0
    with torch.inference_mode():
        got = melgan_stack.melgan_resstack(x, blocks)
        want = melgan_stack.melgan_resstack_plain_bf16(x, blocks)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TWO_BF16_OF_SCALE * scale)


def test_melgan_stage_bf16_refuses_mixed_dtypes(device):
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack

    x, blocks, tail = _stage(device, 1, 8, 40, 2)
    mixed = [dict(b) for b in blocks]
    mixed[0]["conv1.bias"] = mixed[0]["conv1.bias"].bfloat16()
    before = _k9_launches()
    with torch.inference_mode():
        with pytest.raises(ValueError):
            melgan_stack.melgan_resstack(x.bfloat16(), mixed)
        with pytest.raises(ValueError):  # f32 x with bf16 weights
            melgan_stack.melgan_resstack(x, [{k: v.bfloat16() for k, v in b.items()}
                                             for b in blocks])
        with pytest.raises(ValueError):
            melgan_stack.melgan_resstack(x.half(), blocks)
    assert _k9_launches() == before


def test_bf16_vocoder_on_the_card(device):
    """The bf16 MelGAN (cuDNN bf16 convs, four bf16 K9 calls, no f32 one)
    against the CPU: within twice the CPU's own bf16-vs-f32 distance of the
    CPU's f32 decode, plus two bf16 roundings of the waveform's scale."""
    from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator

    cpu = MelGANGenerator(80, 8, generator=torch.Generator().manual_seed(5))
    cpu_bf16 = MelGANGenerator(80, 8, dtype=torch.bfloat16)
    gpu = MelGANGenerator(80, 8, device=device, dtype=torch.bfloat16)
    for m in (cpu_bf16, gpu):
        m.load_state_dict(cpu.state_dict())
    mel = torch.randn(2, 80, 37, generator=torch.Generator().manual_seed(6))
    before = _k9_launches()
    with torch.inference_mode():
        got = gpu(mel.to(device))
        torch.cuda.synchronize()
        want, want_bf16 = cpu(mel), cpu_bf16(mel)
    assert _k9_launches() == (before[0], before[1] + 4)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 37 * 256)
    got = got.float().cpu()
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    band = (want_bf16.float() - want).abs().max().item()
    assert (got - want).abs().max().item() <= 2 * band + TWO_BF16_OF_SCALE * want.abs().max()


# ---------- K4 and K5 by route ----------
#
# Each launch stages its (sample, channel) row in shared memory by one bulk
# copy (the block's threads copy the under-16-byte head and tail of a row
# that starts or ends off a 16-byte boundary). A K4 row larger than a
# block's shared memory streams from device memory; K5, whose x row and dy
# plane must fit together, refuses it. Tolerances as above: TOL in f32,
# ONE_BF16 (K5's dx ``_k5_dx_bound``) in bf16, dscale and dbias
# ``_sum_bound``.

def _check_k4(x, s, b, lengths, route):
    dtype = x.dtype
    tol = TOL if dtype == torch.float32 else ONE_BF16
    before = dict(ps.ROUTES[dtype])
    got = ps.pixel_shuffle_in_swish(x, s, b, lengths)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in ps.ROUTES[dtype].items()} == {
        r: int(r == route) for r in ps.ROUTE_NAMES}
    want = ps.pixel_shuffle_in_swish_plain(x, s, b, lengths)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)
    return got


def _check_k5(x, dy, s, b):
    B, C4, H, W = x.shape
    C = C4 // 4
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    entry = ps.ENTRIES["ps_in_swish_bwd"][x.dtype]
    before = entry.launches
    dx, dsc, dbi = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    want = ps.pixel_shuffle_in_swish_backward_plain(x, dy, s, b, mean, inv)
    xr, sr, br = (t.clone().requires_grad_() for t in (x, s, b))
    auto = torch.autograd.grad(ps.pixel_shuffle_in_swish_plain(xr, sr, br), (xr, sr, br), dy)
    dz = torch.nn.functional.pixel_unshuffle(dy.float(), 2).reshape(B, C, -1).abs()
    for ref in (want, auto):
        if x.dtype == torch.float32:
            torch.testing.assert_close(dx, ref[0], **TOL)
        else:
            bound = _k5_dx_bound(x, dy, s, b, mean, inv, want[0])
            assert ((dx.float() - ref[0].float()).abs() <= bound).all()
        for got, r in ((dsc, ref[1]), (dbi, ref[2])):
            assert ((got - r).abs() <= _sum_bound(dz * 4.0)).all()
    return dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 1024, 20, 32), (32, 512, 40, 64)])
def test_k4_k5_at_the_32x128_sites(device, dtype, shape):
    """upSample1 and upSample2 of a 32 x 128 step, both bulk-copied."""
    B, C4, H, W = shape
    x, (s, b) = _inputs(device, shape, C4 // 4, 2, 30)
    x = x.to(dtype)
    g = torch.Generator(device=device).manual_seed(31)
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device, generator=g).to(dtype)
    _check_k4(x, s, b, None, "bulk")
    _check_k5(x, dy, s, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("past", [0, 1])
def test_rows_at_the_shared_memory_limit(device, dtype, past):
    """A row of exactly the limit's bytes is bulk-copied; one element pair
    past it (W odd, so scalar accesses) streams. K5's x row and dy plane of
    exactly the limit together run; one element pair past it is refused."""
    limit = ps.smem_limit_bytes(device)
    esize = torch.finfo(dtype).bits // 8
    W = limit // (4 * esize)
    assert 4 * W * esize == limit
    x, (s, b) = _inputs(device, (2, 4, 1, W + past), 1, 2, 32)
    x = x.to(dtype)
    lengths = torch.tensor([2 * W - 3, W], dtype=torch.int32, device=device)
    route = "stream" if past else "bulk"
    _check_k4(x, s, b, None, route)
    _check_k4(x, s, b, lengths, route)
    Wb = W // 2
    xb, _ = _inputs(device, (1, 4, 1, Wb + past), 1, 2, 33)
    xb = xb.to(dtype)
    dy = torch.randn((1, 1, 2, 2 * (Wb + past)), device=device).to(dtype)
    if not past:
        _check_k5(xb, dy, s, b)
        return
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(xb, s, b)
    entry = ps.ENTRIES["ps_in_swish_bwd"][dtype]
    before = entry.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        ps.pixel_shuffle_in_swish_backward(xb, dy, s, b, mean, inv)
    assert entry.launches == before


@pytest.mark.parametrize("dtype, frames", [(torch.float32, 1024), (torch.bfloat16, 2048)])
def test_streaming_rows_at_upsample2(device, dtype, frames):
    """The upSample2 row of a 1 x ``frames`` crop, 320 KB, past a block's
    shared memory: 16-byte accesses from device memory, unmasked and
    masked."""
    shape = (1, 512, 40, frames // 2)
    x, (s, b) = _inputs(device, shape, 128, 2, 34)
    x = x.to(dtype)
    _check_k4(x, s, b, None, "stream")
    _check_k4(x, s, b, torch.tensor([frames - 5], dtype=torch.int32, device=device), "stream")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 20, 16), (3, 12, 5, 8)])
def test_aligned_row_beside_a_misaligned_row(device, dtype, shape):
    """The same values from an aligned tensor and from one whose start is 4
    bytes off (its rows bulk-copied between their 16-byte boundaries, the
    head and tail by the block's threads, scalar accesses): each against the
    plain version, and bit for bit against each other."""
    B, C4, H, W = shape
    n = B * C4 * H * W
    x, (s, b) = _inputs(device, shape, C4 // 4, 2, 35)
    x = x.to(dtype)
    shift = 4 // x.element_size()
    buf = torch.empty(n + shift, device=device, dtype=dtype)
    off = buf[shift:].view(shape)
    off.copy_(x)
    g = torch.Generator(device=device).manual_seed(36)
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device, generator=g).to(dtype)
    dbuf = torch.empty(dy.numel() + shift, device=device, dtype=dtype)
    dy_off = dbuf[shift:].view(dy.shape)
    dy_off.copy_(dy)
    lengths = torch.tensor([2 * W - 1, W + 1, 3][:B], dtype=torch.int32, device=device)
    for lens in (None, lengths):
        y_aligned = _check_k4(x, s, b, lens, "bulk")
        y_off = _check_k4(off, s, b, lens, "bulk")
        assert torch.equal(y_aligned, y_off)
    dx_aligned = _check_k5(x, dy, s, b)
    dx_off = _check_k5(off, dy_off, s, b)
    assert torch.equal(dx_aligned, dx_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [((2, 1024, 20, 112), (216, 150)),
                                  ((2, 512, 40, 224), (431, 300))])
def test_masked_conversion_sites(device, dtype, site):
    """upSample1 and upSample2 of a 448-frame conversion bucket, lengths of
    431 valid frames (216 at upSample1) beside a shorter one."""
    shape, lens = site
    x, (s, b) = _inputs(device, shape, shape[1] // 4, 2, 37)
    x = x.to(dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    y = _check_k4(x, s, b, lengths, "bulk")
    assert not y[0, :, :, lens[0]:].any() and not y[1, :, :, lens[1]:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 20, 16), (1, 8, 3, 5)])
def test_nan_reaches_y_and_dx(device, dtype, shape):
    """A NaN in one channel's input makes that channel's outputs and input
    gradients NaN, and no other channel's."""
    B, C4, H, W = shape
    x, (s, b) = _inputs(device, shape, C4 // 4, 2, 38)
    x = x.to(dtype)
    x[0, 1, H - 1, W - 1] = float("nan")
    g = torch.Generator(device=device).manual_seed(39)
    dy = torch.randn((B, C4 // 4, 2 * H, 2 * W), device=device, generator=g).to(dtype)
    y = ps.pixel_shuffle_in_swish(x, s, b)
    _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x, s, b)
    dx = ps.pixel_shuffle_in_swish_backward(x, dy, s, b, mean, inv)[0]
    torch.cuda.synchronize()
    assert y[0, 0].isnan().all() and dx[0, :4].isnan().all()
    assert torch.isfinite(y[0, 1:]).all() and torch.isfinite(y[1:]).all()
    assert torch.isfinite(dx[0, 4:]).all() and torch.isfinite(dx[1:]).all()


# ---------- K1, K2 and K3: rows staged once in shared memory ----------
#
# Each launch's route, as the C entry reports it (in_gate.ROUTES): the rows
# bulk-copied into shared memory, or each row streamed from device memory
# where it is larger than a block's shared memory. Every site of a 32 x 128
# step, of a 1 x 64 step and of a 448-frame conversion takes the first.
# Tolerances as above: TOL in f32, ONE_BF16 in bf16.

ROW_KERNELS = {"in_glu": (in_gate.instance_norm_glu, in_gate.instance_norm_glu_plain, 2),
               "in": (in_gate.instance_norm, in_gate.instance_norm_plain, 1),
               "in_swish": (in_gate.instance_norm_swish, in_gate.instance_norm_swish_plain, 1)}


def _row_inputs(device, kernel, shape, dtype, seed):
    """x of the kernel's input ``shape`` in ``dtype``, and its f32 vectors."""
    arrays = ROW_KERNELS[kernel][2]
    x, vecs = _inputs(device, shape, shape[1] // arrays, 2 * arrays, seed)
    return x.to(dtype), vecs


def _check_rows(kernel, x, vecs, lengths, route):
    """One launch of K1, K2 or K3 on x: its entry's count and the route
    taken go up by one, and y is within the tolerance of the plain
    version."""
    fn, plain, _ = ROW_KERNELS[kernel]
    dtype = x.dtype
    routes, entry = in_gate.ROUTES[kernel][dtype], in_gate.ENTRIES[kernel][dtype]
    before, launches = dict(routes), entry.launches
    got = fn(x, *vecs, lengths)
    torch.cuda.synchronize()
    assert entry.launches == launches + 1
    assert {r: n - before[r] for r, n in routes.items()} == {
        r: int(r == route) for r in in_gate.ROUTE_NAMES}
    want = plain(x, *vecs, lengths)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if dtype == torch.float32 else ONE_BF16))
    return got


# K1: the generator's downSample1, downSample2 and residual inputs; K3: the
# discriminator's downSample1-3 inputs; at 32 x 128.
ROW_SITES_32X128 = [("in_glu", (32, 512, 40, 64)), ("in_glu", (32, 512, 20, 32)),
                    ("in_glu", (32, 1024, 32)), ("in_swish", (32, 256, 40, 64)),
                    ("in_swish", (32, 512, 20, 32)), ("in_swish", (32, 1024, 10, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", ROW_SITES_32X128)
def test_k1_k3_at_the_32x128_sites(device, dtype, site):
    """Each K1 and K3 site of a 32 x 128 step, bulk-copied, unmasked and
    with lengths one frame short and of half the frames."""
    kernel, shape = site
    x, vecs = _row_inputs(device, kernel, shape, dtype, 40)
    W = shape[-1]
    lengths = torch.tensor([W - 1, W // 2] * (shape[0] // 2), dtype=torch.int32, device=device)
    _check_rows(kernel, x, vecs, None, "bulk")
    _check_rows(kernel, x, vecs, lengths, "bulk")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("past", [0, 1])
def test_k1_k3_rows_at_the_shared_memory_limit(device, dtype, kernel, past):
    """K1, K2 and K3. A row (K1: an h row and a g row) of exactly the limit's bytes is
    bulk-copied; one element longer (W odd, so scalar accesses) it streams
    from device memory. Unmasked and masked."""
    limit = in_gate.smem_limit_bytes(device)
    arrays = ROW_KERNELS[kernel][2]
    esize = torch.finfo(dtype).bits // 8
    S = limit // (arrays * esize)
    assert arrays * S * esize == limit
    x, vecs = _row_inputs(device, kernel, (2, arrays, S + past), dtype, 41)
    lengths = torch.tensor([S + past - 3, S // 2], dtype=torch.int32, device=device)
    route = "stream" if past else "bulk"
    _check_rows(kernel, x, vecs, None, route)
    _check_rows(kernel, x, vecs, lengths, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("shape", [(2, 512, 20, 16), (3, 24, 5, 9), (2, 1024, 16)])
def test_k1_k3_aligned_row_beside_a_misaligned_row(device, dtype, kernel, shape):
    """K1, K2 and K3. The same values from an aligned tensor and from one whose start is 4
    bytes off (its runs bulk-copied between their 16-byte boundaries, the
    head and tail by the block's threads, scalar accesses): each against
    the plain version, and bit for bit against each other."""
    x, vecs = _row_inputs(device, kernel, shape, dtype, 42)
    shift = 4 // x.element_size()
    buf = torch.empty(x.numel() + shift, device=device, dtype=dtype)
    off = buf[shift:].view(shape)
    off.copy_(x)
    W = shape[-1]
    lengths = torch.tensor([W - 1, W // 2 + 1, 0][:shape[0]], dtype=torch.int32, device=device)
    for lens in (None, lengths):
        y_aligned = _check_rows(kernel, x, vecs, lens, "bulk")
        y_off = _check_rows(kernel, off, vecs, lens, "bulk")
        assert torch.equal(y_aligned, y_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [((2, 512, 40, 224), (216, 150)),
                                  ((2, 512, 20, 112), (108, 75)),
                                  ((2, 1024, 112), (108, 75))])
def test_k1_masked_conversion_sites(device, dtype, site):
    """K1's downSample1, downSample2 and residual inputs of a 448-frame
    conversion bucket, lengths of 431 valid frames beside a shorter one:
    bulk-copied, zeros past each sample's frames."""
    shape, lens = site
    x, vecs = _row_inputs(device, "in_glu", shape, dtype, 43)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    y = _check_rows("in_glu", x, vecs, lengths, "bulk")
    assert not y[0, ..., lens[0]:].any() and not y[1, ..., lens[1]:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("shape", [(2, 512, 20, 16), (2, 1024, 16), (1, 8, 3, 5)])
def test_k1_k3_nan_reaches_y(device, dtype, kernel, shape):
    """A NaN in one row's input makes that row's outputs NaN (K1: in an h
    row, and in another channel's g row), and no other row's."""
    x, vecs = _row_inputs(device, kernel, shape, dtype, 44)
    C = shape[1] // ROW_KERNELS[kernel][2]
    x[0, 1].view(-1)[-1] = float("nan")
    bad = [1]
    if kernel == "in_glu":
        x[0, C + 2].view(-1)[0] = float("nan")
        bad.append(2)
    y = ROW_KERNELS[kernel][0](x, *vecs)
    torch.cuda.synchronize()
    good = [c for c in range(C) if c not in bad]
    assert y[0, bad].isnan().all()
    assert torch.isfinite(y[0, good]).all() and torch.isfinite(y[1:]).all()


# K2's sites: the generator's 2d/1d bridge norms (7 a forward, C = 256) and
# the 1d/2d one (1, C = 5120), at 32 x 128 (32 frames), at 1 x 64 (16
# frames, batches 1-3) and in a 448-frame conversion bucket (112 frames).
K2_SITES = [(32, 256, 32), (32, 5120, 32), (1, 256, 16), (2, 5120, 16), (3, 256, 16),
            (1, 256, 112), (2, 5120, 112)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SITES)
def test_k2_main_path_sites(device, dtype, shape):
    """K2 at every main-path shape: bulk-copied, unmasked and with lengths
    one frame short, of half the frames and, in a batch of two or more,
    of 0; zeros past each sample's frames."""
    x, vecs = _row_inputs(device, "in", shape, dtype, 45)
    W = shape[-1]
    lens = [W - 1, W // 2, 0][:shape[0]] + [W - 1] * max(0, shape[0] - 3)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    _check_rows("in", x, vecs, None, "bulk")
    y = _check_rows("in", x, vecs, lengths, "bulk")
    for b, n in enumerate(lens):
        assert not y[b, :, n:].any()


@pytest.mark.parametrize("shape", [(2, 7, 13), (3, 5, 3, 7), (2, 256, 31)])
def test_k2_bf16_rows_of_odd_length(device, shape):
    """K2 in bf16 with S odd, so every other row starts off a 16-byte
    boundary: bulk-copied with the head and tail copied by the threads,
    scalar accesses; unmasked and masked."""
    x, vecs = _row_inputs(device, "in", shape, torch.bfloat16, 46)
    W = shape[-1]
    lengths = torch.tensor([W, W // 2 + 1, 1][:shape[0]], dtype=torch.int32, device=device)
    _check_rows("in", x, vecs, None, "bulk")
    _check_rows("in", x, vecs, lengths, "bulk")


# ---------- K1, K2 and K3's backwards: in_backward_kernel ----------
#
# Each backward entry against the plain formulas (the JAX package's
# custom_vjp backwards, ``*_backward_plain``) on the same x and dy. dx: TOL
# in f32, ONE_BF16 in bf16 (both compute in f32 from the same values and
# round dx once). dscale and dbias: each row's sums of dz * xhat and dz,
# summed again over the batch, in another order than the plain version's,
# so held to 1e-5 of the sum of the terms' magnitudes (``_bwd_bound``).

BWD = {"in_glu": (in_gate.instance_norm_glu_backward, in_gate.instance_norm_glu_backward_plain),
       "in": (in_gate.instance_norm_backward, in_gate.instance_norm_backward_plain),
       "in_swish": (in_gate.instance_norm_swish_backward,
                    in_gate.instance_norm_swish_backward_plain)}


def _bwd_bound(kernel, x, dy, vecs):
    """1e-5 of sum |dz| (1 + |xhat|) per channel for each array (K1: h's,
    then g's), in the order of the (dscale, dbias) outputs."""
    arrays = ROW_KERNELS[kernel][2]
    xs = x.float().reshape(x.shape[0], x.shape[1], -1)
    xhat = (xs - xs.mean(-1, keepdim=True)) * torch.rsqrt(xs.var(-1, unbiased=False,
                                                                 keepdim=True) + 1e-5)
    d = dy.float().reshape(dy.shape[0], dy.shape[1], -1)
    C = d.shape[1]
    hat = list(xhat.split(C, dim=1))
    z = [hat[a] * vecs[2 * a][:, None] + vecs[2 * a + 1][:, None] for a in range(arrays)]
    if kernel == "in":
        dz = [d]
    elif kernel == "in_swish":
        s = torch.sigmoid(z[0])
        dz = [d * (s + z[0] * s * (1 - s))]
    else:
        s = torch.sigmoid(z[1])
        dz = [d * s, d * z[0] * s * (1 - s)]
    out = []
    for a in range(arrays):
        b = 1e-5 * (dz[a].abs() * (1 + hat[a].abs())).sum((0, 2))
        out += [b, b]
    return out


def _check_bwd(kernel, x, dy, vecs, route="bulk"):
    """One launch of the backward entry of ``kernel`` on (x, dy): its count
    and route go up by one, and its outputs are within their bounds of
    the plain formulas'. Returns the outputs."""
    fn, plain = BWD[kernel]
    dtype = x.dtype
    name = f"{kernel}_bwd"
    routes, entry = in_gate.ROUTES[name][dtype], in_gate.ENTRIES[name][dtype]
    before, launches = dict(routes), entry.launches
    got = fn(x, dy, *vecs)
    torch.cuda.synchronize()
    assert entry.launches == launches + 1
    assert {r: n - before[r] for r, n in routes.items()} == {
        r: int(r == route) for r in in_gate.ROUTE_NAMES}
    want = plain(x, dy.contiguous(), *vecs)
    assert got[0].dtype == want[0].dtype == dtype and got[0].shape == x.shape
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **(TOL if dtype == torch.float32 else ONE_BF16))
    for g, w, bound in zip(got[1:], want[1:], _bwd_bound(kernel, x, dy, vecs)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert ((g - w).abs() <= bound).all(), ((g - w).abs() / bound).max().item()
    return got


def _bwd_inputs(device, kernel, shape, dtype, seed):
    """x of the forward's input ``shape``, its vectors (scales in [0.5,
    1.5), biases in [-1, 1)) and a dy of the output's shape, in ``dtype``."""
    arrays = ROW_KERNELS[kernel][2]
    C = shape[1] // arrays
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, device=device, generator=g) * 2.0 + 0.5).to(dtype)
    vecs = []
    for i in range(2 * arrays):
        v = torch.rand(C, device=device, generator=g)
        vecs.append(v + 0.5 if i % 2 == 0 else v * 2.0 - 1.0)
    dy = torch.randn((shape[0], C) + tuple(shape[2:]), device=device, generator=g).to(dtype)
    return x, vecs, dy


# The backward sites of a training step: the forwards with grad at 1 x 64
# (pair_forwards: G at batch 1, 2 and 3; D at 1 and 2) and at 32 x 128.
BWD_SITES = [("in_glu", (3, 512, 40, 32)), ("in_glu", (2, 512, 20, 16)),
             ("in_glu", (1, 1024, 16)), ("in", (3, 256, 16)), ("in", (1, 5120, 16)),
             ("in_swish", (1, 256, 40, 32)), ("in_swish", (2, 512, 20, 16)),
             ("in_swish", (2, 1024, 10, 8)),
             ("in_glu", (32, 512, 40, 64)), ("in_glu", (32, 512, 20, 32)),
             ("in_glu", (32, 1024, 32)), ("in", (32, 256, 32)), ("in", (32, 5120, 32)),
             ("in_swish", (32, 256, 40, 64)), ("in_swish", (32, 512, 20, 32)),
             ("in_swish", (32, 1024, 10, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", BWD_SITES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in BWD_SITES])
def test_k1_k3_backward_main_path_sites(device, dtype, site):
    """Every K1, K2 and K3 backward site of a 1 x 64 and a 32 x 128 step:
    bulk-copied with 16-byte accesses, within the bounds of the plain
    formulas, and the same bits from a second launch."""
    kernel, shape = site
    x, vecs, dy = _bwd_inputs(device, kernel, shape, dtype, 50)
    got = _check_bwd(kernel, x, dy, vecs)
    again = BWD[kernel][0](x, dy, *vecs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
@pytest.mark.parametrize("shape", [(2, 7, 13), (3, 24, 5, 9), (2, 10, 3, 5), (1, 4, 1, 1)])
def test_k1_k3_backward_odd_rows(device, dtype, kernel, shape):
    """S odd (every other bf16 row off a 16-byte boundary: its runs
    bulk-copied between their boundaries, the head and tail by the
    threads, scalar accesses, a ragged unit at each line's end) and a row
    of one element."""
    shape = (shape[0], shape[1] * ROW_KERNELS[kernel][2]) + shape[2:]
    x, vecs, dy = _bwd_inputs(device, kernel, shape, dtype, 51)
    _check_bwd(kernel, x, dy, vecs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_k1_k3_backward_past_the_shared_memory_limit(device, dtype, kernel):
    """A row whose x and dy rows together pass a block's shared memory
    streams from device memory (W odd, so scalar accesses); one 64 bytes
    an array inside the limit is bulk-copied."""
    limit = in_gate.smem_limit_bytes(device)
    arrays = ROW_KERNELS[kernel][2]
    esize = torch.finfo(dtype).bits // 8
    S = limit // ((arrays + 1) * esize)
    for n, route in ((S - 64 // esize, "bulk"), (S + 1 + S % 2, "stream")):
        x, vecs, dy = _bwd_inputs(device, kernel, (2, arrays, n), dtype, 52)
        _check_bwd(kernel, x, dy, vecs, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_k1_k3_backward_noncontiguous_dy(device, dtype, kernel):
    """dy a batch slice of a larger gradient laid out batch-minor, as the
    paired forwards' out[:B] hands it over: made contiguous, then the same
    bits as from a contiguous copy."""
    shape = (2, 8 * ROW_KERNELS[kernel][2], 4, 6)
    x, vecs, _ = _bwd_inputs(device, kernel, shape, dtype, 53)
    big = torch.randn((4, 8, 4, 6), device=device).to(dtype)
    dy = big.transpose(0, 1).contiguous().transpose(0, 1)[:2]
    assert not dy.is_contiguous()
    got = _check_bwd(kernel, x, dy, vecs)
    want = BWD[kernel][0](x, dy.contiguous(), *vecs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_k1_k3_backward_aligned_beside_misaligned(device, dtype, kernel):
    """x and dy 4 bytes off a 16-byte boundary: scalar accesses, the same
    bits as from aligned tensors."""
    shape = (2, 24 * ROW_KERNELS[kernel][2], 5, 16)
    x, vecs, dy = _bwd_inputs(device, kernel, shape, dtype, 54)
    shift = 4 // x.element_size()
    off = []
    for t in (x, dy):
        buf = torch.empty(t.numel() + shift, device=device, dtype=dtype)
        off.append(buf[shift:].view(t.shape))
        off[-1].copy_(t)
    aligned = _check_bwd(kernel, x, dy, vecs)
    shifted = _check_bwd(kernel, off[0], off[1], vecs)
    assert all(torch.equal(a, b) for a, b in zip(aligned, shifted))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["in_glu", "in", "in_swish"])
def test_k1_k3_backward_nan_stays_in_its_row(device, dtype, kernel):
    """A NaN in one row of x makes that row's dx NaN (K1: the pair's h and
    g rows, the gate's NaN reaching both) and that channel's dscale, and no
    other row's dx."""
    shape = (2, 16 * ROW_KERNELS[kernel][2], 20, 16)
    x, vecs, dy = _bwd_inputs(device, kernel, shape, dtype, 55)
    C = 16
    x[0, 1].view(-1)[-1] = float("nan")
    out = BWD[kernel][0](x, dy, *vecs)
    torch.cuda.synchronize()
    dx = out[0]
    rows = [1] + ([C + 1] if kernel == "in_glu" else [])
    assert dx[0, rows].isnan().all()
    good = [c for c in range(dx.shape[1]) if c not in rows]
    assert torch.isfinite(dx[0, good]).all() and torch.isfinite(dx[1:]).all()
    assert out[1][1].isnan() and torch.isfinite(out[1][2:]).all()


def test_k1_k3_backward_routes_equal_forwards_with_grad(device, monkeypatch):
    """One training step captured as a CUDA graph (after the first, eager)
    and replayed: each K1-K3 backward entry's ROUTES count, over the eager
    step and the capture, equals the number of its forward's launches that
    recorded a gradient, all on the bulk route; the replays run no
    wrapper, and the plain formulas never run on the card."""
    seen = {}
    for fn_cls, k in ((in_gate._InstanceNormFn, "in"), (in_gate._InstanceNormSwishFn, "in_swish"),
                      (in_gate._InstanceNormGluFn, "in_glu")):
        def forward(ctx, x, *vecs, _real=fn_cls.forward, _k=k):
            seen[(_k, x.dtype)] = seen.get((_k, x.dtype), 0) + 1
            return _real(ctx, x, *vecs)
        monkeypatch.setattr(fn_cls, "forward", staticmethod(forward))
    plain_on_card = []
    real_normalized = in_gate._normalized

    def normalized(x):
        if x.device.type == "cuda":
            plain_on_card.append(tuple(x.shape))
        return real_normalized(x)

    monkeypatch.setattr(in_gate, "_normalized", normalized)
    for dtype in (None, torch.bfloat16):
        cfg, banks = _tiny_training(device, dtype=dtype)
        state = create_train_state(cfg, 0, device, capturable=True)
        runner = _runner(cfg, banks, state)
        dt = dtype or torch.float32
        before = {k: dict(in_gate.ROUTES[f"{k}_bwd"][dt]) for k in BWD}
        seen.clear()
        runner.run(state, 1)
        after_capture = {k: dict(in_gate.ROUTES[f"{k}_bwd"][dt]) for k in BWD}
        rows = runner.run(state, 2)
        torch.cuda.synchronize()
        assert runner.replays == 2 and torch.isfinite(rows).all()
        for k in BWD:
            got = {r: n - before[k][r] for r, n in in_gate.ROUTES[f"{k}_bwd"][dt].items()}
            assert got == {"bulk": seen[(k, dt)], "stream": 0}, (k, dtype, got, seen)
            assert in_gate.ROUTES[f"{k}_bwd"][dt] == after_capture[k]
    assert not plain_on_card


# ---------- nan_debug_mode and the trace on the card ----------

def _kernel_calls(device, dtype):
    """{name: call} of one finite call of each kernel entry of ``dtype``:
    K1-K3 (unmasked and masked), K4 then K5 through autograd (K5 on
    autograd's device thread), K5 and K6, K7 called directly, K8 (f32 only)
    and K9 without and with the tail. Each call returns its output."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack, melspec

    g = torch.Generator(device=device).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, device=device, generator=g).to(dtype)

    def vec(C):
        return torch.rand(C, device=device, generator=g) + 0.5

    x, hg, x4, dy = rnd(2, 8, 16, 20), rnd(2, 16, 16, 20), rnd(2, 32, 8, 10), rnd(2, 8, 16, 20)
    lengths = torch.tensor([20, 13], device=device, dtype=torch.int32)
    s, b, s2, b2 = vec(8), vec(8), vec(8), vec(8)
    stage_x, blocks, tail = _stage(device, 1, 64, 300, 11)
    stage_x = stage_x.to(dtype)

    def ps_autograd():
        xg = x4.detach().requires_grad_()
        y = ps.pixel_shuffle_in_swish(xg, s, b)
        y.float().square().sum().backward()
        return xg.grad

    def k5():
        _, mean, inv = ps.pixel_shuffle_in_swish_with_stats(x4, s, b)
        return ps.pixel_shuffle_in_swish_backward(x4, dy, s, b, mean, inv)[0]

    calls = {
        "K1": lambda: in_gate.instance_norm_glu(hg, s, b, s2, b2),
        "K1 masked": lambda: in_gate.instance_norm_glu(hg, s, b, s, b, lengths),
        "K2": lambda: in_gate.instance_norm(x, s, b),
        "K2 masked": lambda: in_gate.instance_norm(x, s, b, lengths),
        "K3": lambda: in_gate.instance_norm_swish(x, s, b),
        "K4, K5": ps_autograd,
        "K4 masked": lambda: ps.pixel_shuffle_in_swish(x4, s, b, lengths),
        "K5": k5,
        "K6": lambda: ps.inverse_pixel_shuffle(dy),
        "K7": lambda: ps.pixel_shuffle(x4),
        "K9": lambda: melgan_stack.melgan_resstack(stage_x, blocks),
        "K9 tail": lambda: melgan_stack.melgan_resstack(stage_x, blocks, tail=tail),
    }
    if dtype == torch.float32:
        audio = torch.randn(2, 256 * 70, device=device, generator=g) * 0.3
        calls["K8"] = lambda: melspec.log_mel_spectrogram_fused(audio)
    return calls


def _launches_of_all_entries():
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack, melspec

    entries = [e for k in (*in_gate.ENTRIES.values(), *ps.ENTRIES.values(),
                           melgan_stack.ENTRIES) for e in k.values()]
    return sum(e.launches for e in [*entries, melspec.LOG_MEL_KERNEL])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_debug_mode_checks_every_kernel_launch(device, dtype, monkeypatch):
    """Every entry of K1-K9 on finite input under the mode: no raise, one
    checked output per launch, and the outputs of the run outside the mode,
    bit for bit."""
    from maskcyclegan_vc_tpu_torch.utils import debug

    checked, real_check = [], debug.check_kernel_outputs

    def check(symbol, *outputs):
        if debug.nan_debug_active():
            checked.append(symbol)
        real_check(symbol, *outputs)

    monkeypatch.setattr(debug, "check_kernel_outputs", check)
    for name, call in _kernel_calls(device, dtype).items():
        with torch.inference_mode(name.startswith("K9") or name == "K8"):
            outside = call()
        launches, before = _launches_of_all_entries(), len(checked)
        with debug.nan_debug_mode(), torch.inference_mode(name.startswith("K9") or name == "K8"):
            inside = call()
        torch.cuda.synchronize()
        n = _launches_of_all_entries() - launches
        assert n >= 1 and len(checked) - before == n, name
        assert torch.equal(inside, outside), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_made_by_a_kernel_is_named_after_it(device, dtype):
    """K2 on finite input: a row of 3e38 overflows its f32 sum, so the mean
    is inf and the row's output NaN, in the plain version too. The mode
    names the C entry, not the next aten op; K9 on a NaN input names its
    first block."""
    from maskcyclegan_vc_tpu_torch.ops import melgan_stack
    from maskcyclegan_vc_tpu_torch.utils import debug

    x = torch.randn(1, 8, 64, device=device).to(dtype)
    x[0, 3] = 3e38
    s, b = torch.ones(8, device=device), torch.zeros(8, device=device)
    assert torch.isfinite(x).all()
    for y in (in_gate.instance_norm(x, s, b), in_gate.instance_norm_plain(x, s, b)):
        assert torch.isnan(y[0, 3]).all() and not torch.isnan(y[0, :3]).any()
    entry = "in_forward" + ("_bf16" if dtype == torch.bfloat16 else "")
    with debug.nan_debug_mode():
        with pytest.raises(FloatingPointError, match=f"CUDA kernel {entry}$"):
            in_gate.instance_norm(x, s, b)
    stage_x, blocks, tail = _stage(device, 1, 32, 100, 3)
    stage_x[0, 5, 50] = float("nan")
    with debug.nan_debug_mode(), torch.inference_mode():
        with pytest.raises(FloatingPointError, match=r"\(block 1 of 3\)"):
            melgan_stack.melgan_resstack(stage_x.to(dtype), blocks, tail=tail)


def test_nan_debug_mode_sees_a_cuda_backward(device):
    """Autograd runs a CUDA backward on its device thread: the mode still
    sees its ops, and the norm of zeros raises in its backward (the spy,
    after the norm, runs its backward first and records the thread)."""
    import threading

    from maskcyclegan_vc_tpu_torch.utils import debug

    threads = set()

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            threads.add(threading.get_ident())
            return g

    z = torch.zeros(3, device=device, requires_grad=True)
    with debug.nan_debug_mode():
        norm = Spy.apply(torch.linalg.norm(z))
        with pytest.raises(FloatingPointError, match=r"aten\.div\."):
            norm.backward()
    assert threads and threading.get_ident() not in threads


def test_trace_names_the_ports_kernels(device, tmp_path):
    """One f32 train step at a tiny width inside ``obs.profiler.trace``: the
    written trace holds K1-K5 by their kernels' names, each as often as the
    counters saw it launched."""
    import glob
    import json

    from maskcyclegan_vc_tpu_torch.obs import profiler

    cfg, banks = _tiny_training(device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    batch = sample_batch(step_generator(0, 0, device), *banks, 1, 32, 25)
    step(state, batch)
    def f32_launches():
        return {k: e[torch.float32].launches
                for k, e in (*in_gate.ENTRIES.items(), *ps.ENTRIES.items())}

    before = f32_launches()
    with profiler.trace(str(tmp_path)):
        step(state, batch)
    launched = {k: n - before[k] for k, n in f32_launches().items()}
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    for k in ("in_glu", "in", "in_swish", "ps_in_swish", "ps_in_swish_bwd"):
        seen = sum(bool(re.search(profiler.KERNEL_NAMES[k], n)) for n in kernels)
        assert 0 < seen == launched[k], (k, seen, launched[k], sorted(set(kernels))[:20])
