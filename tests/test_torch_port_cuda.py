"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where PyTorch sees no GPU. On a machine
with one (``--noconftest``: the suite's conftest configures JAX, which this
file does not use):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Shapes cover both launch modes of csrc/in_gate.cu (a warp per row of up to
1024 values, a block per longer row), batches above 1, and lengths that are
full, partial, odd, two frames and zero. Tolerance atol = rtol = 1e-5 (f32,
only the order of the sums differs). A row with one valid frame is
ill-conditioned and has its own test and bound.
"""

import pytest
import torch

from maskcyclegan_vc_tpu_torch.ops import in_gate, ps
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
    with pytest.raises(NotImplementedError):  # no backward kernel yet
        in_gate.instance_norm(x.requires_grad_(), s, b)
