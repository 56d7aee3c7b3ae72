"""The port's NaN localizer (``utils/debug.nan_debug_mode``) against the JAX
package's, on the CPU: where JAX's raises (the first NaN-producing
operation, forward and backward), the port's raises, at the same operation;
where JAX's passes (an infinity), the port's passes. A step under the mode
equals the step outside it bit for bit; the kernels' output check, which
stands in for the dispatcher where a wrapper launches a CUDA kernel, and
the trainer's error and mode switch. The card's side (every kernel entry
under the mode, a backward on autograd's device thread) is in
``test_torch_port_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskcyclegan_vc_tpu.utils.debug import nan_debug_mode as jax_nan_debug_mode
from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import make_train_step
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs
from maskcyclegan_vc_tpu_torch.utils import debug
from maskcyclegan_vc_tpu_torch.utils.debug import check_kernel_outputs, nan_debug_mode

torch.set_num_threads(1)
N_MELS, FRAMES, R = 16, 32, 8


def test_first_nan_raises_at_its_op_inside_and_propagates_outside():
    """tests/test_debug.py's case in both packages: log(-1) * 2 raises at
    the log, not the mul; outside the mode the NaN propagates."""
    with jax_nan_debug_mode():
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.array(-1.0)) * 2.0
    assert np.isnan(float(jnp.log(jnp.array(-1.0)) * 2.0))

    with nan_debug_mode():
        with pytest.raises(FloatingPointError, match=r"aten\.log\."):
            torch.log(torch.tensor(-1.0)) * 2.0
    assert torch.isnan(torch.log(torch.tensor(-1.0)) * 2.0)


def test_an_infinity_passes_in_both():
    """jax.debug_nans checks NaN only: log(0) = -inf raises in neither."""
    with jax_nan_debug_mode():
        assert float(jnp.log(jnp.array(0.0))) == -np.inf
    with nan_debug_mode():
        assert float(torch.log(torch.tensor(0.0))) == -np.inf


def test_a_nan_made_in_the_backward_raises_in_both():
    """The gradient of the norm at 0 is 0 / 0: JAX raises in its backward's
    mul, the port in its backward's div. Outside the mode PyTorch then masks
    that NaN to a 0 subgradient; the mode, like JAX's, stops at it."""
    with jax_nan_debug_mode():
        with pytest.raises(FloatingPointError):
            jax.grad(jnp.linalg.norm)(jnp.zeros(3))
    z = torch.zeros(3, requires_grad=True)
    with nan_debug_mode():
        norm = torch.linalg.norm(z)  # the forward is finite
        with pytest.raises(FloatingPointError, match=r"aten\.div\."):
            norm.backward()
    torch.linalg.norm(z).backward()
    assert torch.equal(z.grad, torch.zeros(3))


def test_in_place_writes_are_checked():
    """An in-place op (as Adam's _foreach updates) makes its values in the
    tensor it writes: that tensor is checked."""
    zeros, infs = torch.zeros(3), torch.full((3,), float("inf"))
    with nan_debug_mode():
        zeros.add_(1.0).zero_()
        with pytest.raises(FloatingPointError, match="_foreach_mul_"):
            torch._foreach_mul_([zeros], [infs])  # 0 * inf
        with pytest.raises(FloatingPointError, match=r"aten\.mul_\."):
            torch.zeros(3).mul_(float("inf"))


def test_uninitialised_outputs_and_views_are_not_checked(monkeypatch):
    """empty and its kin may hand back old NaN bytes (a kernel wrapper's
    output before its launch); views make no new values. Every other output
    is checked: with every floating tensor taken for NaN, only those pass."""
    x = torch.zeros(4, 6)
    monkeypatch.setattr(debug, "_has_nan", lambda t: isinstance(t, torch.Tensor)
                        and t.is_floating_point())
    with nan_debug_mode():
        torch.empty(5)
        torch.empty_like(x)
        x.new_empty((2, 3))
        torch.empty_strided((2, 3), (3, 1))
        x.view(24)
        x.t()
        x[1:3]
        with pytest.raises(FloatingPointError, match="zeros"):
            torch.zeros(3)
        with pytest.raises(FloatingPointError, match="add"):
            x + 1.0


def test_empty_inside_the_mode_never_raises():
    """NaN bytes freed just before an empty inside the mode: the memory may
    come back holding them, as the card's caching allocator hands back old
    blocks; the mode does not look."""
    for n in (4, 64, 1024, 1 << 16):
        junk = torch.full((n,), float("nan"))
        del junk
        with nan_debug_mode():
            torch.empty(n)
            torch.empty(n, dtype=torch.bfloat16)
            torch.empty_like(torch.ones(n))


def test_kernel_output_check_names_the_entry_inside_and_does_nothing_outside():
    bad, good = torch.tensor([1.0, float("nan")]), torch.ones(2)
    check_kernel_outputs("in_forward_bf16", bad)  # outside: no check
    with nan_debug_mode():
        check_kernel_outputs("in_forward_bf16", good, good)
        with pytest.raises(FloatingPointError, match="CUDA kernel in_forward_bf16$"):
            check_kernel_outputs("in_forward_bf16", good, bad)
        with pytest.raises(FloatingPointError, match=r"melgan_resstack_forward \(block 2 of 3\)"):
            check_kernel_outputs("melgan_resstack_forward", ("block 1 of 3", good),
                                 ("block 2 of 3", bad), ("block 3 of 3", bad))
        # An infinity is no NaN.
        check_kernel_outputs("log_mel_forward", torch.tensor([-float("inf")]))
    assert not debug.nan_debug_active()


def test_the_mode_is_the_threads_own():
    """A thread outside the mode checks nothing while another is inside it."""
    import threading

    bad = torch.tensor([1.0, float("nan")])
    seen = []

    def other():
        seen.append(debug.nan_debug_active())
        check_kernel_outputs("in_forward", bad)
        seen.append(float(torch.log(-bad[:1])))

    with nan_debug_mode():
        assert debug.nan_debug_active()
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen[0] is False and math.isnan(seen[1])


def _cfg():
    sched = ScheduleConfig(num_epochs=10, n_samples=4, batch_size=2, decay_after=4,
                           stop_identity_after=4)
    return TrainConfig(schedule=sched, n_mels=N_MELS, num_frames=FRAMES, residual_channels=R)


def _batch(seed):
    rs = np.random.RandomState(seed)
    mask = np.ones((2, N_MELS, FRAMES), np.float32)
    mask[0, :, 2:5] = 0.0
    b = {"real_A": rs.randn(2, N_MELS, FRAMES), "mask_A": mask,
         "real_B": rs.randn(2, N_MELS, FRAMES), "mask_B": mask[::-1]}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in b.items()}


@pytest.mark.parametrize("fused_norms", [True, False])
def test_a_step_under_the_mode_is_the_step_outside_it(fused_norms):
    """Two steps (with identity, then without) of a tiny port state (R = 8,
    the norms' plain versions on the CPU): no raise, and the same losses,
    parameters and Adam moments, bit for bit."""
    cfg = _cfg()
    cfg = TrainConfig(**{**cfg.__dict__, "fused_norms": fused_norms})
    runs = []
    for under in (True, False):
        state = create_train_state(cfg, seed=3)
        metrics = []
        for i, wi in enumerate((True, False)):
            step = make_train_step(cfg, with_identity=wi)
            if under:
                with nan_debug_mode():
                    state, m = step(state, _batch(i))
            else:
                state, m = step(state, _batch(i))
            metrics.append(m)
        runs.append((state, metrics))
    (s0, m0), (s1, m1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for p, q in zip([*s0.g_params(), *s0.d_params()], [*s1.g_params(), *s1.d_params()]):
        assert torch.equal(p, q)
    for opt0, opt1 in ((s0.g_opt, s1.g_opt), (s0.d_opt, s1.d_opt)):
        for st0, st1 in zip(opt0.state.values(), opt1.state.values()):
            for k in st0:
                assert torch.equal(st0[k], st1[k]), k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_debug")
    rs = np.random.RandomState(0)
    for sid in ("SA", "SB"):
        save_speaker(str(root / "pre"), sid,
                     [rs.randn(N_MELS, t).astype(np.float32) for t in (40, 57)],
                     np.zeros((N_MELS, 1), np.float32), np.ones((N_MELS, 1), np.float32))
    return root


def _trainer(root, name, scan):
    return Trainer(TrainerArgs(
        name=name, save_dir=str(root / "out"), seed=0, speaker_A_id="SA",
        speaker_B_id="SB", preprocessed_data_dir=str(root / "pre"), num_epochs=1,
        batch_size=1, num_frames=FRAMES, n_mels=N_MELS, residual_channels=R,
        epochs_per_save=100, epochs_per_plot=100, steps_per_print=1, scan_epochs=scan,
        finite_check="params", async_save=False, device="cpu"))


def test_trainer_metrics_check_raises_with_remedy(corpus):
    """tests/test_debug.py's trainer case for the port: the epoch's error
    names the epoch, the step and the localizer."""
    t = _trainer(corpus, "remedy", scan=False)
    t._check_metrics_finite([{"g_loss": 1.0}] * 3, epoch=7, first_step=1)
    with pytest.raises(FloatingPointError) as ei:
        t._check_metrics_finite([{"g_loss": 1.0}, {"g_loss": float("nan")}, {"g_loss": 1.0}],
                                epoch=7, first_step=1)
    assert "epoch 7" in str(ei.value) and "step 2" in str(ei.value)
    assert "maskcyclegan_vc_tpu_torch.utils.debug.nan_debug_mode" in str(ei.value)
    t.logger.close()


def test_trainer_under_the_mode_runs_a_step_at_a_time(corpus, monkeypatch):
    """With --scan_epochs 1 the trainer's step runner inside the mode runs
    every step eagerly and never captures, and its epoch equals a
    --scan_epochs 0 epoch outside the mode bit for bit."""
    from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner

    inside = _trainer(corpus, "inside", scan=True)

    def no_capture(*args, **kwargs):
        raise AssertionError("the step runner captured inside nan_debug_mode")

    monkeypatch.setattr(StepRunner, "_first_step", no_capture)
    monkeypatch.setattr(StepRunner, "capture", no_capture)
    with nan_debug_mode():
        inside.train()
    outside = _trainer(corpus, "outside", scan=False)
    outside.train()
    assert inside.state.step == outside.state.step == 2
    for p, q in zip([*inside.state.g_params(), *inside.state.d_params()],
                    [*outside.state.g_params(), *outside.state.d_params()]):
        assert torch.equal(p, q)


def test_a_capture_inside_the_mode_raises():
    """StepRunner.capture never captures with the checks off."""
    from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner

    runner = StepRunner.__new__(StepRunner)
    with nan_debug_mode():
        with pytest.raises(RuntimeError, match="nan_debug_mode"):
            runner.capture(None, None, 0.0, None)
