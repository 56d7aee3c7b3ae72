"""cuDNN's autotuner in the port, on the CPU: ``utils.device.autotune_scope``
sets ``torch.backends.cudnn.benchmark`` and restores it, after an exception
too; ``StepRunner.run`` and the trainer's step-at-a-time loop run inside it
in f32 (``autotunes``) and outside it in bf16; the conversion
(``make_convert_fn``), the vocoder (``decode_mel``) and the trainer's plot
outside it; the ``conv.autotuned`` counter counts each
distinct conv problem once inside the scope and nothing outside it; and
neither CLI has a flag for it. On the CPU the flag times nothing: the card
tests (``test_torch_port_cuda.py``) hold the autotuned steps against eager
ones.
"""

import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu_torch.cli import test as test_cli
from maskcyclegan_vc_tpu_torch.cli import train as train_cli
from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.data.dataset import MelBank, save_speaker
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator, decode_mel
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.ops import layers
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import make_update
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs
from maskcyclegan_vc_tpu_torch.utils import device as device_mod
from maskcyclegan_vc_tpu_torch.utils.device import ConvAutotune, autotune_scope, autotunes

N_MELS, R = 16, 8


def _flags():
    """(cuDNN's autotuner flag, whether conv problems are being noted)."""
    return torch.backends.cudnn.benchmark, device_mod.CONV_AUTOTUNE.on


def _limit():
    return torch.backends.cudnn.benchmark_limit


def _autotuned():
    return profiler.counters().get("conv.autotuned", 0)


@pytest.fixture
def fresh_problems(monkeypatch):
    """A process's first conv problems: a new ``ConvAutotune`` where the
    scope and the layers look for it."""
    mine = ConvAutotune()
    monkeypatch.setattr(device_mod, "CONV_AUTOTUNE", mine)
    monkeypatch.setattr(layers, "CONV_AUTOTUNE", mine)
    return mine


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("on", [True, False])
def test_scope_sets_the_flag_and_restores_it(before, on):
    saved = torch.backends.cudnn.benchmark, _limit()
    torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit = before, 3
    try:
        with autotune_scope(on):
            assert _flags() == (on, on) and _limit() == device_mod.AUTOTUNE_ENGINES == 5
        assert _flags() == (before, False) and _limit() == 3
        with pytest.raises(KeyError):
            with autotune_scope(on):
                assert _flags() == (on, on)
                raise KeyError("inside")
        assert _flags() == (before, False) and _limit() == 3
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit = saved


def test_scope_keeps_the_allocator_cache_and_empties_it_once(monkeypatch, fresh_problems):
    """Inside the scope PyTorch's emptying of the allocator's cache after each
    cuDNN timing is off (the switch a CUDA build has, faked here); the scope
    empties the cache once at its end where it met a new conv problem."""
    switch, emptied = [True], []
    monkeypatch.setattr(torch._C, "_cuda_get_conv_benchmark_empty_cache",
                        lambda: switch[0], raising=False)
    monkeypatch.setattr(torch._C, "_cudnn_set_conv_benchmark_empty_cache",
                        lambda v: switch.__setitem__(0, v), raising=False)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    conv, x = torch.nn.Conv1d(4, 6, 3), torch.randn(1, 4, 9)
    for _ in range(2):  # the second scope meets the same problem again
        with autotune_scope():
            assert switch == [False]
            layers.conv(conv, x)
        assert switch == [True] and len(emptied) == 1
    with pytest.raises(KeyError):
        with autotune_scope():
            layers.conv(conv, x[..., :7])
            raise KeyError("inside")
    assert switch == [True] and len(emptied) == 2


def _tiny(frames=16, dtype=None):
    rs = np.random.RandomState(0)
    banks = [MelBank.from_list([rs.randn(N_MELS, t).astype(np.float32) for t in (20, 31, 40)],
                               frames) for _ in range(2)]
    sched = ScheduleConfig(n_samples=3, batch_size=1, stop_identity_after=1)
    cfg = TrainConfig(schedule=sched, n_mels=N_MELS, num_frames=frames, residual_channels=R,
                      dtype=dtype)
    return cfg, banks


def _recording(update, seen):
    def recorded(state, batch, lam_id):
        seen.append(_flags())
        return update(state, batch, lam_id)
    return recorded


def test_only_f32_steps_autotune():
    assert autotunes(None) and autotunes(torch.float32)
    assert not autotunes(torch.bfloat16)


@pytest.mark.parametrize("dtype,inside", [(None, (True, True)), (torch.bfloat16, (False, False))])
def test_step_runner_runs_its_steps_inside_the_scope(dtype, inside):
    cfg, banks = _tiny(dtype=dtype)
    state = create_train_state(cfg, 0, torch.device("cpu"))
    seen = []
    updates = {wi: _recording(make_update(cfg, wi), seen) for wi in (True, False)}
    runner = StepRunner(cfg, lambda step: updates[step <= 1], *banks, 0, 1, 16, 8)
    before = _flags()
    rows = runner.run(state, 3)
    assert seen == [inside] * 3 and bool(torch.isfinite(rows).all())
    assert _flags() == before == (False, False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("autotune")
    rs = np.random.RandomState(0)
    for sid in ("VCC2SF3", "VCC2TF1"):
        save_speaker(str(root / "pre"), sid,
                     [rs.randn(N_MELS, t).astype(np.float32) for t in (20, 31, 40)],
                     rs.randn(N_MELS, 1).astype(np.float32),
                     (rs.rand(N_MELS, 1) + 0.5).astype(np.float32))
    return root


@pytest.mark.parametrize("scan", [True, False])
def test_trainer_steps_inside_the_scope_and_its_plot_outside(corpus, scan):
    """The runner's steps, captured or not, see the autotuner on; the
    plot's two conversions and four vocoder decodes see it off, as does the
    caller after."""
    trainer = Trainer(TrainerArgs(
        name=f"autotune{int(scan)}", save_dir=str(corpus / "results"),
        preprocessed_data_dir=str(corpus / "pre"), num_epochs=1, batch_size=1, num_frames=16,
        n_mels=N_MELS, residual_channels=R, epochs_per_save=100, epochs_per_plot=1,
        steps_per_print=100, async_save=False, scan_epochs=scan, device="cpu"))
    trainer.vocoder = MelGANGenerator(n_mels=N_MELS, ngf=4)
    steps, converts, decodes = [], [], []
    real = trainer.step_fn
    trainer.step_fn = lambda step: _recording(real(step), steps)
    trainer.state.g["A2B"].register_forward_pre_hook(
        lambda *_: converts.append(_flags()) if torch.is_inference_mode_enabled() else None)
    trainer.vocoder.register_forward_pre_hook(lambda *_: decodes.append(_flags()))
    trainer.train()
    assert steps == [(True, True)] * trainer.steps_per_epoch
    assert converts == [(False, False)] and decodes == [(False, False)] * 4
    assert _flags() == (False, False)


def _mel(t):
    return np.random.RandomState(t).randn(N_MELS, t).astype(np.float32)


def test_conversion_and_decode_note_no_problem(fresh_problems):
    gen = Generator(n_mels=N_MELS, residual_channels=R)
    n0 = _autotuned()
    seen = []
    gen.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    out = make_convert_fn(gen)(_mel(37))
    vocoder = MelGANGenerator(n_mels=N_MELS, ngf=4)
    vocoder.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    wav = decode_mel(vocoder, torch.from_numpy(out)[None], 0.0, 1.0)
    assert out.shape == (N_MELS, 37) and wav.shape == (1, 37 * 256)
    assert seen == [(False, False)] * 2
    assert _autotuned() == n0 and not fresh_problems.problems


# The generator's distinct conv problems at one input shape: conv1 (with its
# gates), the two downsamples, the 2D-to-1D conv, a residual block's gated
# conv and its output conv (every block has the same shapes), the 1D-to-2D
# conv, the two upsamples and the last conv.
GENERATOR_PROBLEMS = 10


def test_conv_autotuned_counts_each_distinct_problem_once(fresh_problems):
    gen = Generator(n_mels=N_MELS, residual_channels=R)

    def forward(frames, dtype=None):
        x = torch.randn(1, N_MELS, frames)
        gen.with_dtype(dtype)(x, torch.ones_like(x))

    n0 = _autotuned()
    forward(16)
    assert _autotuned() == n0  # the scope is off
    with autotune_scope():
        forward(16)
        assert _autotuned() == n0 + GENERATOR_PROBLEMS
        forward(16)
        assert _autotuned() == n0 + GENERATOR_PROBLEMS
        forward(24)  # another length: every problem is new
        forward(16, torch.bfloat16)  # another dtype: likewise
        assert _autotuned() == n0 + 3 * GENERATOR_PROBLEMS
    assert len(fresh_problems.problems) == 3 * GENERATOR_PROBLEMS
    forward(32)
    assert _autotuned() == n0 + 3 * GENERATOR_PROBLEMS


def test_conv_problems_are_keyed_by_shapes_stride_padding_dilation_dtype(fresh_problems):
    x = torch.randn(1, 4, 9)
    convs = [torch.nn.Conv1d(4, 6, 3), torch.nn.Conv1d(4, 6, 3, stride=2),
             torch.nn.Conv1d(4, 6, 3, padding=1), torch.nn.Conv1d(4, 6, 3, dilation=2),
             torch.nn.Conv1d(4, 6, 5), torch.nn.Conv1d(4, 6, 3)]
    n0 = _autotuned()
    with autotune_scope():
        for c in convs:
            layers.conv(c, x)
        layers.conv(convs[0], x.to(torch.bfloat16))
        layers.conv(convs[0], torch.randn(2, 4, 9))
    # The last Conv1d repeats the first's problem.
    assert _autotuned() == n0 + 7 == n0 + len(fresh_problems.problems)


# The flags of each CLI at this commit: the autotuner follows what the code
# can see, and no flag or environment variable chooses it.
TRAIN_FLAGS = {
    "async_save", "batch_size", "continue_train", "cycle_loss_lambda", "decay_after", "device",
    "discriminator_lr", "distributed", "dtype", "epochs_per_plot", "epochs_per_save",
    "finite_check", "fused_norms", "generator_lr", "grad_allreduce_dtype", "help",
    "identity_loss_lambda", "max_ckpts", "max_mask_len", "n_mels", "name", "num_epochs",
    "num_frames", "num_frames_validation", "plot_audio", "precision", "preprocessed_data_dir",
    "ref_compat_lr", "remat", "residual_channels", "sample_rate", "save_dir", "scan_epochs",
    "seed", "speaker_A_id", "speaker_B_id", "steps_per_print", "stop_identity_after",
    "vocoder_ckpt"}
TEST_FLAGS = {
    "ckpt_dir", "compute_mcd", "device", "griffin_lim", "griffin_lim_iters", "help",
    "load_epoch", "model_name", "n_mels", "name", "preprocessed_data_dir",
    "residual_channels", "sample_rate", "save_dir", "speaker_A_id", "speaker_B_id",
    "vocoder_ckpt"}


@pytest.mark.parametrize("cli,flags", [(train_cli, TRAIN_FLAGS), (test_cli, TEST_FLAGS)])
def test_neither_cli_has_an_autotuner_flag(cli, flags):
    actions = cli.build_parser()._actions
    assert {a.dest for a in actions} == flags
    for a in actions:
        for s in a.option_strings:
            assert not any(w in s.lower() for w in ("autotun", "cudnn", "benchmark")), s
