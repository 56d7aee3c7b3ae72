"""Port's sampler, trainer and train CLI on the CPU, against the JAX package
where the two meet: the checkpoint's keys, and the JAX conversion CLI
reading the port's checkpoint.

The CLI runs at a tiny width (16 mels, R = 8, 16-frame crops) with
``--device cpu``. The sampler's random stream differs from JAX's by
design; its ranges, distributions and the (seed, step) contract are pinned
here instead.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from test_torch_port_melgan import neurips_state_dict

from maskcyclegan_vc_tpu.cli.test import main as jax_convert_main
from maskcyclegan_vc_tpu.io.checkpoint import _flatten as jax_flatten
from maskcyclegan_vc_tpu.train.schedules import ScheduleConfig as JaxScheduleConfig
from maskcyclegan_vc_tpu.train.state import TrainConfig as JaxTrainConfig
from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
from maskcyclegan_vc_tpu_torch.cli.test import main as convert_main
from maskcyclegan_vc_tpu_torch.cli.train import main as train_main
from maskcyclegan_vc_tpu_torch.data.dataset import (
    MelBank,
    sample_batch,
    save_speaker,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.data.griffin_lim import decode_mel_griffin_lim
from maskcyclegan_vc_tpu_torch.io.checkpoint import load_checkpoint_meta
from maskcyclegan_vc_tpu_torch.models.melgan import decode_mel
from maskcyclegan_vc_tpu_torch.obs.logger import TrainLogger
from maskcyclegan_vc_tpu_torch.train.trainer import LOGGED_METRICS, Trainer, TrainerArgs

torch.set_num_threads(1)
N_MELS, R, FRAMES = 16, 8, 16
LENGTHS = (20, 31, 40, 57)  # one conversion bucket (64) for the JAX CLI


# ---------- sampler ----------

def _coded_bank(lengths):
    """data[i, :, t] = 1000 i + t, so a crop reveals its utterance and start."""
    mels = [np.broadcast_to(1000 * i + np.arange(t, dtype=np.float32), (3, t)).copy()
            for i, t in enumerate(lengths)]
    return MelBank.from_list(mels, min_frames=16)


def test_sampler_ranges_and_distributions():
    lengths = (16, 40, 25, 64)
    bank = _coded_bank(lengths)
    n, mml, B = 16, 8, 4000
    b = sample_batch(step_generator(0, 0, "cpu"), bank, bank, B, n, mml)
    for side in ("A", "B"):
        frames, mask = b[f"real_{side}"].numpy(), b[f"mask_{side}"].numpy()
        assert frames.shape == mask.shape == (B, 3, n)
        utt, start = (frames[:, 0, 0] // 1000).astype(int), (frames[:, 0, 0] % 1000).astype(int)
        # Crops are contiguous, start in [0, len - n], every start reached.
        np.testing.assert_array_equal(frames[:, 0, :] - frames[:, 0, :1],
                                      np.broadcast_to(np.arange(n), (B, n)))
        counts = np.bincount(utt, minlength=4)
        assert (np.abs(counts - B / 4) < 5 * np.sqrt(B / 4)).all(), counts
        for u, L in enumerate(lengths):
            s = start[utt == u]
            assert s.min() == 0 and s.max() == L - n
            if L - n + 1 > 1:
                hist = np.bincount(s, minlength=L - n + 1)
                expect = len(s) / (L - n + 1)
                assert (np.abs(hist - expect) < 5 * np.sqrt(expect) + 1).all(), (u, hist)
        # FIF mask: one hole of size U{0..mml-1} at start U{0..n-size-1},
        # the same in every mel bin.
        assert (mask == mask[:, :1]).all() and set(np.unique(mask)) <= {0.0, 1.0}
        size = (mask[:, 0] == 0).sum(1)
        assert set(size) == set(range(mml))
        assert (np.abs(np.bincount(size) - B / mml) < 5 * np.sqrt(B / mml)).all()
        for row, sz in zip(mask[:, 0], size):
            if sz:
                first = int(np.argmin(row))
                assert (row[first:first + sz] == 0).all() and first <= n - sz - 1


def test_sampler_is_a_function_of_seed_and_step():
    bank = _coded_bank((30, 50))
    draw = lambda seed, step: sample_batch(step_generator(seed, step, "cpu"),  # noqa: E731
                                           bank, bank, 8, 16, 25)
    a, b, c, d = draw(0, 5), draw(0, 5), draw(0, 6), draw(1, 5)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert any(not torch.equal(a[k], d[k]) for k in a)


def test_bank_drops_short_utterances():
    bank = _coded_bank((10, 20, 15, 30))
    assert bank.lengths.tolist() == [20, 30]
    with pytest.raises(ValueError):
        MelBank.from_list([np.zeros((3, 5), np.float32)], min_frames=16)


# ---------- trainer and CLI ----------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    rs = np.random.RandomState(0)
    for sid in ("VCC2SF3", "VCC2TF1"):
        save_speaker(str(root / "pre"), sid,
                     [rs.randn(N_MELS, t).astype(np.float32) for t in LENGTHS],
                     rs.randn(N_MELS, 1).astype(np.float32),
                     (rs.rand(N_MELS, 1) + 0.5).astype(np.float32))
    return root


def _args(root, name, *extra):
    return ["--name", name, "--save_dir", str(root / "results"),
            "--preprocessed_data_dir", str(root / "pre"), "--batch_size", "1",
            "--num_frames", str(FRAMES), "--n_mels", str(N_MELS),
            "--residual_channels", str(R), "--epochs_per_save", "1",
            "--epochs_per_plot", "2", "--steps_per_print", "1", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(corpus):
    train_main(_args(corpus, "cli", "--num_epochs", "2"))
    train_main(_args(corpus, "cli", "--num_epochs", "3", "--continue_train"))
    return corpus / "results" / "cli"


def test_cli_trains_and_resumes(trained):
    ckpts = sorted(os.path.basename(p) for p in glob.glob(str(trained / "ckpts" / "*")))
    assert ckpts == ["00001_state.npz", "00002_state.npz", "00003_state.npz"]
    steps_per_epoch = len(LENGTHS)
    for epoch in (1, 2, 3):
        with np.load(trained / "ckpts" / f"{epoch:05d}_state.npz") as z:
            assert int(z[".step"]) == epoch * steps_per_epoch
    lines = [line for line in open(trained / "cli.log") if line.startswith("[epoch")]
    assert [int(line.split()[3].rstrip("]")) for line in lines] == list(range(1, 13))
    for line in lines:
        vals = [float(v) for v in line.split(": ")[1:] for v in [v.split()[0]]]
        assert len(vals) == 7 and np.isfinite(vals).all()
    with open(trained / "train_args.json") as f:
        args = json.load(f)
    assert args["device"] == "cpu" and args["num_epochs"] == 3


def test_checkpoint_keys_equal_the_jax_trainers(trained):
    cfg = JaxTrainConfig(schedule=JaxScheduleConfig(), n_mels=N_MELS, num_frames=FRAMES,
                         residual_channels=R)
    want = set(jax_flatten(jax_create_train_state(cfg, seed=0)))
    want |= {f"meta/{k}" for k in ("seed", "epoch", "mean_A", "std_A", "mean_B", "std_B")}
    path = str(trained / "ckpts" / "00003_state.npz")
    with np.load(path) as z:
        assert set(z.files) == want
    meta = load_checkpoint_meta(path)
    assert int(meta["epoch"]) == 3 and int(meta["seed"]) == 0
    assert meta["mean_A"].shape == (N_MELS, 1)


def test_jax_conversion_cli_reads_the_ports_checkpoint(trained, corpus):
    """The JAX package's cli.test converts with the port's checkpoint, and
    agrees with the port's own conversion CLI (atol 1e-4, as
    test_torch_port_convert.py holds the two CLIs)."""
    common = ["--save_dir", str(corpus / "results"), "--preprocessed_data_dir",
              str(corpus / "pre"), "--ckpt_dir", str(trained / "ckpts"), "--load_epoch", "3",
              "--n_mels", str(N_MELS), "--residual_channels", str(R)]
    jax_convert_main(["--name", "jax_conv"] + common)
    convert_main(["--name", "port_conv", "--device", "cpu"] + common)
    for i, t in enumerate(LENGTHS):
        stem = f"{i}-converted_VCC2SF3_to_VCC2TF1.npy"
        want = np.load(corpus / "results" / "jax_conv" / "converted_audio_3" / stem)
        got = np.load(corpus / "results" / "port_conv" / "converted_audio_3" / stem)
        assert got.shape == want.shape == (N_MELS, t) and np.isfinite(want).all()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------- --scan_epochs ----------

def _run_phases(corpus, name, *phases):
    """The CLI with the identity terms off from step 7 (inside epoch 2), one
    call per (num_epochs, scan_epochs) phase, each after the first resumed."""
    for i, (epochs, scan) in enumerate(phases):
        train_main(_args(corpus, name, "--num_epochs", str(epochs), "--scan_epochs", str(scan),
                         "--stop_identity_after", "6", "--epochs_per_plot", "100",
                         *(["--continue_train"] if i else [])))
    return corpus / "results" / name


@pytest.fixture(scope="module")
def mode_runs(corpus):
    """3 epochs a step at a time; 2 epochs of scan then a step at a time to 3;
    1 epoch a step at a time then scan to 3."""
    return {"step": _run_phases(corpus, "mode_step", (3, 0)),
            "scan_step": _run_phases(corpus, "mode_scan_step", (2, 1), (3, 0)),
            "step_scan": _run_phases(corpus, "mode_step_scan", (1, 0), (3, 1))}


def _checkpoint(run, epoch: int):
    with np.load(run / "ckpts" / f"{epoch:05d}_state.npz") as z:
        return {k: z[k] for k in z.files}


def _logged_steps(run):
    """Each step's logged line without its ms/it."""
    return [line.rsplit(" (", 1)[0] for line in open(run / f"{run.name}.log")
            if line.startswith("[epoch")]


def _assert_same_checkpoint(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scan_epochs_match_step_at_a_time(mode_runs):
    """Two epochs with --scan_epochs 1 log the same losses and write the same
    checkpoints as with --scan_epochs 0: the same batches (the generator
    reseeded for each step), the same updates, the identity variant switched
    at the same step."""
    step, scan = mode_runs["step"], mode_runs["scan_step"]
    lines = _logged_steps(step)
    assert _logged_steps(scan)[:8] == lines[:8]
    assert "g_identity_loss: 0.00000" in lines[7] and "g_identity_loss: 0.00000" not in lines[6]
    for epoch in (1, 2):
        _assert_same_checkpoint(_checkpoint(scan, epoch), _checkpoint(step, epoch))
    for run, want in ((step, False), (scan, False), (mode_runs["step_scan"], True)):
        with open(run / "train_args.json") as f:
            assert json.load(f)["scan_epochs"] is want  # the last call's


@pytest.mark.parametrize("order", ["scan_step", "step_scan"])
def test_resume_across_modes_equals_uninterrupted(mode_runs, order):
    run, step = mode_runs[order], mode_runs["step"]
    assert _logged_steps(run) == _logged_steps(step)
    _assert_same_checkpoint(_checkpoint(run, 3), _checkpoint(step, 3))


def test_cuda_without_a_gpu_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(_args(corpus, "nogpu", "--num_epochs", "1")[:-2] + ["--device", "cuda"])
    assert not glob.glob(str(corpus / "results" / "nogpu" / "ckpts" / "*"))


@pytest.mark.parametrize("flag", [["--distributed"], ["--grad_allreduce_dtype", "float32"]])
def test_unported_flags_are_rejected(corpus, flag, monkeypatch):
    """The data-parallel flags are ported now (``tests/test_torch_port_parallel.py``
    runs them over two processes): each is accepted, and without torchrun's
    environment the run is the plain single-process run, bit for bit on the
    CPU. What is still rejected is a wire dtype the flag does not offer."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    name = "flags" + "".join(flag).replace("-", "_")
    train_main(_args(corpus, name, "--num_epochs", "1") + flag)
    train_main(_args(corpus, name + "_plain", "--num_epochs", "1"))
    ckpts = corpus / "results"
    with np.load(ckpts / name / "ckpts" / "00001_state.npz") as got, \
            np.load(ckpts / (name + "_plain") / "ckpts" / "00001_state.npz") as want:
        assert got.files == want.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(SystemExit):
        train_main(_args(corpus, "flags", "--num_epochs", "1")
                   + ["--grad_allreduce_dtype", "float16"])


@pytest.mark.parametrize("scan", [False, True])
def test_nan_at_a_middle_step_is_caught_after_logging_and_flushing(corpus, scan):
    """The three round-5 trainer defects are absent, in both modes: a
    non-finite loss at a middle step of an epoch (not its last) stops the
    run; that epoch's per-step values are in the log first; the checkpoint
    write in flight is flushed and the logger closed on the way out."""
    name = f"nan_scan{int(scan)}"
    args = TrainerArgs(name=name, save_dir=str(corpus / "results"),
                       preprocessed_data_dir=str(corpus / "pre"), num_epochs=3,
                       batch_size=1, num_frames=FRAMES, n_mels=N_MELS, residual_channels=R,
                       epochs_per_save=1, epochs_per_plot=100, steps_per_print=100,
                       scan_epochs=scan, device="cpu")
    trainer = Trainer(args)
    real = trainer.step_fn
    bad_step = len(LENGTHS) + 2  # the second step of epoch 2, of 4

    def poisoned(step):
        fn = real(step)
        if step + 1 != bad_step:
            return fn

        def run(state, batch, lam_id):
            return dict(fn(state, batch, lam_id), g_loss=torch.tensor(float("nan")))
        return run

    trainer.step_fn = poisoned
    with pytest.raises(FloatingPointError, match=f"step {bad_step}"):
        trainer.train()
    assert trainer._saver._thread is None and trainer.logger.tb is None
    log = open(corpus / "results" / name / f"{name}.log").read().splitlines()
    epoch2 = [line for line in log if line.startswith("[epoch 2 step")]
    assert len(epoch2) == len(LENGTHS)
    assert "g_loss: nan" in epoch2[1] and "nan" not in epoch2[-1]
    ckpts = sorted(os.path.basename(p) for p in glob.glob(str(corpus / "results" / name / "ckpts" / "*")))
    assert ckpts == ["00001_state.npz"]
    with np.load(corpus / "results" / name / "ckpts" / "00001_state.npz") as z:
        assert int(z[".step"]) == len(LENGTHS)


@pytest.mark.parametrize("scan", [False, True])
def test_finite_check_params_refuses_to_save_a_poisoned_state(corpus, scan):
    name = f"params_scan{int(scan)}"
    args = TrainerArgs(name=name, save_dir=str(corpus / "results"),
                       preprocessed_data_dir=str(corpus / "pre"), num_epochs=1,
                       batch_size=1, num_frames=FRAMES, n_mels=N_MELS, residual_channels=R,
                       epochs_per_save=1, epochs_per_plot=100, finite_check="params",
                       scan_epochs=scan, device="cpu")
    trainer = Trainer(args)
    with torch.no_grad():
        trainer.state.g["A2B"].conv1.bias[0] = float("inf")
    trainer.step_fn = lambda step: (lambda state, batch, lam_id: {
        k: torch.zeros(()) for k in LOGGED_METRICS})
    with pytest.raises(FloatingPointError, match="A2B"):
        trainer.train()
    assert not glob.glob(str(corpus / "results" / name / "ckpts" / "*"))


# ---------- audio at plot cadence ----------

@pytest.fixture(scope="module")
def vocoder_ckpt(corpus):
    """A random melgan-neurips checkpoint at the corpus's 16 mels, ngf 4."""
    path = corpus / "vocoder16.pt"
    torch.save(neurips_state_dict(0, n_mels=N_MELS, ngf=4), path)
    return str(path)


@pytest.mark.parametrize("decoder", ["griffin_lim", "vocoder", "off"])
def test_train_cli_decodes_the_four_panels(corpus, vocoder_ckpt, monkeypatch, decoder):
    """One epoch through the CLI with a plot: the four panels are decoded in
    their speakers' statistics, by MelGAN with --vocoder_ckpt, else by
    Griffin-Lim at 32 iterations, and not at all with --plot_audio off."""
    clips = {}
    monkeypatch.setattr(TrainLogger, "log_audio",
                        lambda self, tag, wav, step, sr: clips.setdefault(tag, (wav, step, sr)))
    plots = []
    real_plot = Trainer._plot
    monkeypatch.setattr(Trainer, "_plot", lambda self, epoch: plots.append(self)
                        or real_plot(self, epoch))
    extra = {"griffin_lim": [], "vocoder": ["--vocoder_ckpt", vocoder_ckpt],
             "off": ["--plot_audio", "off"]}[decoder]
    train_main(_args(corpus, f"audio_{decoder}", "--num_epochs", "1",
                     "--epochs_per_plot", "1", *extra))
    assert len(plots) == 1
    if decoder == "off":
        assert clips == {}
        return
    trainer = plots[0]
    assert (trainer.vocoder is not None) == (decoder == "vocoder")
    assert sorted(clips) == ["fake_A_audio", "fake_B_audio", "real_A_audio", "real_B_audio"]
    real_A = trainer.mels_A[0]
    wav, step, sr = clips["real_A_audio"]
    assert step == 1 and sr == 22050 and wav.shape == (real_A.shape[1] * 256,)
    if decoder == "vocoder":
        want = decode_mel(trainer.vocoder, real_A[None], trainer.mean_A, trainer.std_A)[0]
        np.testing.assert_array_equal(wav, want.numpy())
    else:
        np.testing.assert_array_equal(wav, decode_mel_griffin_lim(
            real_A, trainer.mean_A, trainer.std_A, n_iter=32))
    wav_b = clips["fake_B_audio"][0]  # fake B in B's statistics
    assert np.isfinite(wav_b).all() and wav_b.shape == (real_A.shape[1] * 256,)


def test_log_audio_writes_a_wav_where_tensorboard_cannot_encode(tmp_path):
    class NoSoundfile:
        def add_audio(self, *args):
            raise ImportError("soundfile")

        def close(self):
            pass

    logger = TrainLogger(str(tmp_path), "run", use_tensorboard=False)
    logger.log_audio("real_A_audio", np.zeros(512, np.float32), 3)
    assert not list((tmp_path / "run").glob("*.wav"))  # no TensorBoard: nothing
    logger.tb = NoSoundfile()
    logger.log_audio("real_A_audio", np.linspace(-1, 1, 512, dtype=np.float32), 3)
    assert (tmp_path / "run" / "real_A_audio_3.wav").exists()
    logger.close()
