"""Training loop: sampler -> train step -> logs -> checkpoints.

Counterpart of ``maskcyclegan_vc_tpu/train/trainer.py``. The
identity-loss variant of the step switches off after
``stop_identity_after // batch_size`` steps. Every epoch runs through one
loop, ``train.graphs.StepRunner.run``, which draws each batch on the device
from a generator seeded by (seed, step), so ``--continue_train`` resumes
the batch stream of an uninterrupted run, whatever ``scan_epochs`` says.
Its only switch is whether the card captures the step: with
``scan_epochs`` (the default, as in the JAX trainer) each identity variant
is a CUDA graph, replayed for every later step; without it, or inside
``utils.debug.nan_debug_mode`` (a CUDA graph would hide the operations from
its checks), or on the CPU, every step runs eagerly. Either way the epoch's
metrics are read from the device once, at its end, and then logged step by
step. The Adam form follows the device alone: the capturable one on the
card, captured or not, and torch's plain one on the CPU.

``dtype``, ``precision`` and ``fused_norms`` resolve as the JAX trainer's
do (``train/trainer.py:137-151``) on a backend that is not a TPU: ``auto``
is float32, and the kernels on the card. ``precision`` holds for the whole
run (``utils.device.precision_scope``) and is restored after it. The plot's
conversions run in f32, as the JAX trainer's do. The f32 steps, captured
or not, run with cuDNN's autotuner on (``StepRunner.run`` turns it on
for them); the bf16 steps, and the plot's conversions and decodes at
each utterance's own length, on its heuristics.

Data parallel (``cli/train.py --distributed`` under torchrun, which joins
the process group first: ``parallel/dist.py``), as the JAX trainer builds
its world (``train/trainer.py:155-222``): every process seeds (or loads)
the same state, which ``parallel.mesh.replicate`` then broadcasts from rank
0; each draws the same global batch and trains on its contiguous
``batch_size / world`` rows, and each side's gradients and the logged
losses are averaged over the processes (``parallel.mesh.explicit_sync_fns``,
on a ``grad_allreduce_dtype`` wire), captured or not. A batch that the world
does not divide raises; a batch smaller than the world runs replicated
(every process the whole batch, no collectives), with a warning. Only rank
0 writes checkpoints, plots and logs.

At each epoch's end every step's logged losses are checked for finiteness,
and a failing epoch's per-step values are written to the log before the run
stops; the error names the remedy, a rerun under ``nan_debug_mode``.
However the loop ends, an in-flight checkpoint write is flushed and the
logger closed.

The log's timings come from the program's spans (``obs/profiler.py``):
each epoch is a ``train.epoch`` span holding ``train.readback``,
``train.plot`` and ``train.save``, and its line gives their ms; a step's
``ms/it`` is the epoch's ``train.run`` span plus its read-back over its
steps (the metrics of a whole epoch reach the logger at once). After the
first epoch one ``[setup]`` line gives the kernel loads, the state's
creation and the first steps (``setup_line``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.data.griffin_lim import decode_mel_griffin_lim
from maskcyclegan_vc_tpu_torch.data.dataset import MelBank, load_speaker
from maskcyclegan_vc_tpu_torch.io.checkpoint import (
    AsyncSaver,
    checkpoint_path,
    latest_epoch,
    load_train_state,
    rotate_checkpoints,
    save_checkpoint,
)
from maskcyclegan_vc_tpu_torch.io.jax_params import train_state_to_jax
from maskcyclegan_vc_tpu_torch.models.melgan import decode_mel
from maskcyclegan_vc_tpu_torch.models.vocoder import load_vocoder
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.obs.logger import TrainLogger, to_host
from maskcyclegan_vc_tpu_torch.parallel.dist import local_batch_slice, rank, world_size
from maskcyclegan_vc_tpu_torch.parallel.mesh import (
    WIRE_DTYPES,
    explicit_sync_fns,
    replicate,
    wire_bytes,
)
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import LOGGED_METRICS, METRICS, make_update
from maskcyclegan_vc_tpu_torch.utils.debug import check_finite
from maskcyclegan_vc_tpu_torch.utils.device import allows_tf32, precision_scope, resolve_device

DTYPES = {"auto": None, "float32": None, "bfloat16": torch.bfloat16}


def setup_line() -> str:
    """The process's set-up by phase, from its spans: the kernel libraries
    loaded (and how many nvcc built), the train state's creation, the
    first steps of each variant (eager and captured; kernel loads and
    cuDNN's timings they triggered included), and the conv problems met
    with cuDNN's autotuner on (``conv.autotuned``)."""
    totals, counters = profiler.totals(), profiler.counters()
    n, s = totals.get("kernels.load", (0, 0.0))
    parts = [f"kernels {n} loaded ({counters.get('kernels.built', 0)} built by nvcc) "
             f"in {s:.2f} s"]
    for name, label in (("train.create_state", "state"), ("train.first_step", "first step")):
        if name in totals:
            parts.append(f"{label} {totals[name][1]:.2f} s")
    parts.append(f"conv problems autotuned {counters.get('conv.autotuned', 0)}")
    return "[setup] " + "; ".join(parts)


@dataclasses.dataclass
class TrainerArgs:
    """Run-level settings, named as the reference's flags are."""

    name: str = "mask_cyclegan_vc"
    save_dir: str = "results"
    seed: int = 0
    speaker_A_id: str = "VCC2SF3"
    speaker_B_id: str = "VCC2TF1"
    preprocessed_data_dir: str = "vcc2018_preprocessed/vcc2018_training"
    num_epochs: int = 6172
    batch_size: int = 1
    num_frames: int = 64
    max_mask_len: int = 25
    generator_lr: float = 2e-4
    discriminator_lr: float = 1e-4
    decay_after: int = 200_000
    stop_identity_after: int = 10_000
    cycle_loss_lambda: float = 10.0
    identity_loss_lambda: float = 5.0
    epochs_per_save: int = 100
    epochs_per_plot: int = 10
    steps_per_print: int = 100
    max_ckpts: int = 0  # 0 = keep all
    continue_train: bool = False
    ref_compat_lr: bool = False
    n_mels: int = 80
    residual_channels: int = 256
    remat: bool = False
    sample_rate: int = 22050
    async_save: bool = True
    # The step as CUDA-graph replays on the card (train/graphs.py); False =
    # every step eagerly. Either way the epoch is read once, at its end.
    scan_epochs: bool = True
    # "metrics": raise at epoch end if any step's logged loss is not
    # finite; "params": also check the whole state before each checkpoint
    # write, so a diverged run never overwrites its last good one.
    finite_check: str = "metrics"
    # melgan-neurips checkpoint for the audio at plot cadence
    vocoder_ckpt: Optional[str] = None
    # "auto": the four panels decoded to audio at plot cadence, by MelGAN
    # with vocoder_ckpt, else by Griffin-Lim (32 iterations); "off": none.
    plot_audio: str = "auto"
    # Compute dtype: "auto" (float32 off a TPU, as in the JAX trainer),
    # "float32" or "bfloat16"; parameters and checkpoints stay f32.
    dtype: str = "auto"
    # Convolution and matmul precision: None, "highest" or "float32" keep
    # true f32; "high", "tensorfloat32" or "default" allow TF32.
    precision: Optional[str] = None
    # "auto" or "1": the norm kernels on the card; "0": their plain versions.
    fused_norms: str = "auto"
    device: str = "cuda"
    # Wire dtype of the data-parallel gradient all-reduce: None or "float32"
    # (the gradients' own), "bfloat16" (half the bytes).
    grad_allreduce_dtype: Optional[str] = None


class Trainer:
    def __init__(self, args: TrainerArgs):
        self.args = a = args
        if a.dtype not in DTYPES or a.fused_norms not in ("auto", "0", "1"):
            raise ValueError(f"dtype {a.dtype!r} or fused_norms {a.fused_norms!r} "
                             f"not one of {sorted(DTYPES)}, auto/0/1")
        allows_tf32(a.precision)  # raises for an unknown precision
        if a.grad_allreduce_dtype not in WIRE_DTYPES:
            raise ValueError(f"grad_allreduce_dtype {a.grad_allreduce_dtype!r} not one of "
                             f"float32, bfloat16")
        self.device = resolve_device(a.device)
        self.mels_A, self.mean_A, self.std_A = load_speaker(
            a.preprocessed_data_dir, a.speaker_A_id)
        self.mels_B, self.mean_B, self.std_B = load_speaker(
            a.preprocessed_data_dir, a.speaker_B_id)
        self.bank_A = MelBank.from_list(self.mels_A, a.num_frames, self.device)
        self.bank_B = MelBank.from_list(self.mels_B, a.num_frames, self.device)
        sched = ScheduleConfig(
            generator_lr=a.generator_lr, discriminator_lr=a.discriminator_lr,
            decay_after=a.decay_after, stop_identity_after=a.stop_identity_after,
            num_epochs=a.num_epochs, n_samples=min(len(self.bank_A), len(self.bank_B)),
            batch_size=a.batch_size, identity_loss_lambda=a.identity_loss_lambda,
            cycle_loss_lambda=a.cycle_loss_lambda, ref_compat_lr=a.ref_compat_lr)
        self.cfg = TrainConfig(schedule=sched, n_mels=a.n_mels, num_frames=a.num_frames,
                               residual_channels=a.residual_channels, remat=a.remat,
                               dtype=DTYPES[a.dtype], precision=a.precision,
                               fused_norms=a.fused_norms != "0")
        self.steps_per_epoch = sched.steps_per_epoch
        self._identity_cutoff = a.stop_identity_after // a.batch_size
        self._step_fns = {}

        self.state = create_train_state(self.cfg, a.seed, self.device,
                                        capturable=self.device.type == "cuda")
        self.start_epoch = 1
        self.ckpt_dir = os.path.join(a.save_dir, a.name, "ckpts")
        if a.continue_train:
            last = latest_epoch(self.ckpt_dir)
            if last is not None:
                load_train_state(checkpoint_path(self.ckpt_dir, last), self.state)
                self.start_epoch = last + 1
        self._sync, self._rows = self._build_world()
        self._runner = StepRunner(self.cfg, lambda step: self.step_fn(step),
                                  self.bank_A, self.bank_B, a.seed, a.batch_size,
                                  a.num_frames, a.max_mask_len, rows=self._rows,
                                  graphs=a.scan_epochs)

        self.vocoder = (load_vocoder(a.vocoder_ckpt, self.device)
                        if a.vocoder_ckpt and rank() == 0 else None)
        self.logger = TrainLogger(a.save_dir, a.name, steps_per_print=a.steps_per_print,
                                  config=dataclasses.asdict(a))
        self._saver = AsyncSaver()

    def _build_world(self):
        """(the update's sync hooks, this process's rows of the global
        batch): data parallel where a process group exists and the world
        divides the batch, else none and every row."""
        a, n = self.args, world_size()
        if a.batch_size % n and a.batch_size > n:
            raise ValueError(f"batch_size {a.batch_size} not divisible by {n} processes")
        if not dist.is_initialized() or a.batch_size < n:
            if n > 1:
                print(f"WARNING: batch_size {a.batch_size} < {n} processes — every process "
                      "trains the whole batch (replicated, no collectives); raise "
                      "--batch_size to a multiple of the process count to split it.",
                      flush=True)
            return {}, slice(None)
        tensors, n_bytes = replicate(self.state)
        grad_sync, metric_sync = explicit_sync_fns(a.grad_allreduce_dtype)
        g, d = self.state.g_params(), self.state.d_params()
        wire = a.grad_allreduce_dtype or "float32"
        print(f"[dist] data parallel over {n} processes, {a.batch_size // n} of {a.batch_size} "
              f"rows each; state broadcast from rank 0 ({tensors} tensors, {n_bytes} bytes); "
              f"each step all-reduces {sum(p.numel() for p in g)} G and "
              f"{sum(p.numel() for p in d)} D gradient values, "
              f"{wire_bytes(g, a.grad_allreduce_dtype) + wire_bytes(d, a.grad_allreduce_dtype)}"
              f" bytes on a {wire} wire, and {len(METRICS)} metrics", flush=True)
        return {"grad_sync": grad_sync, "metric_sync": metric_sync}, local_batch_slice(a.batch_size)

    def step_fn(self, step: int):
        """The update (``make_update``) with identity terms up to the cutoff,
        without after it; one object per variant."""
        wi = step <= self._identity_cutoff
        if wi not in self._step_fns:
            self._step_fns[wi] = make_update(self.cfg, with_identity=wi, **self._sync)
        return self._step_fns[wi]

    def train(self) -> None:
        try:
            with precision_scope(self.cfg.precision):
                self._run()
        finally:
            try:
                self._saver.wait()
            finally:
                self.logger.close()

    def _run(self) -> None:
        a = self.args
        for epoch in range(self.start_epoch, a.num_epochs + 1):
            first = self.state.step + 1
            with profiler.span("train.epoch", request=epoch) as ep:
                out = self._runner.run(self.state, self.steps_per_epoch)
                with profiler.span("train.readback") as back:
                    vals = out.cpu().tolist()  # the epoch's one read of the device
                # A step's time: its share of issuing the span and waiting for it.
                step_s = ((profiler.last("train.run").seconds + back.seconds)
                          / self.steps_per_epoch)
                rows = [dict(zip(LOGGED_METRICS, v)) for v in vals]
                for i, row in enumerate(rows):
                    self.logger.log_iter(first + i, epoch, row, batch_size=a.batch_size,
                                         seconds=step_s)
                self._check_metrics_finite(rows, epoch, first)
                plot = save = None
                if epoch % a.epochs_per_plot == 0:
                    with profiler.span("train.plot") as plot:
                        self._plot(epoch)
                if epoch % a.epochs_per_save == 0:
                    with profiler.span("train.save") as save:
                        self._save(epoch)
            if epoch == self.start_epoch:
                self.logger.write(setup_line())
            ms = {k: f"{1e3 * sp.seconds:.1f} ms" if sp else "none"
                  for k, sp in (("read-back", back), ("plot", plot), ("save", save))}
            self.logger.write(f"epoch {epoch} done in {ep.seconds:.1f}s ("
                              + ", ".join(f"{k} {v}" for k, v in ms.items()) + ")",
                              console=False)

    def _check_metrics_finite(self, rows, epoch: int, first_step: int) -> None:
        """Every step's logged losses, read in one transfer; a failing
        epoch's steps are written to the log before the error is raised."""
        if self.args.finite_check == "off":
            return
        vals = to_host(rows)
        try:
            check_finite({f"step {first_step + i}": v for i, v in enumerate(vals)},
                         f"train metrics at epoch {epoch} (rerun under "
                         "maskcyclegan_vc_tpu_torch.utils.debug.nan_debug_mode to "
                         "localize the producing op)")
        except FloatingPointError:
            for i, v in enumerate(vals):
                self.logger.write(" ".join([f"[epoch {epoch} step {first_step + i}]"]
                                           + [f"{k}: {x:.5f}" for k, x in sorted(v.items())]))
            raise

    def _save(self, epoch: int) -> None:
        if rank() != 0:
            return
        path = checkpoint_path(self.ckpt_dir, epoch)
        host = train_state_to_jax(self.state)  # copies off the device, synchronously
        if self.args.finite_check == "params":
            check_finite(host, f"train state at save epoch {epoch}")
        meta = {"seed": self.args.seed, "epoch": epoch,
                "mean_A": self.mean_A, "std_A": self.std_A,
                "mean_B": self.mean_B, "std_B": self.std_B}

        def rotate():
            rotate_checkpoints(self.ckpt_dir, self.args.max_ckpts)

        if self.args.async_save:
            self._saver.save(path, host, meta, on_done=rotate)
        else:
            save_checkpoint(path, host, meta)
            rotate()

    def _plot(self, epoch: int) -> None:
        """Spectrograms of one utterance per side and its conversion, through
        the bucketed conversion path, a different utterance each time; and,
        unless ``plot_audio`` is off, the four decoded to audio, each in its
        speaker's statistics: by the vocoder where one is loaded, else by
        Griffin-Lim at 32 iterations. Rank 0 only."""
        if rank() != 0:
            return
        idx = epoch // max(1, self.args.epochs_per_plot) - 1
        real_A = self.mels_A[idx % len(self.mels_A)]
        real_B = self.mels_B[idx % len(self.mels_B)]
        fake_B = make_convert_fn(self.state.g["A2B"].with_dtype(None))(real_A)
        fake_A = make_convert_fn(self.state.g["B2A"].with_dtype(None))(real_B)
        panels = {"real_A_spec": real_A, "fake_B_spec": fake_B,
                  "real_B_spec": real_B, "fake_A_spec": fake_A}
        self.logger.log_spectrogram_grid(panels, epoch)
        for tag, mel in panels.items():
            self.logger.log_spectrogram(tag, mel, epoch)
        if self.args.plot_audio == "off":
            return
        stats = {"A": (self.mean_A, self.std_A), "B": (self.mean_B, self.std_B)}
        for tag, mel in panels.items():
            mean, std = stats[tag.split("_")[1]]
            if self.vocoder is not None:
                wav = decode_mel(self.vocoder, mel[None], mean, std)[0].cpu().numpy()
            else:
                wav = decode_mel_griffin_lim(mel, mean, std, n_iter=32)
            self.logger.log_audio(tag.replace("_spec", "_audio"), wav, epoch,
                                  self.args.sample_rate)
