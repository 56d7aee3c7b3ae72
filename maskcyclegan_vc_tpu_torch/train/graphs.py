"""The one loop over training steps: the counterpart of ``--scan_epochs``.

The JAX trainer runs each epoch as one device program (``make_scan_epoch``,
``maskcyclegan_vc_tpu/train/step.py:293-328``): a ``lax.scan`` over steps
that samples each batch on the device and returns the epoch's metrics
stacked. ``StepRunner.run`` is its counterpart, and the trainer's only loop
over steps: it runs a span of steps and returns their logged metrics in one
device buffer, (steps, 7), with no host read between them, so the caller
reads the device once for the span. Its one switch is capture or not:
``graphs`` (the trainer passes ``scan_epochs``).

On the card each identity variant of the step (the sampler, the update and
the metrics row) is a CUDA graph. The first step of a variant runs eagerly
on a side stream, as a real step of the run; the graph is captured after it
on the same stream and replayed for every later step of that variant.
Before each step, eager or replayed, the host writes the step's inputs on
the device: it reseeds the sampler's generator, which is registered with
the graph, with ``step_seed(seed, step)``, and writes both learning rates
into the capturable Adams' device tensors. A reseeded Philox generator
starts at offset 0, as the fresh one of ``step_generator`` does, so a step
draws the batch that ``sample_batch(step_generator(seed, step, ...))``
draws, bit for bit, captured or not; a run resumes across modes. The
identity weight is a constant of the variant. When the trainer moves to the
other variant (once, at the identity cutoff) the old graph and its memory
are dropped. A capture synchronises the device once (``torch.cuda.graph``
does, to free memory for the graph): once per variant and process.

On the CPU, on a runner built with ``graphs=False``, and inside
``utils.debug.nan_debug_mode`` (whose checks a replay would skip) the same
function runs eagerly for every step, on the current stream, and nothing is
captured. The step, the sampler's reseeding and the learning-rate writes are
the same as under capture, and so is the optimizer: the state's Adams are
capturable on the card whatever ``graphs`` says, so the two modes differ
only in how the step's kernels are issued.

The f32 steps run with cuDNN's autotuner on (``utils.device.autotune_scope``,
``autotunes``; bf16 steps keep its heuristics): every conv problem of a run
has the same shapes at every step, so cuDNN times its candidate engines for
each problem in the variant's eager first step and keeps the winners in its
plan cache. The capture runs with the autotuner's timing off: it looks the
tuned plans up, and a problem it met first would take the heuristics' plan,
never a timing inside the capture. Replays run the captured plans.

Data parallel (``rows``, and an update made with ``parallel/mesh``'s sync
hooks): every process draws the same global batch from ``step_seed(seed,
step)`` and trains on its contiguous ``rows`` of it, as the JAX package's
``make_shardmap_scan_epoch`` slices each device's block. The update's
all-reduces run on the capture stream, so the graph holds them and every
replay runs them. The eager first step runs them first, so the process
group's communicator exists before the capture; a capture that cannot take
a collective raises, and nothing is replayed without it.

``CudaKernel.launches`` counts host calls: a capture counts each kernel of
the step once, though nothing runs then, and a replay counts nothing. A
caller that wants the launches on the card counts each graph's launches at
capture and multiplies them by its replays (``chip_smoke.py`` does).

Spans (``obs/profiler.py``), each with the step as its request: ``run`` is
a ``train.run`` span holding, for each step, ``train.inputs`` (the reseed
and the learning-rate writes) and ``train.replay`` (in ``replay``) or
``train.first_step`` (the eager step and the capture). Nothing synchronises
inside ``run``, so on the card a ``train.run`` span is the host's time to
issue its steps, not their device time.
"""

from __future__ import annotations

from typing import Callable

import torch

from maskcyclegan_vc_tpu_torch.data.dataset import MelBank, sample_batch, step_seed
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.train.schedules import identity_lambda
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, TrainState
from maskcyclegan_vc_tpu_torch.train.step import LOGGED_METRICS
from maskcyclegan_vc_tpu_torch.utils.debug import nan_debug_active
from maskcyclegan_vc_tpu_torch.utils.device import autotune_scope, autotunes, cudnn_benchmark


class StepRunner:
    """Runs the train steps of a span with one device buffer of metrics.

    ``update_for(step)`` returns the update function (``make_update``) of
    the step's identity variant, the same object for every step of a
    variant. ``batch_size`` is the global batch, of which the step trains
    on ``rows``. The state's optimizers must be capturable on the card
    (``create_train_state(..., capturable=True)``). ``graphs``: capture
    each variant on the card and replay it (True), or run every step
    eagerly (False).
    """

    def __init__(self, cfg: TrainConfig, update_for: Callable[[int], Callable],
                 bank_a: MelBank, bank_b: MelBank, seed: int, batch_size: int,
                 num_frames: int, max_mask_len: int, rows: slice = slice(None),
                 graphs: bool = True):
        self.cfg = cfg
        self.graphs = graphs
        self.rows = rows     # this process's rows of the global batch
        self.update_for = update_for
        self.banks = (bank_a, bank_b)
        self.seed = seed
        self.shape = (batch_size, num_frames, max_mask_len)
        self.device = bank_a.data.device
        self.generator = torch.Generator(device=self.device)
        self.graph = None    # (update, CUDAGraph, batch, metrics row) of the variant
        self.batch = None    # the last step's batch
        self.step = None     # the step being run: the request of its spans
        self.replays = 0

    def _body(self, state: TrainState, update, lam_id: float):
        """(batch, metrics row) of one step."""
        batch = sample_batch(self.generator, *self.banks, *self.shape)
        batch = {k: v[self.rows] for k, v in batch.items()}
        metrics = update(state, batch, lam_id)
        return batch, torch.stack([metrics[k] for k in LOGGED_METRICS])

    def _first_step(self, state: TrainState, update, lam_id: float,
                    row: torch.Tensor) -> None:
        """The variant's first step, eagerly on a side stream, into ``row``;
        then the capture, on that stream, of the graph of its later steps."""
        self.graph = None  # the other variant's graph is not needed again
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("--scan_epochs 1 on the card needs "
                               "torch.cuda.CUDAGraph.register_generator_state; "
                               "pass --scan_epochs 0")
        with profiler.span("train.first_step", request=self.step):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.batch, out = self._body(state, update, lam_id)
                row.copy_(out)
            current.wait_stream(side)
            self.graph = (update, *self.capture(state, update, lam_id, side))

    def capture(self, state: TrainState, update, lam_id: float, stream):
        """(graph, batch, metrics row) of the variant's step, captured on
        ``stream``. Nothing runs: the batch and the row are the graph's own
        tensors, which each replay overwrites. Raises inside
        ``utils.debug.nan_debug_mode``, whose checks a replay would skip."""
        if nan_debug_active():
            raise RuntimeError("a CUDA graph replays its kernels without the NaN checks of "
                               "nan_debug_mode: run the steps one at a time inside it "
                               "(the trainer does)")
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with cudnn_benchmark(False), torch.cuda.graph(graph, stream=stream):
            batch, out = self._body(state, update, lam_id)
        return graph, batch, out

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        with profiler.span("train.replay", request=self.step):
            graph.replay()
        self.replays += 1

    def run(self, state: TrainState, n_steps: int) -> torch.Tensor:
        """``n_steps`` steps from ``state.step``, the state updated in place;
        returns their logged metrics, (n_steps, len(LOGGED_METRICS)), on the
        device, in ``LOGGED_METRICS`` order. cuDNN's autotuner is on for the
        span's steps where their dtype ``autotunes``, and restored after it.
        Every step runs eagerly on the CPU, without ``graphs`` and inside
        ``nan_debug_mode``."""
        eager = self.device.type == "cpu" or not self.graphs or nan_debug_active()
        with profiler.span("train.run", request=state.step), \
                autotune_scope(autotunes(self.cfg.dtype)):
            rows = torch.empty((n_steps, len(LOGGED_METRICS)), device=self.device)
            sched = self.cfg.schedule
            for j in range(n_steps):
                self.step = state.step
                update = self.update_for(state.step)
                lam_id = identity_lambda(sched, state.step)
                with profiler.span("train.inputs", request=state.step):
                    self.generator.manual_seed(step_seed(self.seed, state.step))
                    state.set_learning_rates(sched)
                if eager:
                    self.batch, rows[j] = self._body(state, update, lam_id)
                elif self.graph is not None and self.graph[0] is update:
                    self.replay(self.graph[1])
                    self.batch = self.graph[2]
                    rows[j] = self.graph[3]
                else:
                    self._first_step(state, update, lam_id, rows[j])
                state.step += 1
        return rows
