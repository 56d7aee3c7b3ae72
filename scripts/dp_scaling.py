#!/usr/bin/env python3
"""Data-parallel training across the cards of one host: right and how fast.

Launches itself under torchrun, one process per card (``--world``, all the
cards by default), NCCL. Each rank builds the published model at full
width with seeded random weights and the same synthetic speakers, then:

1. Right: three f32 steps a step at a time with deterministic cuDNN, each
   rank on its row of a global batch of ``world`` x 64 frames, the
   gradients averaged by ``parallel.mesh.explicit_sync_fns``; rank 0 then
   runs the same three steps alone on the whole batch, and prints the
   largest relative gap of the logged losses (the first step's G losses
   precede every gradient: 1e-5; the rest follow updates that the order of
   the sums can move by Adam's quantum: 1e-3).
2. Fast: bf16 steps as CUDA-graph replays (``--scan_epochs 1``'s runner)
   at each ``--sizes`` entry, per rank: the synced run of the global batch
   (``world`` x the size's rows), and the same rows on each card alone
   without the sync, in turns, spans of ``--steps`` steps; rank 0 prints
   ms/step of both (median and spans), the scaling efficiency (alone over
   synced), and its NCCL kernels' device time a step from torch.profiler.

    python3 scripts/dp_scaling.py [--world 4] [--sizes 1x64 32x128]
        [--steps 20] [--spans 3]

``--device cpu`` (gloo, no graphs, no timings worth reading) with
``--n_mels``/``--residual_channels`` rehearses the control flow at a tiny
width on a CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from maskcyclegan_vc_tpu_torch.data.dataset import (  # noqa: E402
    MelBank,
    sample_batch,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.parallel import dist as pdist  # noqa: E402
from maskcyclegan_vc_tpu_torch.parallel.mesh import (  # noqa: E402
    explicit_sync_fns,
    shard_batch,
    wire_bytes,
)
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.step import (  # noqa: E402
    LOGGED_METRICS,
    make_train_step,
    make_update,
)
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

UTTERANCES = 8
G_LOSSES = [LOGGED_METRICS.index(k) for k in ("g_loss", "g_adv_loss", "g_cycle_loss",
                                                "g_identity_loss")]


def say(msg: str) -> None:
    if pdist.rank() == 0:
        print(msg, flush=True)


def banks(args, device, frames: int):
    rs = np.random.RandomState(1)
    out = []
    for _ in range(2):
        lens = rs.randint(max(128, frames), 518, size=UTTERANCES)
        out.append(MelBank.from_list([rs.randn(args.n_mels, t).astype(np.float32) for t in lens],
                                     frames, device))
    return out


def config(args, batch: int, frames: int, dtype=None) -> TrainConfig:
    return TrainConfig(schedule=ScheduleConfig(n_samples=UTTERANCES, batch_size=batch),
                       n_mels=args.n_mels, num_frames=frames,
                       residual_channels=args.residual_channels, dtype=dtype)


def logged(metrics) -> list:
    return [float(metrics[k]) for k in LOGGED_METRICS]


def right(args, device, world: int) -> None:
    """Three synced f32 steps against one process on the whole batch."""
    torch.backends.cudnn.deterministic = True
    cfg = config(args, world, 64)
    bank = banks(args, device, 64)
    batches = [sample_batch(step_generator(0, i, device), *bank, world, 64, 25)
               for i in range(3)]
    state = create_train_state(cfg, 0, device)
    grad_sync, metric_sync = explicit_sync_fns("float32")
    step = make_train_step(cfg, True, grad_sync=grad_sync, metric_sync=metric_sync)
    synced = [logged(step(state, shard_batch(b))[1]) for b in batches]
    del state
    if pdist.rank() == 0:
        state, step = create_train_state(cfg, 0, device), make_train_step(cfg)
        alone = [logged(step(state, b)[1]) for b in batches]
        del state
        rel = np.abs(np.array(synced) - alone) / np.abs(alone)
        print(f"dp_scaling: right: {world} ranks x 1 x 64 rows against one process on the "
              f"{world} x 64 batch, f32, deterministic cuDNN, 3 steps: step 1's G losses within "
              f"{rel[0, G_LOSSES].max():.3g} relative (bound 1e-5), every loss within "
              f"{rel.max():.3g} (bound 1e-3)", flush=True)
        if rel[0, G_LOSSES].max() > 1e-5 or rel.max() > 1e-3:
            raise AssertionError("the synced steps disagree with one process")
    torch.backends.cudnn.deterministic = False
    dist.barrier()


def nccl_ms(runner, state, k: int) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.run(state, k)
        torch.cuda.synchronize()
    us = sum((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())
    return us / 1e3 / k


def fast(args, device, world: int, rows: int, frames: int) -> None:
    """bf16 replays: the synced global batch against each card alone."""
    bank = banks(args, device, frames)
    runs = {}
    for name, batch, sync, part in (
            ("synced", rows * world, explicit_sync_fns("float32"),
             pdist.local_batch_slice(rows * world)),
            ("alone", rows, (None, None), slice(None))):
        cfg = config(args, batch, frames, torch.bfloat16)
        state = create_train_state(cfg, 0, device, capturable=device.type == "cuda")
        update = make_update(cfg, True, False, *sync)
        runner = StepRunner(cfg, lambda step, u=update: u, *bank, 0, batch, frames, 25,
                            rows=part)
        runner.run(state, 4)  # step 0 eager, then captured; 1-3 replayed
        runs[name] = (state, runner)
    walls = {name: [] for name in runs}
    for i in range(args.spans):
        for name in (("synced", "alone") if i % 2 == 0 else ("alone", "synced")):
            state, runner = runs[name]
            dist.barrier()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run(state, args.steps)
            if device.type == "cuda":
                torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0) / args.steps)
    med = {name: float(np.median(w)) for name, w in walls.items()}
    state, runner = runs["synced"]
    coll = nccl_ms(runner, state, 2) if device.type == "cuda" else float("nan")
    n_bytes = wire_bytes(state.g_params() + state.d_params(), None)
    say(f"dp_scaling: fast: bf16 replays, {world} ranks x {rows} x {frames} rows (global "
        f"batch {rows * world}): synced {med['synced']:.3f} ms/step (spans "
        f"{[round(w, 3) for w in walls['synced']]}), each card alone on its {rows} x {frames} "
        f"{med['alone']:.3f} ms/step (spans {[round(w, 3) for w in walls['alone']]}); "
        f"scaling efficiency {med['alone'] / med['synced']:.4f}; rank 0's NCCL kernels "
        f"{coll:.4f} ms a step for {n_bytes} bytes of f32 gradients; "
        f"{rows * world * frames * 256 / 22050 / (med['synced'] / 1e3):.2f} audio-s trained "
        f"per s")
    del runs, state, runner
    if device.type == "cuda":
        torch.cuda.empty_cache()


def worker(args) -> None:
    created = pdist.initialize(args.device)
    try:
        world = pdist.world_size()
        device = resolve_device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        say(f"dp_scaling: world {world} over {dist.get_backend()}; torch "
            f"{torch.__version__}")
        right(args, device, world)
        for size in args.sizes:
            rows, frames = (int(v) for v in size.split("x"))
            fast(args, device, world, rows, frames)
    finally:
        pdist.finalize(created)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=0, help="processes (0: every card)")
    p.add_argument("--sizes", nargs="+", default=["1x64", "32x128"],
                   help="rows x frames each rank trains a step")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--spans", type=int, default=3)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--residual_channels", type=int, default=256)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(args)
        return 0
    world = args.world or torch.cuda.device_count()
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < world):
        print(f"dp_scaling: needs {world} CUDA devices", file=sys.stderr)
        return 1
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    argv = [a for a in sys.argv[1:]]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
           "--master_addr", "127.0.0.1", "--master_port", str(29400 + os.getpid() % 500),
           os.path.abspath(__file__), "--worker", *argv]
    return subprocess.run(cmd, cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
