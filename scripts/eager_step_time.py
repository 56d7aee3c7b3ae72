#!/usr/bin/env python3
"""Time the training step a step at a time (eager, host-dispatched) on one card.

Calls the train step of the package in this checkout (``make_train_step``)
at full width, as ``chip_smoke.py``'s "a step at a time" lines do, on two
synthetic speakers of 8 seeded random mels of 173-517 frames each: at
batch 1 x 64 in f32 and in bf16, ``--warmup`` steps, then ``--steps``
steps timed on the host clock, each ending in a synchronize, in
``--rounds`` rounds. It prints each round's median, min and max and the
median over all steps. At 1 x 64 the step is bound by host dispatch (the
device idles most of the time), so the number moves with the host's load:
compare two checkouts only within one chip call, each checkout's copy of
this script run in turns (A, B, B, A):

    python3 scripts/eager_step_time.py [--label NAME] [--steps 30] [--rounds 3]

The last line is one JSON object with the label and, per dtype, the median
ms over all timed steps and each round's median.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.data.dataset import (  # noqa: E402
    MelBank,
    sample_batch,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import (  # noqa: E402
    TrainConfig,
    create_train_state,
)
from maskcyclegan_vc_tpu_torch.train.step import make_train_step  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import precision_scope, resolve_device  # noqa: E402

N_MELS, UTTERANCES = 80, 8


def banks(device, frames: int):
    rs = np.random.RandomState(0)
    return [MelBank.from_list([rs.randn(N_MELS, int(t)).astype(np.float32)
                               for t in rs.randint(173, 518, UTTERANCES)], frames, device)
            for _ in range(2)]


def time_steps(device, dtype, batch: int, frames: int, warmup: int, steps: int,
               rounds: int):
    bank_a, bank_b = banks(device, frames)
    cfg = TrainConfig(schedule=ScheduleConfig(n_samples=len(bank_a), batch_size=batch),
                      num_frames=frames, dtype=dtype)
    with precision_scope(cfg.precision):
        state = create_train_state(cfg, 0, device)
        step = make_train_step(cfg)
        n = warmup + steps * rounds
        batches = [sample_batch(step_generator(0, i, device), bank_a, bank_b, batch, frames, 25)
                   for i in range(n)]
        torch.cuda.synchronize()
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"non-finite metrics: {m}")
    timed = times[warmup:]
    per_round = [timed[r * steps:(r + 1) * steps] for r in range(rounds)]
    del state, batches
    torch.cuda.empty_cache()
    return float(np.median(timed)), per_round


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eager_step_time: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    out = {"label": args.label}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        med, per_round = time_steps(device, dtype, args.batch, args.frames, args.warmup,
                                    args.steps, args.rounds)
        medians = [float(np.median(r)) for r in per_round]
        for i, r in enumerate(per_round):
            print(f"{args.label} {name} {args.batch} x {args.frames} round {i}: median "
                  f"{np.median(r):.3f} ms, min {min(r):.3f}, max {max(r):.3f} "
                  f"({len(r)} steps)", flush=True)
        print(f"{args.label} {name} {args.batch} x {args.frames}: median {med:.3f} ms over "
              f"{args.steps * args.rounds} steps; card: {smi}", flush=True)
        out[name] = {"median_ms": med, "round_medians_ms": medians}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
