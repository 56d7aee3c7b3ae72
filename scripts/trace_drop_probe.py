#!/usr/bin/env python3
"""Find the kernel launches that a profiler trace leaves out, and why.

Runs the train step at full width, f32, batch 1 x 64 (as ``chip_smoke.py``'s
``obs`` phase does, on two synthetic speakers of 8 seeded random mels) and
traces ``--steps`` steps ``--trials`` times for each way of opening the
trace named in ``--order``:

* ``trace``: ``obs.profiler.trace`` as it stands (``PRIME_LAUNCHES``
  throwaway kernels, then the device idle for ``GUARD_S`` on either side of
  the region);
* ``unguarded``: ``torch.profiler`` started right before the region and
  stopped right after a synchronize, with no idle time.

Each port kernel launch is recorded on the host in order (the wrappers'
``CudaKernel`` calls). In each written trace it matches every host-side
launch event (``cuda_runtime``/``cuda_driver``, a name holding "Launch")
against the kernel events by correlation id, and the port's kernels by
name (``profiler.KERNEL_NAMES``) against the host's launch order. It prints,
per trace, the launch events with no kernel (those of the region, after
the throwaway kernels, apart) and the port launches missing from the trace, each with its place (its index among the region's
launches, the step it belongs to, its microseconds after the first launch
event), and the skew of the device's clock as the trace maps it: each
kernel's start less its launch's (a true delay is positive), least over
the trace and over its first and last 20 kernels. ``--pause`` seconds
between trials let the process age, as a long run's does.

    python3 scripts/trace_drop_probe.py [--trials 8] [--steps 3] [--order trace,unguarded]

The last line is one JSON object: per way, the traces, the launches and
port launches missing in all, each drop's place and each trace's skews.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.data.dataset import (  # noqa: E402
    MelBank,
    sample_batch,
    step_generator,
)
from maskcyclegan_vc_tpu_torch.obs import profiler  # noqa: E402
from maskcyclegan_vc_tpu_torch.ops import cuda_lib, in_gate, ps  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import (  # noqa: E402
    TrainConfig,
    create_train_state,
)
from maskcyclegan_vc_tpu_torch.train.step import make_train_step  # noqa: E402
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device  # noqa: E402

N_MELS, UTTERANCES, FRAMES = 80, 8, 64
FAMILY = {id(e): k for k, by_dtype in (*in_gate.ENTRIES.items(), *ps.ENTRIES.items())
          for e in by_dtype.values()}


@contextlib.contextmanager
def opened(way: str, log_dir: str):
    """A trace of the block, opened as ``way`` says."""
    if way == "trace":
        with profiler.trace(log_dir):
            yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        prof.stop()


def subsequence_gaps(host, seen):
    """Indices of ``host`` left unmatched when ``seen`` is matched in order."""
    gaps, j = [], 0
    for i, k in enumerate(host):
        if j < len(seen) and seen[j] == k:
            j += 1
        else:
            gaps.append(i)
    if j != len(seen):
        raise AssertionError("the trace's port kernels are not in the host's launch order")
    return gaps


def read_trace(log_dir: str, host, per_step: int, opening: int):
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "aunch" in e.get("name", "")), key=lambda e: e["ts"])
    t0 = launches[0]["ts"] if launches else 0.0
    corr = {e.get("args", {}).get("correlation") for e in kernels}
    lost = [{"index": i, "name": e["name"], "us_after_first_launch": e["ts"] - t0}
            for i, e in enumerate(launches) if e.get("args", {}).get("correlation") not in corr]
    fams = []
    for e in kernels:
        k = next((k for k, p in profiler.KERNEL_NAMES.items() if re.search(p, e["name"])), None)
        if k is not None:
            fams.append((k, e))
    gaps = subsequence_gaps(host, [k for k, _ in fams])
    port_lost = [{"index": i, "kernel": host[i], "step": i // per_step,
                  "index_in_step": i % per_step} for i in gaps]
    first_kernel = kernels[0]["ts"] - t0 if kernels else None
    by_corr = {e.get("args", {}).get("correlation"): e for e in launches}
    skew = [k["ts"] - by_corr[c]["ts"] for k in kernels
            if (c := k.get("args", {}).get("correlation")) in by_corr]
    return {"kernels": len(kernels), "launch_events": len(launches), "lost_launches": lost,
            "lost_in_region": [d for d in lost if d["index"] >= opening],
            "port_launched": len(host), "port_in_trace": len(fams), "port_lost": port_lost,
            "first_kernel_us_after_first_launch": first_kernel,
            "skew_us": [round(min(v), 1) if v else None
                        for v in (skew, skew[:20], skew[-20:])]}


def keep_trace(log_dir: str, path: str) -> None:
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(log_dir, name), "rb") as f, gzip.open(path, "wb") as g:
        shutil.copyfileobj(f, g)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--order", default="trace,unguarded")
    ap.add_argument("--pause", type=float, default=0.0)
    ap.add_argument("--keep", default=None,
                    help="a directory to keep (gzipped) each way's first trace that lost a launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_drop_probe: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    rs = np.random.RandomState(0)
    banks = [MelBank.from_list([rs.randn(N_MELS, int(t)).astype(np.float32)
                                for t in rs.randint(173, 518, UTTERANCES)], FRAMES, device)
             for _ in range(2)]
    cfg = TrainConfig(schedule=ScheduleConfig(n_samples=UTTERANCES, batch_size=1),
                      num_frames=FRAMES)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    t_start = time.perf_counter()
    ways = args.order.split(",")
    n = 2 + args.trials * len(ways) * args.steps
    batches = [sample_batch(step_generator(0, i, device), *banks, 1, FRAMES, 25)
               for i in range(n)]
    for b in batches[:2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()

    host = []
    real = cuda_lib.CudaKernel.__call__

    def recorded(self, *a):
        real(self, *a)
        if id(self) in FAMILY:
            host.append(FAMILY[id(self)])

    cuda_lib.CudaKernel.__call__ = recorded
    root = tempfile.mkdtemp(prefix="trace_drop_")
    results = {w: [] for w in ways}
    i = 2
    try:
        for trial in range(args.trials):
            for way in ways:
                time.sleep(args.pause)
                log_dir = os.path.join(root, f"{way}_{trial}")
                host.clear()
                with opened(way, log_dir):
                    for b in batches[i:i + args.steps]:
                        state, m = step(state, b)
                i += args.steps
                opening = 1 + profiler.PRIME_LAUNCHES if way == "trace" else 0
                r = read_trace(log_dir, list(host), len(host) // args.steps, opening)
                results[way].append(r)
                print(f"{way} trial {trial}: {r['kernels']} kernels, {r['launch_events']} "
                      f"launch events, {len(r['lost_launches'])} with no kernel, "
                      f"{len(r['lost_in_region'])} of them in the region "
                      f"{r['lost_in_region'][:4]}; port kernels {r['port_in_trace']} of "
                      f"{r['port_launched']}, missing {r['port_lost'][:4]}; first kernel "
                      f"{r['first_kernel_us_after_first_launch']} us after the first launch; "
                      f"least skew (all, first 20, last 20) {r['skew_us']} us; "
                      f"{time.perf_counter() - t_start:.1f} s in",
                      flush=True)
                if args.keep and (r["lost_in_region"] or r["port_lost"]) and not any(
                        x["lost_in_region"] or x["port_lost"] for x in results[way][:-1]):
                    keep_trace(log_dir, os.path.join(args.keep, f"{way}_{trial}.json.gz"))
                shutil.rmtree(log_dir)
    finally:
        cuda_lib.CudaKernel.__call__ = real
        shutil.rmtree(root, ignore_errors=True)
    float(m["g_loss"])
    summary = {"card": smi, "steps": args.steps}
    for way, rs_ in results.items():
        summary[way] = {
            "traces": len(rs_),
            "launches_lost": sum(len(r["lost_launches"]) for r in rs_),
            "launches_lost_in_region": sum(len(r["lost_in_region"]) for r in rs_),
            "traces_with_a_loss_in_region": sum(bool(r["lost_in_region"] or r["port_lost"])
                                                for r in rs_),
            "port_lost": sum(len(r["port_lost"]) for r in rs_),
            "traces_with_a_loss": sum(bool(r["lost_launches"] or r["port_lost"]) for r in rs_),
            "lost_places": [[(d["index"], round(d["us_after_first_launch"], 1))
                             for d in r["lost_launches"]] for r in rs_],
            "port_lost_places": [[(d["kernel"], d["step"], d["index_in_step"])
                                  for d in r["port_lost"]] for r in rs_],
            "skews_us": [r["skew_us"] for r in rs_],
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
