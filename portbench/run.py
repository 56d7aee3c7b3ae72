#!/usr/bin/env python3
"""The benchmark of ``maskcyclegan_vc_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's program objects from the seed (set-up, timed as
``setup_s`` from the process's start), measures for ``--seconds`` seconds,
with ``--trace 1`` traces a fixed slice after that, reads the peak memory,
frees the program, checks what the timed path produced against the plain
reference (``portbench/reference/``), and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``, each
number of the check beside its limit (also the last lines on standard
error).

It exits non-zero and prints no result without as many cards as the cell
asks for, and if JAX, Flax or the JAX package was loaded. A cell on several
cards starts one process a card (ranks 1.. are this script again, with
``--rank``) and waits for each; rank 0 prints.

``--control 1`` puts the cell's control in the program's place and
``--fault <name>`` plants one of the faults the check must catch; both are
for proving the check (``portbench/readings.py``), never for a measured
run. ``--rehearse_cpu`` runs the whole flow on the CPU at a tiny width,
with the kernels' plain versions, for the harness's own tests; it never
stands in for a card.
"""

from __future__ import annotations

import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.clock import T_START, say  # noqa: E402  (before torch: the start's clock)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from maskcyclegan_vc_tpu_torch.parallel import dist as pdist  # noqa: E402
from portbench import catalog, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "maskcyclegan_vc_tpu")
# The width a CPU rehearsal runs at (--rehearse_cpu): the published shapes
# shrunk so that a run takes seconds on a CPU.
TINY_CONFIG = {"n_mels": 16, "residual_channels": 8, "vocoder": {"ngf": 4}}
TINY_TRAFFIC = {"frames": 16, "utterances": 6, "utterance_frames": [16, 40],
                "batch": 2, "count": 4}


@dataclasses.dataclass
class Run:
    """What a path driver gets: the cell and the run's settings."""

    cell: dict
    seed: int
    device: torch.device
    rank: int = 0
    world: int = 1
    trace: bool = False
    control: bool = False
    fault: Optional[str] = None
    # Set by ``execute`` on rank 0: every number the check computed, and
    # the leaves or answers that read worst.
    numbers: Optional[Dict[str, float]] = None
    detail: Optional[dict] = None

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def spec(self) -> dict:
        return self.cell["spec"]


def shrink(cell: dict) -> dict:
    """The cell at the CPU rehearsal's width."""
    cfg = dict(cell["config"])
    for k, v in TINY_CONFIG.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) and k in cfg else v
    tr = {k: (TINY_TRAFFIC[k] if k in TINY_TRAFFIC else v) for k, v in cell["traffic"].items()}
    if "batch" in tr:
        tr["batch"] = min(cell["traffic"]["batch"], TINY_TRAFFIC["batch"])
    if "trace_steps" in tr:
        tr["trace_steps"] = 1
    return {**cell, "config": cfg, "traffic": tr}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run, seconds: float) -> Dict:
    """One run of ``run.cell`` on this rank; rank 0 returns the result."""
    say(f"rank {run.rank}: {run.cell['name']} seed {run.seed}: set-up")
    path = catalog.load_module("paths", run.traffic["path"]).Path(run)
    setup_s = time.time() - T_START
    # One intra-op thread from here on: the host's share of the timed path
    # is small ops and launches, which a pool of threads only makes noisier
    # (the set-up's host work, drawing the program's initial weights, keeps
    # the pool).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    say(f"rank {run.rank}: window")
    window = path.window(seconds)
    say(f"rank {run.rank}: window closed")
    traced = None
    if run.trace:
        traced = trace.traced(path.slice) if run.device.type == "cuda" else None
    peak = path.gather_max(torch.cuda.max_memory_allocated(run.device)
                           if run.device.type == "cuda" else 0)
    busy = trace.union_s(traced["device"]) if traced else 0.0
    busy = path.gather_mean(busy)
    layer_ctx = path.layer_context(traced) if traced else None
    path.free()
    torch.set_num_threads(threads)
    if run.rank != 0:
        return {}
    say("check")
    compared = path.check()
    say("checked")
    run.numbers, run.detail = compared, path.detail
    limits = run.spec["limits"]
    correct = all(compared[k] <= limits[k] for k in limits) and window["failed"] == 0
    if run.trace:
        metrics = {}
        readers = catalog.metric_readers(run.cell["per_layer"])
        for m in run.cell["per_layer"]:
            value = readers[m["name"]].read(layer_ctx) if layer_ctx else None
            if value is None:
                print(f"[portbench] {m['name']}: nothing to read", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.cell["end_to_end"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": run.world if run.device.type == "cuda" else 0,
              "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = busy
        device["window_s"] = traced["window_s"]
        result["breakdown"] = trace.breakdown(traced["device"], traced["host"])
    result["compared"] = {k: {"value": compared[k], "limit": limits[k]} for k in limits}
    return result


@dataclasses.dataclass
class Ranks:
    """This process's place in a run: the cell as it runs here, this rank's
    device, and what this process started."""

    cell: dict
    device: torch.device
    rank: int
    world: int
    procs: List[subprocess.Popen]
    created: bool  # whether this process made the process group


def start(args, script: str, argv: List[str]) -> Optional[Ranks]:
    """The cell ``args.workload`` on this rank's card (with
    ``args.rehearse_cpu``, on the CPU at the rehearsal's width). For a cell
    on several cards, rank 0 starts ranks 1.. (``script`` with ``argv``
    again, one process a card, their output on this process's standard
    error) and every rank joins the process group. None, after saying why,
    without as many cards as the cell asks for."""
    cell = catalog.cell(args.workload)
    world = cell["chips"]
    if args.rehearse_cpu:
        cell, device = shrink(cell), torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"[portbench] {args.workload} needs {world} CUDA card(s); PyTorch sees {n}",
                  file=sys.stderr)
            return None
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    procs, created = [], False
    if world > 1:
        port = args.port or free_port()
        if args.rank == 0:
            procs = [subprocess.Popen([sys.executable, script, *argv, "--rank", str(r),
                                       "--port", str(port)], stdout=sys.stderr, cwd=ROOT)
                     for r in range(1, world)]
        os.environ.update(RANK=str(args.rank), WORLD_SIZE=str(world), LOCAL_RANK=str(args.rank),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        created = pdist.initialize(device.type)
    return Ranks(cell, device, args.rank, world, procs, created)


def stop(ranks: Ranks) -> int:
    """Leave the process group and wait for the ranks this process started;
    1 if one of them failed."""
    pdist.finalize(ranks.created)
    for p in ranks.procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    if any(p.returncode != 0 for p in ranks.procs):
        print(f"[portbench] a rank failed: exit codes {[p.returncode for p in ranks.procs]}",
              file=sys.stderr)
        return 1
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rehearse_cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    ranks = start(args, __file__, sys.argv[1:] if argv is None else list(argv))
    if ranks is None:
        return 2
    run = Run(ranks.cell, args.seed, ranks.device, args.rank, ranks.world, bool(args.trace),
              bool(args.control), args.fault)
    try:
        result = execute(run, args.seconds)
    finally:
        failed = stop(ranks)
    if args.rank != 0 or failed:
        return failed
    found = forbidden_modules()
    if found:
        print(f"[portbench] loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    for k, v in result["compared"].items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
