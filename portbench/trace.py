"""A traced slice of the run: device events from ``torch.profiler``, reduced.

The guard is copied at commit 05371c2 from
``maskcyclegan_vc_tpu_torch/obs/profiler.py`` (``trace``): the profiler
leaves kernels out at a trace's start (it maps device time onto the host's
clock up to 7.1 ms early, and in a long process the first two or three
kernels of a trace went missing), so the trace opens with
``PRIME_LAUNCHES`` throwaway kernels and the device idles ``GUARD_S``
seconds on either side of the slice.

The profiler records device activity and the CUDA runtime's calls only,
not every operator on the host, so that it slows a host-bound path as
little as it can. The slice is marked on the device by a ``MARK`` kernel
(``torch.cuda._sleep``'s) before and after it; the events kept are those
between the two marks.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

PRIME_LAUNCHES = 8
GUARD_S = 0.05
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_EVENTS = ("cuda_runtime", "cuda_driver")
MARK = "spin_kernel"
MARK_CYCLES = 1000

Event = Tuple[str, float, float]  # (name, start us, duration us)


def traced(fn: Callable[[], None]) -> Dict:
    """Run ``fn`` (which ends with the device synchronised) under the
    profiler; returns {"device": [events], "host": [runtime calls],
    "window_s": the slice's host seconds}."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    warm = torch.zeros(1, device="cuda")
    for _ in range(PRIME_LAUNCHES):
        warm.add_(1)
    torch.cuda.synchronize()
    time.sleep(GUARD_S)
    torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()
    time.sleep(GUARD_S)
    prof.stop()
    out = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = sorted(float(e["ts"]) for e in timed
                   if e.get("cat") == "kernel" and MARK in e["name"])
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} slice marks, not 2")
    lo, hi = marks

    def pick(cats) -> List[Event]:
        return [(e["name"], float(e["ts"]), float(e["dur"])) for e in timed
                if e.get("cat") in cats and lo < float(e["ts"]) < hi]

    device = [e for e in pick(DEVICE_EVENTS) if MARK not in e[0]]
    return {"device": device, "host": pick(HOST_EVENTS), "window_s": window_s}


def union_s(events: List[Event]) -> float:
    """Seconds covered by at least one event: overlapping intervals count once."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        start, stop = max(ts, end), ts + dur
        if stop > start:
            total += stop - start
        end = max(end, stop)
    return total / 1e6


def gaps(events: List[Event]) -> List[Tuple[float, float]]:
    """(start us, length us) of each stretch between device intervals."""
    out, end = [], None
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if end is not None and ts > end:
            out.append((end, ts - end))
        end = ts + dur if end is None else max(end, ts + dur)
    return out


def breakdown(device: List[Event], host: List[Event], n: int = 10) -> Dict:
    """The ``n`` device operations that took most time (summed by name) and
    the ``n`` longest idle gaps, each named by the CUDA runtime call that
    spans its middle, else as the host's own work."""
    by_name: Dict[str, float] = {}
    for name, _, dur in device:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    idle = []
    for start, length in sorted(gaps(device), key=lambda g: -g[1])[:n]:
        mid = start + length / 2
        spans = [h for h in host if h[1] <= mid <= h[1] + h[2]]
        label = min(spans, key=lambda h: h[2])[0] if spans else "host, outside CUDA calls"
        idle.append([label[:120], length / 1e6])
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": idle}
