"""The program's own spans against the traced slice: which of the port's
layers the device waited on.

The port records spans of its layers, always, on ``time.time_ns()``
(``maskcyclegan_vc_tpu_torch/obs/profiler.py``: ``spans()``, ``totals()``).
A ``torch.profiler`` trace's event lies at its ``ts`` plus the trace's
base, a whole number of seconds that ``trace.traced`` does not keep. So the
base is recovered: the end of the program's last anchor span (``train.replay``
on the training path, ``decode`` on the conversion path) less the end of
the last runtime call of the anchor's kind in ``ctx.host`` (the last
``cudaGraphLaunch``, which lies inside that replay; on the conversion path
the last call of any kind, the caller's read of the waveform just after
the decode), to the nearest second. The base then puts spans and runtime
calls on one clock, with no fitted offset.

A device-idle gap (between the union of ``ctx.events``) waits on the host
where a launch-type runtime call begins inside it: the queue was empty.
Any other gap is the device's own (dependencies inside a graph, launch
latency). Each waiting gap is divided among the innermost program spans
the host was in during it, by overlap; the part in no span is the
caller's.

The analysis is void (None, with the reason on stderr) where the program
records no spans (a checkout older than them), where the slice's count of
unit spans (``convert``, or ``train.inputs``, one a step) differs from
``ctx.units``, where a ``train.first_step`` span falls inside the window or
the slice, or where the clocks do not align: the base's remainder is over
``ALIGN_S``, or the clock check fails. The clock check: on the training
path every ``cudaGraphLaunch`` lies inside a ``train.replay`` span; on the
conversion path every ``cudaMemcpyAsync`` lies inside ``convert.h2d``,
``convert.d2h`` or ``decode.h2d`` but one an utterance (the caller's read
of the waveform). One line on stderr a run gives the waits by innermost
span, the caller's, the device's own gaps and the clock check.

Readers use only ``ctx.events``, ``ctx.host``, ``ctx.units`` and
``ctx.window_s``.
"""

from __future__ import annotations

import bisect
import re
import sys
from typing import Dict, List, Optional, Tuple

from portbench import trace

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch|cudaMemcpyAsync"
                    r"|cudaMemsetAsync)")
# The largest remainder the base may leave: the anchor call ends this close
# to the anchor span's end (microseconds on the training path, the decode's
# device tail on the conversion path), well inside half a second.
ALIGN_S = 0.1
PATHS = {
    "train": {"unit": "train.inputs", "anchor": "train.replay", "anchor_call": "cudaGraphLaunch",
              "checked_call": "cudaGraphLaunch", "inside": ("train.replay",), "outside": 0},
    "convert": {"unit": "convert", "anchor": "decode", "anchor_call": "",
                "checked_call": "cudaMemcpyAsync",
                "inside": ("convert.h2d", "convert.d2h", "decode.h2d"), "outside": 1},
}

Interval = Tuple[str, float, float]  # (span name, start us, end us) on the trace's clock


def _say(what: str) -> None:
    print(f"[portbench] spans: {what}", file=sys.stderr)


def base_ns(anchor_end_ns: int, call_end_us: float) -> Tuple[int, float]:
    """(the trace's base in ns, a whole number of seconds; the remainder in
    seconds) from one span's end and one runtime call's end."""
    diff_ns = anchor_end_ns - round(call_end_us * 1e3)
    base = round(diff_ns / 1e9) * 1_000_000_000
    return base, (diff_ns - base) / 1e9


def slice_spans(recorded, base: int, lo: float, hi: float) -> List[Interval]:
    """The recorded spans that overlap [lo, hi] us, on the trace's clock."""
    out = []
    for sp in recorded:
        start, end = (sp.start_ns - base) / 1e3, (sp.end_ns - base) / 1e3
        if end > lo and start < hi:
            out.append((sp.name, start, end))
    return out


def first_step_outside_setup(recorded) -> bool:
    """Whether a ``train.first_step`` span starts after the first
    ``train.run`` span whose steps all replayed: a capture after the set-up
    (the window's and the slice's steps only replay)."""
    runs = sorted((sp.start_ns, sp.end_ns) for sp in recorded if sp.name == "train.run")
    firsts = [sp.start_ns for sp in recorded if sp.name == "train.first_step"]
    replays = [sp.start_ns for sp in recorded if sp.name == "train.replay"]
    for start, end in runs:
        if any(start <= t <= end for t in replays) and not any(start <= t <= end for t in firsts):
            return any(t >= start for t in firsts)
    return False


def contained(calls: List[trace.Event], spans: List[Interval], names) -> List[bool]:
    """For each call, whether it lies inside a span of one of ``names``."""
    inside = sorted((s, e) for n, s, e in spans if n in names)
    starts = [s for s, _ in inside]
    out = []
    for _, ts, dur in calls:
        i = bisect.bisect_right(starts, ts) - 1
        out.append(i >= 0 and inside[i][1] >= ts + dur)
    return out


def attribute(gaps: List[Tuple[float, float]], spans: List[Interval]) -> Tuple[Dict, Dict, float]:
    """({innermost span name: us}, {span name: us of overlap}, the caller's
    us) over ``gaps`` ((start us, length us)). Spans of one thread nest, so
    the innermost at an instant is the covering span that started last (of
    two that started together, the one that ends first)."""
    innermost: Dict[str, float] = {}
    within: Dict[str, float] = {}
    caller = 0.0
    by_start = sorted(spans, key=lambda sp: sp[1])
    active: List[Interval] = []
    j = 0
    for g0, length in sorted(gaps):
        g1 = g0 + length
        while j < len(by_start) and by_start[j][1] < g1:
            active.append(by_start[j])
            j += 1
        active = [sp for sp in active if sp[2] > g0]
        for n, s, e in active:
            within[n] = within.get(n, 0.0) + min(e, g1) - max(s, g0)
        cuts = sorted({g0, g1, *(s for _, s, _ in active if s > g0),
                       *(e for _, _, e in active if e < g1)})
        for a, b in zip(cuts, cuts[1:]):
            covering = [(s, -e, n) for n, s, e in active if s <= a and e >= b]
            if covering:
                name = max(covering)[2]
                innermost[name] = innermost.get(name, 0.0) + b - a
            else:
                caller += b - a
    return innermost, within, caller


def analyse(ctx, path: str) -> Optional[Dict]:
    """The slice's waits by span on ``path`` ("train" or "convert"), or None
    (void) with the reason on stderr."""
    try:
        from maskcyclegan_vc_tpu_torch.obs import profiler
    except ImportError:
        profiler = None
    if not hasattr(profiler, "spans"):
        _say("the program records no spans")
        return None
    kind = PATHS[path]
    recorded = [sp for sp in profiler.spans() if sp.end_ns is not None]
    anchors = [sp for sp in recorded if sp.name == kind["anchor"]]
    calls = [h for h in ctx.host if h[0].startswith(kind["anchor_call"])]
    if not anchors or not calls or not ctx.events:
        _say(f"no {kind['anchor']} span or no {kind['anchor_call'] or 'runtime'} call to align")
        return None
    base, remainder = base_ns(max(sp.end_ns for sp in anchors), max(t + d for _, t, d in calls))
    if abs(remainder) > ALIGN_S:
        _say(f"the clocks do not align: {remainder:+.6f} s left after a base of {base // 10**9} s")
        return None
    lo = min(min(t for _, t, _ in ctx.host), min(t for _, t, _ in ctx.events))
    hi = max(max(t + d for _, t, d in ctx.host), max(t + d for _, t, d in ctx.events))
    spans = slice_spans(recorded, base, lo, hi)
    units = sum(n == kind["unit"] for n, _, _ in spans)
    if units != ctx.units:
        _say(f"{units} {kind['unit']} spans in the slice, not {ctx.units}")
        return None
    if path == "train" and (any(n == "train.first_step" for n, _, _ in spans)
                            or first_step_outside_setup(recorded)):
        _say("a train.first_step span (an eager step and a capture) after the set-up")
        return None
    checked = [h for h in ctx.host if h[0].startswith(kind["checked_call"])]
    outside = contained(checked, spans, kind["inside"]).count(False)
    clock = (f"{kind['checked_call']} {len(checked)}, outside {', '.join(kind['inside'])} "
             f"{outside} (want {kind['outside'] * ctx.units})")
    if outside != kind["outside"] * ctx.units:
        _say(f"clock check failed: {clock}")
        return None

    launches = sorted(t for n, t, _ in ctx.host if LAUNCH.match(n))
    waiting, device_side = [], 0.0
    for g0, length in trace.gaps(ctx.events):
        i = bisect.bisect_right(launches, g0)
        if i < len(launches) and launches[i] < g0 + length:
            waiting.append((g0, length))
        else:
            device_side += length
    innermost, within, caller = attribute(waiting, spans)
    idle_us = 1e6 * ctx.window_s - 1e6 * trace.union_s(ctx.events)
    summed = sum(innermost.values()) + caller + device_side
    out = {"innermost": innermost, "within": within, "caller": caller,
           "device_side": device_side, "idle": idle_us, "base_s": base // 10**9,
           "remainder_s": remainder, "clock": clock}
    longest = []
    for gap in sorted(waiting, key=lambda g: -g[1])[:3]:
        inner, _, own = attribute([gap], spans)
        parts = sorted([*inner.items(), ("caller", own)], key=lambda kv: -kv[1])
        longest.append(f"{gap[1] / 1e3:.3f} ms (" + ", ".join(
            f"{n} {v / 1e3:.3f}" for n, v in parts if v > 0) + ")")
    per = 1e3 * ctx.units
    ranked = sorted(innermost.items(), key=lambda kv: -kv[1])
    _say("waits ms a unit by innermost span: "
         + ", ".join(f"{n} {v / per:.4f}" for n, v in ranked)
         + f"; caller {caller / per:.4f}; device-side gaps {device_side / per:.4f}; "
         f"sum {summed / 1e3:.3f} ms against the slice's idle {idle_us / 1e3:.3f} ms of "
         f"{1e3 * ctx.window_s:.3f} ({100 * (summed - idle_us) / (1e6 * ctx.window_s):+.3f} % of "
         f"the slice); {len(waiting)} waiting gaps, the longest {'; '.join(longest)}; "
         f"base {base // 10**9} s, remainder {remainder:+.6f} s; clock check: {clock}")
    return out


_LAST: list = [None, None, None]  # (ctx, path, analysis): one analysis a run


def waits(ctx, path: str) -> Optional[Dict]:
    """``analyse(ctx, path)``, once for all the readers of one run."""
    if _LAST[0] is not ctx or _LAST[1] != path:
        _LAST[:] = [ctx, path, analyse(ctx, path)]
    return _LAST[2]


def within_ms_per_unit(ctx, path: str, name: str) -> Optional[float]:
    """ms a unit that the device waited on the host inside ``name`` spans."""
    got = waits(ctx, path)
    return None if got is None else got["within"].get(name, 0.0) / 1e3 / ctx.units


def setup_s(ctx, name: str) -> Optional[float]:
    """The process's seconds in ``name`` spans (the per-name totals, never
    evicted), where the training path's slice is sound."""
    if waits(ctx, "train") is None:
        return None
    from maskcyclegan_vc_tpu_torch.obs import profiler

    n, seconds = profiler.totals().get(name, (0, 0.0))
    return seconds if n else None
