"""What the per-layer readers share: sums over the traced slice's device
events by group, the idle share, the share of the peak, and rooflines.

A reader gets a context with ``events`` (the slice's device events, (name,
start us, duration us)), ``window_s`` (the slice's host seconds),
``units`` (steps or utterances in the slice), ``flops`` (the reference's
operations for that work), ``peak_flops``, ``bound_s`` (each of the port's
kernels' least seconds for that work), ``launches`` (the launches each
should make, where the yardstick knows them) and, on the conversion path,
``spans`` (the benchmark's own host seconds around each layer's call). A
reader that finds nothing to read returns None.
"""

from __future__ import annotations

import re
import statistics
import sys
from typing import Iterable, Optional

from portbench import names, trace


def group_ms_per_unit(ctx, group: str) -> Optional[float]:
    """Device ms a unit of the events of ``group`` (``names.group``)."""
    durs = [d for n, _, d in ctx.events if names.group(n) == group]
    return sum(durs) / 1e3 / ctx.units if durs else None


def idle_pct(ctx) -> Optional[float]:
    """The share of the slice in which no device operation ran."""
    if not ctx.events:
        return None
    return 100.0 * (1.0 - trace.union_s(ctx.events) / ctx.window_s)


def mfu_pct(ctx) -> Optional[float]:
    """The reference's operations for the slice's work over its wall time,
    as a share of the dtype's dense peak."""
    if not ctx.events or not ctx.flops:
        return None
    return 100.0 * ctx.flops / ctx.window_s / ctx.peak_flops


def roofline_pct(ctx, kernels: Iterable[str]) -> Optional[float]:
    """The least time of the port's ``kernels`` that the slice ran, over
    their device time. A kernel is left out only where the yardstick
    expects no launch of it (``ctx.launches`` 0). One with no event where
    launches are expected or not known, or whose launches differ from the
    yardstick's count, makes the reading void: its name no longer matches,
    the trace lost some, or the program launches it elsewhere."""
    bound = took = 0.0
    for k in kernels:
        durs = [d for n, _, d in ctx.events if re.search(names.KERNEL_NAMES[k], n)]
        want = ctx.launches.get(k)
        if want == 0 and not durs:
            continue
        if not durs or (want is not None and len(durs) != want):
            print(f"[portbench] {k}: {len(durs)} launches traced, "
                  f"{'an unknown number' if want is None else want} expected", file=sys.stderr)
            return None
        bound += ctx.bound_s[k]
        took += sum(durs) / 1e6
    return 100.0 * bound / took if took else None


def span_p50_ms(ctx, name: str) -> Optional[float]:
    values = ctx.spans.get(name) if hasattr(ctx, "spans") else None
    return 1e3 * statistics.median(values) if values else None
