"""Profiling hooks: spans of the program, a trace of a code region, and a
step timer.

Counterpart of ``maskcyclegan_vc_tpu/obs/profiler.py``, with one addition:

* ``span(name, request=None)``: a context manager recording one span of
  the program (name, start and end on ``time.time_ns()``, the span it ran
  inside, its cause, and a request id, inherited from that span where none
  is given). Spans are always recorded, into ``RECORDER``: a ring of the
  last ``RING_RECORDS`` spans (``spans()``), per-name totals that are never
  evicted (``totals()``, ``last(name)``), and counters (``count``,
  ``counters()``). A span launches nothing, synchronises nothing and
  touches no tensor, so it is free of device time and safe inside a CUDA
  graph's capture. Nothing is written while the program runs. On this
  clock a profiler trace's event lies at its ``ts`` (us) plus the trace's
  ``baseTimeNanoseconds``;
* ``trace(log_dir)``: a context manager capturing a ``torch.profiler``
  trace around any code region, CPU activity plus CUDA activity where a
  card is present, written on exit as a Chrome trace JSON under
  ``log_dir`` (``<worker>.<time>.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto read, with the program's spans that overlap
  the region beside the kernels;
* ``timed_steps``: a step timer whose barrier is one scalar read at the
  end (the state chain forces every step before it).

    from maskcyclegan_vc_tpu_torch.obs import profiler
    with profiler.trace("runs/trace"):
        with profiler.span("train.step", request=step):
            state, metrics = step(state, batch)
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import (Any, Callable, Deque, Dict, Iterable, Iterator, List, NamedTuple, Optional,
                    Tuple)

import torch

RING_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    """A closed span. ``cause`` is the id of the span it ran inside (None at
    the top); ``start_ns`` and ``end_ns`` are ``time.time_ns()`` readings."""

    name: str
    request: Optional[int]
    id: int
    cause: Optional[int]
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Span:
    """An open span: the context manager that ``span`` returns. Its fields
    are those of ``SpanRecord``; ``end_ns`` is None until it closes."""

    __slots__ = ("recorder", "name", "request", "id", "cause", "start_ns", "end_ns", "_thread")

    def __init__(self, recorder: "Recorder", name: str, request: Optional[int]):
        self.recorder = recorder
        self.name = name
        self.request = request
        self.id = self.cause = self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        rec = self.recorder
        mine = self._thread = getattr(rec._local, "spans", None) or rec._thread()
        stack = mine.stack
        if stack:
            outer = stack[-1]
            self.cause = outer.id
            if self.request is None:
                self.request = outer.request
        self.id = next(rec._ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = time.time_ns()
        mine = self._thread
        self._thread = None
        mine.stack.remove(self)
        name, start = self.name, self.start_ns
        rec = (name, self.request, self.id, self.cause, start, end)
        self.recorder._ring.append(rec)
        total = mine.totals.get(name)
        if total is None:
            mine.totals[name] = [1, end - start, rec]
        else:
            total[0] += 1
            total[1] += end - start
            total[2] = rec

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _ThreadSpans:
    """One thread's open spans and its totals: {name: [count, ns, last record]}."""

    __slots__ = ("stack", "totals")

    def __init__(self):
        self.stack: List[Span] = []
        self.totals: Dict[str, list] = {}


class Recorder:
    """Closed spans in a ring of the last ``size``, each name's count and
    seconds (never evicted), each name's last span, and counters. Each
    thread nests and totals its own spans, so that closing a span takes no
    lock; the ring's append is atomic. The ring holds plain tuples of
    numbers and strings, which the garbage collector does not scan."""

    def __init__(self, size: int = RING_RECORDS):
        self._ring: Deque[tuple] = collections.deque(maxlen=size)
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._threads: List[_ThreadSpans] = []
        self._counters: Dict[str, int] = {}

    def _thread(self) -> _ThreadSpans:
        mine = getattr(self._local, "spans", None)
        if mine is None:
            mine = self._local.spans = _ThreadSpans()
            with self._lock:
                self._threads.append(mine)
        return mine

    def span(self, name: str, request: Optional[int] = None) -> Span:
        return Span(self, name, request)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> List[SpanRecord]:
        """The ring's spans, oldest closed first."""
        return [SpanRecord._make(rec) for rec in list(self._ring)]

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """{name: (spans closed, seconds)} over the whole process."""
        out: Dict[str, list] = {}
        with self._lock:
            threads = list(self._threads)
        for mine in threads:
            for name, (n, ns, _) in list(mine.totals.items()):
                acc = out.setdefault(name, [0, 0])
                acc[0] += n
                acc[1] += ns
        return {k: (n, ns / 1e9) for k, (n, ns) in out.items()}

    def last(self, name: str) -> Optional[SpanRecord]:
        """The span of ``name`` that closed last, on any thread."""
        with self._lock:
            threads = list(self._threads)
        found = [mine.totals[name][2] for mine in threads if name in mine.totals]
        return SpanRecord._make(max(found, key=lambda rec: rec[5])) if found else None

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


RECORDER = Recorder()
# The process's recorder, which the program's spans go to.
span, count, spans = RECORDER.span, RECORDER.count, RECORDER.spans
totals, last, counters = RECORDER.totals, RECORDER.last, RECORDER.counters


# The port's kernels by their names in a trace's kernel events, keyed as
# the wrappers' launch counts. K1, K2 and K3 are one template,
# in_staged_kernel<T, Epilogue, ...>, told apart by its epilogue (kGlu 2,
# kNone 0, kSwish 1); their backwards another, in_backward_kernel.
KERNEL_NAMES = {
    "in_glu": r"in_staged_kernel<\w+,[^,]*(?:2|kGlu)\s*,",
    "in": r"in_staged_kernel<\w+,[^,]*(?:0|kNone)\s*,",
    "in_swish": r"in_staged_kernel<\w+,[^,]*(?:1|kSwish)\s*,",
    "in_glu_bwd": r"in_backward_kernel<\w+,[^,]*(?:2|kGlu)\s*,",
    "in_bwd": r"in_backward_kernel<\w+,[^,]*(?:0|kNone)\s*,",
    "in_swish_bwd": r"in_backward_kernel<\w+,[^,]*(?:1|kSwish)\s*,",
    "ps_in_swish": r"ps_in_swish_kernel",
    "ps_in_swish_bwd": r"ps_in_swish_backward_kernel",
    "shuffle": r"(?<!inverse_)pixel_shuffle_kernel",
    "inv_shuffle": r"inverse_pixel_shuffle_kernel",
    "log_mel": r"log_mel_kernel",
    "melgan_stack": r"resblock_(?:tc|bf16)_kernel|tail_kernel",
}
# The profiler leaves kernels out at a trace's start (scripts/
# trace_drop_probe.py, traces of 3 steps, 0.3-0.7 s, on an H100): it maps
# each kernel's device time onto the host's clock, off by up to 7.1 ms (a
# kernel placed before its own launch), and a kernel mapped before the
# trace's window opened is missing; and in one process, from about 90 s on,
# the first two or three kernels of nearly every trace were missing however
# long the device had idled first. So the trace opens with PRIME_LAUNCHES
# throwaway kernels, which take such losses, and the device idles GUARD_S
# seconds before the region and again after it.
PRIME_LAUNCHES = 8
GUARD_S = 0.05


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the block into ``log_dir``, with the
    program's spans that overlap the block as complete events (category
    ``program_span``); where the profiler cannot start, say so and run the
    block untraced. With a card, the trace opens with ``PRIME_LAUNCHES``
    throwaway kernels (an add on one element) and the device idles for
    ``GUARD_S`` on either side of the block, so that the trace holds every
    kernel of the block."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    region = [0, 0]
    prof = profile(activities=activities,
                   on_trace_ready=lambda p: _write_trace(p, log_dir, *region))
    try:
        prof.start()
    except RuntimeError as e:
        print(f"[profiler] trace unavailable: {e}")
        prof = None
    if prof is not None and cuda:
        warm = torch.zeros(1, device="cuda")
        for _ in range(PRIME_LAUNCHES):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(GUARD_S)
    region[0] = time.time_ns()
    try:
        yield
    finally:
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            region[1] = time.time_ns()
            if cuda:
                time.sleep(GUARD_S)
            prof.stop()


def _write_trace(prof, log_dir: str, start_ns: int, end_ns: int) -> None:
    """The trace as ``tensorboard_trace_handler`` names it, with the spans
    of ``RECORDER`` that overlap [start_ns, end_ns] added on this thread's
    row."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        print("[profiler] the trace gives no baseTimeNanoseconds: spans left out")
        return
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": sp.name, "pid": pid, "tid": tid,
         "ts": (sp.start_ns - int(base)) / 1e3, "dur": (sp.end_ns - sp.start_ns) / 1e3,
         "args": {"request": sp.request, "id": sp.id, "cause": sp.cause}}
        for sp in spans() if sp.end_ns >= start_ns and sp.start_ns <= end_ns)
    with open(path, "w") as f:
        json.dump(doc, f)


def leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a nest of dicts, lists and tuples in ``jax.tree.leaves``
    order: a dict's values by sorted key, a sequence's in order; None holds
    none."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def timed_steps(step_fn: Callable, state, batches: Iterable, *,
                sync_leaf: Callable = None) -> Tuple[object, float]:
    """Run chained steps ``state, metrics = step_fn(state, batch)``; return
    (final_state, seconds_per_step) over ``max(1, len(batches))``.

    Completion is forced by one ``float()`` of a single scalar:
    ``sync_leaf(metrics)``, or by default the first leaf of the last
    metrics (the value of the smallest key of a dict).
    """
    batches = list(batches)
    t0 = time.perf_counter()
    metrics = None
    for b in batches:
        state, metrics = step_fn(state, b)
    if sync_leaf is not None:
        leaf = sync_leaf(metrics)
    else:
        leaf = next(leaves(metrics), None)
        if leaf is None:
            raise ValueError("no metrics to synchronise on: pass sync_leaf")
    float(leaf)
    return state, (time.perf_counter() - t0) / max(1, len(batches))
