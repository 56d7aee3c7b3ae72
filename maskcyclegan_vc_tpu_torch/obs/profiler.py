"""Profiling hooks: a trace of a code region, and a step timer.

Counterpart of ``maskcyclegan_vc_tpu/obs/profiler.py``:

* ``trace(log_dir)``: a context manager capturing a ``torch.profiler``
  trace around any code region, CPU activity plus CUDA activity where a
  card is present, written on exit as a Chrome trace JSON under
  ``log_dir`` (``<worker>.<time>.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto read;
* ``timed_steps``: a step timer whose barrier is one scalar read at the
  end (the state chain forces every step before it).

    from maskcyclegan_vc_tpu_torch.obs import profiler
    with profiler.trace("runs/trace"):
        state, metrics = step(state, batch)
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterable, Iterator, Tuple

import torch

# The port's kernels by their names in a trace's kernel events, keyed as
# the wrappers' launch counts. K1, K2 and K3 are one template,
# in_staged_kernel<T, Epilogue, ...>, told apart by its epilogue (kGlu 2,
# kNone 0, kSwish 1).
KERNEL_NAMES = {
    "in_glu": r"in_staged_kernel<\w+,[^,]*(?:2|kGlu)\s*,",
    "in": r"in_staged_kernel<\w+,[^,]*(?:0|kNone)\s*,",
    "in_swish": r"in_staged_kernel<\w+,[^,]*(?:1|kSwish)\s*,",
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
    """Capture a profiler trace of the block into ``log_dir``; where the
    profiler cannot start, say so and run the block untraced. With a card,
    the trace opens with ``PRIME_LAUNCHES`` throwaway kernels (an add on
    one element) and the device idles for ``GUARD_S`` on either side of the
    block, so that the trace holds every kernel of the block."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
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
    try:
        yield
    finally:
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(GUARD_S)
            prof.stop()


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
