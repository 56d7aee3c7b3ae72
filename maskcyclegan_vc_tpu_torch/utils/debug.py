"""NaN/Inf sanitizer and the NaN localizer.

Counterpart of ``maskcyclegan_vc_tpu/utils/debug.py``:

* ``check_finite(tree)``: the trainer checks every step's logged losses at
  epoch end and, with ``--finite_check params``, the whole state before
  each checkpoint write;
* ``nan_debug_mode()``: the first operation whose output holds a NaN
  raises ``FloatingPointError`` naming that operation, the remedy the
  trainer's non-finite error points at (JAX: ``jax.debug_nans`` with
  ``jax.disable_jit``).

Inside ``nan_debug_mode`` a ``TorchDispatchMode`` checks each floating
output of every aten operation, forward and backward, and every tensor an
in-place operation writes (Adam's ``_foreach`` updates among them), with
``torch.isnan(t).any()``: NaN only, as ``jax.debug_nans`` (an infinity
passes). It skips the operations whose output is uninitialised memory
(``empty`` and its kin: a kernel wrapper's output before its launch, which
the caching allocator may hand back holding old NaN bytes) and views, which
make no new values. The mode passes each operation through unchanged, so
the numerics are those outside it; each check reads the device once.

The port's CUDA kernels launch through ctypes (``ops/cuda_lib.py``), where
the dispatcher cannot see them, so each wrapper hands the tensors a launch
wrote to ``check_kernel_outputs``, which raises naming the kernel's C entry
(``in_forward_bf16``, say) and costs one look at the thread's dispatch-mode
stack outside the mode. Autograd carries that stack to the device thread on
which it runs a CUDA backward, and so K5.

CUDA graphs hide the operations from the mode, as ``jit`` hides them from
``jax.debug_nans``: inside the mode the trainer's step runner
(``train/graphs.py``) runs every step eagerly whatever ``--scan_epochs``
says, and a capture raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterable, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

# Operations whose output is uninitialised memory (those this torch has).
UNINITIALISED = frozenset(
    getattr(torch.ops.aten, name) for name in
    ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
     "empty_permuted", "resize_") if hasattr(torch.ops.aten, name))

def _walk(node: Any, path: str, bad: List[str]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{path}/{k}" if path else str(k), bad)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}/{i}" if path else str(i), bad)
    elif isinstance(node, torch.Tensor):
        if not bool(torch.isfinite(node).all()):
            bad.append(path)
    elif isinstance(node, (float, int)):
        if not math.isfinite(node):
            bad.append(path)
    elif not np.isfinite(np.asarray(node)).all():
        bad.append(path)


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first non-finite leaves of a
    nest of dicts, lists and tuples of tensors, arrays or host scalars. A
    device tensor costs one read from the device."""
    bad: List[str] = []
    _walk(tree, "", bad)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def _has_nan(t: Any) -> bool:
    return (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
            and t.device.type != "meta" and bool(torch.isnan(t).any()))


def _written(func, args, kwargs) -> Iterable[torch.Tensor]:
    """The tensors an in-place or ``out=`` operation writes to."""
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        if a.kwarg_only or i >= len(args):
            yield from tree_leaves(kwargs.get(a.name))
        else:
            yield from tree_leaves(args[i])


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in UNINITIALISED or func.is_view:
            return out
        for t in (*tree_leaves(out), *_written(func, args, kwargs)):
            if _has_nan(t):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug_mode():
    """Inside: the first operation, or kernel launch, whose output holds a
    NaN raises ``FloatingPointError`` naming it. Outside, NaNs propagate."""
    with _NanCheck():
        yield


def nan_debug_active() -> bool:
    """Whether this thread runs inside ``nan_debug_mode``."""
    return any(isinstance(m, _NanCheck) for m in _get_current_dispatch_mode_stack())


def check_kernel_outputs(symbol: str, *outputs) -> None:
    """Inside ``nan_debug_mode``: raise ``FloatingPointError`` naming the C
    entry ``symbol`` if a tensor that one launch of it wrote holds a NaN.
    Each output is a tensor, or a (part, tensor) pair
    naming the part of the launch that wrote it, checked in order. Outside
    the mode: nothing."""
    if not nan_debug_active():
        return
    for out in outputs:
        part, t = out if isinstance(out, tuple) else ("", out)
        if _has_nan(t):
            raise FloatingPointError(f"NaN in the output of the CUDA kernel {symbol}"
                                     + (f" ({part})" if part else ""))
