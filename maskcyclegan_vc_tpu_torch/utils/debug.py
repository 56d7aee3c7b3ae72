"""NaN/Inf sanitizer.

Counterpart of ``check_finite`` of ``maskcyclegan_vc_tpu/utils/debug.py``:
the trainer checks every step's logged losses at epoch end and, with
``--finite_check params``, the whole state before each checkpoint write.
"""

from __future__ import annotations

import math
from typing import Any, List

import numpy as np
import torch


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
