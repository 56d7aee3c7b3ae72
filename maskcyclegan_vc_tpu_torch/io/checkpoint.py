"""Single-file ``.npz`` checkpoints in the JAX package's key layout.

Counterpart of ``save_checkpoint`` and ``load_checkpoint_subtree`` of
``maskcyclegan_vc_tpu/io/checkpoint.py``: one leaf per npz entry, keyed by
its path joined with ``/``. A mapping contributes its keys, a list or tuple
its indices, and a dataclass field ``.<name>`` (the leading dot that JAX's
tree paths give a dataclass field: the JAX trainer writes its state as
``.g_params/A2B/params/...``). So a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(node: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        items = [(str(k), v) for k, v in node.items()]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(node)]
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        items = [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    else:
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu().numpy()
        out[prefix] = np.asarray(node)
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else k, out)


def save_checkpoint(path: str, tree: Any,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``tree`` to ``path`` (.npz), atomically: a temporary file
    renamed into place, so no reader sees a half-written checkpoint.
    ``meta`` entries go under ``meta/<name>`` keys, outside the tree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    for k, v in (meta or {}).items():
        flat[f"meta/{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint_subtree(path: str, prefix: str) -> Dict[str, Any]:
    """The leaves under ``prefix`` (e.g. ``"g_params/A2B"``) as a nested
    dict of numpy arrays; a key's leading dot is ignored. Reads only the
    matching entries, not the whole training state."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for k in z.files:
            kn = k[1:] if k.startswith(".") else k
            if not kn.startswith(prefix + "/"):
                continue
            parts = kn[len(prefix) + 1:].split("/")
            d = out
            for s in parts[:-1]:
                d = d.setdefault(s, {})
            d[parts[-1]] = z[k]
    if not out:
        raise KeyError(f"no leaves under {prefix!r} in {path}")
    return out
