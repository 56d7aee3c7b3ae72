"""Single-file ``.npz`` checkpoints in the JAX package's key layout.

Counterpart of ``maskcyclegan_vc_tpu/io/checkpoint.py``: one leaf per npz
entry, keyed by its path joined with ``/``. A mapping contributes its keys,
a list or tuple its indices, and a dataclass field ``.<name>`` (the leading
dot that JAX's tree paths give a dataclass field: the JAX trainer writes
its state as ``.g_params/A2B/params/...``). So a checkpoint written by
either package loads in the other: ``save_train_state`` writes the whole
training state as the JAX trainer does (``io.jax_params.train_state_to_jax``)
and ``load_train_state`` reads one that either wrote. ``meta/<name>``
entries (seed, epoch, the speakers' normalisation statistics) sit beside
the state. ``AsyncSaver`` writes files on a thread while training goes on;
``checkpoint_path``, ``latest_epoch`` and ``rotate_checkpoints`` manage an
epoch-tagged directory.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.io.jax_params import train_state_from_jax, train_state_to_jax


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


def load_checkpoint_meta(path: str) -> Dict[str, np.ndarray]:
    """The ``meta/`` entries stored beside the state."""
    with np.load(path) as z:
        return {k[len("meta/"):]: z[k] for k in z.files if k.startswith("meta/")}


def save_train_state(path: str, state, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a ``train.state.TrainState`` as the JAX trainer would."""
    save_checkpoint(path, train_state_to_jax(state), meta)


def load_train_state(path: str, state):
    """Load a checkpoint of either package's trainer into ``state`` in place."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("meta/")}
    return train_state_from_jax(flat, state)


class AsyncSaver:
    """Checkpoint file writes on a worker thread, overlapped with training.

    ``save`` takes host arrays (``train_state_to_jax`` copies the state off
    the device first, in the caller) and runs only the serialisation and
    the atomic rename on the thread. One write is in flight at a time: a new
    ``save`` first joins the previous one. ``wait`` flushes: call it before
    reading the directory and before exiting. A failed write re-raises on
    the next ``save`` or ``wait``.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, path: str, host_tree: Any, meta: Optional[Dict[str, Any]] = None,
             on_done: Optional[Callable[[], None]] = None) -> None:
        self.wait()

        def work():
            try:
                save_checkpoint(path, host_tree, meta)
                if on_done is not None:
                    on_done()
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._exc = e

        self._thread = threading.Thread(target=work, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight, if any, has landed; re-raise its
        error."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise e


_CKPT_RE = re.compile(r"^(\d{5})_state\.npz$")


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"{epoch:05d}_state.npz")


def _epochs(ckpt_dir: str):
    for p in glob.glob(os.path.join(ckpt_dir, "*_state.npz")):
        m = _CKPT_RE.match(os.path.basename(p))
        if m:
            yield int(m.group(1)), p


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The largest epoch with a checkpoint in ``ckpt_dir``, or None."""
    return max((e for e, _ in _epochs(ckpt_dir)), default=None)


def rotate_checkpoints(ckpt_dir: str, max_ckpts: int) -> None:
    """Keep only the newest ``max_ckpts`` checkpoints (0 keeps all)."""
    if max_ckpts <= 0:
        return
    for _, p in sorted(_epochs(ckpt_dir))[:-max_ckpts]:
        os.remove(p)
