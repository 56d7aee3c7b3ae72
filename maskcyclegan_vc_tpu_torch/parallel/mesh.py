"""Data-parallel training with explicit collectives.

Counterpart of ``maskcyclegan_vc_tpu/parallel/mesh.py``. Every process
holds the whole state (``replicate``) and trains on its contiguous rows of
the global batch (``shard_batch``); after each side's backward its raw
gradients are averaged over the processes (``explicit_sync_fns``'s
``grad_sync``) before that side's Adam update, so every process applies the
same update and the states never diverge; the logged losses are averaged
(``metric_sync``). Each side's gradients travel as one flat bucket:

    bucket = cat(flatten(g) for g in grads)       # the parameters' dtype
    wire   = bucket.to(allreduce_dtype)           # only if not float32
    all_reduce(wire, SUM)                          # one collective a side
    grads  = unflatten(wire.to(bucket.dtype) / world_size)

which is JAX's ``_explicit_sync_fns`` (psum over ``data``, optionally on a
compressed wire, then the division in the parameter dtype). One route
serves both wire dtypes: the JAX package lets GSPMD place the f32
all-reduces and writes the compressed one by hand (``shard_map``), two
routes its tests pin equal.

On NCCL an f32 sum is NCCL's premultiplied sum with the factor 1.0: the
same arithmetic (x * 1.0 is x, and the reduction is the sum's), but NCCL
runs its reduction kernel at every world size, where its in-place SUM over
one rank enqueues no device work at all; so a one-card run's collectives
are device work that a CUDA graph holds and a profile shows, as they are on
many. A bf16 wire takes the plain SUM: through a bf16 premultiplied sum
the gradients did not arrive (measured on an H100: a bf16-wire run whose
losses stopped moving from the first update on).

``DistributedDataParallel`` is not used: the update takes each side's
gradients with ``torch.autograd.grad`` over that side's parameters only
(``train/step.py``), and DDP's reducer hooks ``AccumulateGrad``, which
``autograd.grad`` never runs. The collectives run on the current stream, so
a CUDA graph of the step captures them (``train/graphs.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from maskcyclegan_vc_tpu_torch.parallel.dist import local_batch_slice, world_size

WIRE_DTYPES = {None: None, "float32": None, "f32": None, "bfloat16": torch.bfloat16}


def explicit_sync_fns(allreduce_dtype: Optional[str] = None):
    """``(grad_sync, metric_sync)`` over the default process group.

    ``grad_sync(grads) -> grads``: a sequence of gradient tensors averaged
    over the processes, through one bucket on a wire of ``allreduce_dtype``
    (None or "float32": the gradients' own dtype; "bfloat16": half the
    bytes, the summed gradient rounded to bf16). ``metric_sync(metrics) ->
    metrics``: a dict of 0-dim tensors, each averaged over the processes.
    """
    if allreduce_dtype not in WIRE_DTYPES:
        raise ValueError(f"allreduce_dtype {allreduce_dtype!r} not one of float32, bfloat16")
    wire = WIRE_DTYPES[allreduce_dtype]
    n = world_size()
    nccl = dist.get_backend() == "nccl"

    def op(dtype):
        if nccl and dtype == torch.float32:
            return dist._make_nccl_premul_sum(1.0)
        return dist.ReduceOp.SUM

    def grad_sync(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        bucket = torch.cat([g.reshape(-1) for g in grads])
        on_wire = bucket if wire is None or wire == bucket.dtype else bucket.to(wire)
        dist.all_reduce(on_wire, op=op(on_wire.dtype))
        bucket = on_wire.to(bucket.dtype) / n
        return [b.view_as(g) for b, g in zip(bucket.split([g.numel() for g in grads]), grads)]

    def metric_sync(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(stacked, op=op(stacked.dtype))
        return dict(zip(keys, (stacked / n).unbind()))

    return grad_sync, metric_sync


def wire_bytes(params: Sequence[torch.Tensor], allreduce_dtype: Optional[str] = None) -> int:
    """The bytes one ``grad_sync`` of these parameters' gradients puts on
    the wire (one rank's bucket)."""
    wire = WIRE_DTYPES[allreduce_dtype]
    return sum(p.numel() * (wire or p.dtype).itemsize for p in params)


def shard_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This process's contiguous rows of a global batch that every process
    drew alike (the same seed and step): process ``i`` takes the ``i``-th
    block, as the JAX package's ``shard_batch`` hands it out."""
    rows = local_batch_slice(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


def _state_tensors(state) -> List[torch.Tensor]:
    """Every parameter of the six models, then every Adam moment that
    exists, in a fixed order."""
    out = [p.data for models in (state.g, state.d) for m in models.values()
           for p in m.parameters()]
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                out += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    return out


def replicate(state, src: int = 0) -> Tuple[int, int]:
    """Make every process's state rank ``src``'s, in place: its parameters
    and Adam moments broadcast in one bucket per dtype. Every process seeds
    (or loads) the same state already; this makes it so whatever the
    process did before. Returns (tensors, bytes) broadcast."""
    if world_size() == 1:
        return 0, 0
    tensors = _state_tensors(state)
    n_bytes = 0
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        bucket = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(bucket, src)
        for t, b in zip(group, bucket.split([t.numel() for t in group])):
            t.copy_(b.view_as(t))
        n_bytes += bucket.numel() * bucket.element_size()
    return len(tensors), n_bytes
