"""Process groups for data-parallel runs, from torchrun's environment.

Counterpart of ``maskcyclegan_vc_tpu/parallel/dist.py``. One process per
card (``torchrun --nproc_per_node N``): ``initialize`` reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, selects
card ``LOCAL_RANK`` (so ``cuda`` means that card for the rest of the run)
and joins the default process group, over NCCL on the card and gloo with
``device="cpu"``. ``rank``, ``world_size`` and ``local_batch_slice`` then
say which rows of a global batch this process owns; without a process group
they describe a single process.

Failure policy, the JAX package's: a misconfigured launch must raise, never
fall back to N independent single-process trainers each computing 1/N of the
batch. No torchrun variable at all is the one case taken as a single-process
run; a partial environment (``WORLD_SIZE`` without ``MASTER_ADDR``, say)
raises. ``MASKVC_REQUIRE_MULTIHOST=1`` also raises when the world resolves
to one process.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize(device: str = "cuda", backend: Optional[str] = None) -> bool:
    """Join the default process group from torchrun's environment; loud on
    success and on misconfiguration. Returns whether this call made the
    group (the caller then destroys it: ``finalize``); a call with a group
    in place does nothing. ``backend`` overrides the device's (gloo can
    carry CUDA tensors, so several processes can share one card)."""
    if dist.is_initialized():
        return False
    require = os.environ.get("MASKVC_REQUIRE_MULTIHOST", "0") not in ("0", "", "false")
    present = {k: os.environ[k] for k in ENV if os.environ.get(k, "") != ""}
    if not present:
        if require:
            raise RuntimeError("multi-host run required (MASKVC_REQUIRE_MULTIHOST) but "
                               "no cluster environment was detected")
        print("[dist] no cluster environment detected — single-process run", flush=True)
        return False
    missing = [k for k in ENV if k not in present]
    if missing:
        raise RuntimeError(f"partial torchrun environment: {sorted(present)} set but "
                           f"{missing} missing; launch with torchrun or set all of {ENV}")
    rank, size, local = (int(present[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if not 0 <= rank < size:
        raise RuntimeError(f"RANK {rank} outside WORLD_SIZE {size}")
    kw = {}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on the card, but CUDA is not available; "
                               "pass --device cpu for gloo on the CPU")
        torch.cuda.set_device(local)
        backend = backend or "nccl"
        if backend == "nccl":
            # Bound to its card, the group builds its NCCL communicator now,
            # not at the first collective (which may be inside a capture).
            kw["device_id"] = torch.device("cuda", local)
    elif device == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"unknown device {device!r}: use 'cuda' or 'cpu'")
    dist.init_process_group(
        backend, init_method=f"tcp://{present['MASTER_ADDR']}:{present['MASTER_PORT']}",
        world_size=size, rank=rank, **kw)
    print(f"[dist] torch.distributed initialized: rank {rank}/{size} over {backend}, "
          f"local rank {local}", flush=True)
    if require and size < 2:
        dist.destroy_process_group()
        raise RuntimeError(f"multi-host run required (MASKVC_REQUIRE_MULTIHOST) but "
                           f"WORLD_SIZE == {size}")
    return True


def finalize(created: bool) -> None:
    """Destroy the default process group if ``initialize`` made it."""
    if created and dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of a globally indexed batch."""
    per = global_batch // world_size()
    i = rank()
    return slice(i * per, (i + 1) * per)
