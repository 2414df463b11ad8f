"""Process-group bring-up, the counterpart of
`lara_tpu/parallel/distributed.py` (Lightning's DDP process group,
train_lightning.py:68-72).

A launcher (`python -m torch.distributed.run --nproc_per_node=N -m ...`)
gives every process RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT; `maybe_initialize_distributed` makes the default process group
from them: NCCL for a CUDA device (process LOCAL_RANK on `cuda:LOCAL_RANK`),
gloo for the CPU. A caller may bring its own group instead
(`torch.distributed.init_process_group` before the call), as the tests and
`chip_smoke.py` do with two gloo ranks.

Where the JAX module warns and goes on as one process when its runtime
cannot start (`distributed.py:56-72`), a failed initialisation raises
here: one process would train on its slice of the global batch alone.

The helpers (`rank`, `world_size`, `is_main`, `barrier`, `any_rank`,
`gather_objects`, `broadcast_module_`) are the one-process answer, with no
collective, where no group exists.
"""

from __future__ import annotations

import contextlib
import os
from typing import List

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda"); under a launcher a CUDA device without an
    index is the process's own, `cuda:LOCAL_RANK`. An explicit index is
    kept (two ranks may share one card)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def maybe_initialize_distributed(device=None) -> bool:
    """Make the default process group from the launcher's environment.
    Returns True when a group exists (made here or by the caller), False
    for a single process (WORLD_SIZE unset or 1), which makes none. Raises
    when the environment is incomplete or the group cannot be made."""
    if is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing or not dist.is_available():
        raise RuntimeError(f"WORLD_SIZE={world} asks for {world} processes, but "
                           f"torch.distributed is {'' if dist.is_available() else 'not '}"
                           f"available and {missing} are not set: launch with "
                           "python -m torch.distributed.run --nproc_per_node=N")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world)
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` is True on any (an all-reduce MAX)."""
    if not is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_objects(obj) -> List:
    """Every rank's `obj` (picklable host values) in rank order, on every
    rank."""
    if not is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_(tensors) -> None:
    """Overwrite each tensor with rank 0's, in place. A tensor on another
    device than the first (AdamW's CPU step counts under NCCL) goes through
    that device."""
    if not is_initialized():
        return
    tensors = list(tensors)
    if not tensors:
        return
    device = tensors[0].device
    for t in tensors:
        if t.device == device:
            dist.broadcast(t.data, 0)
        else:
            moved = t.detach().to(device)
            dist.broadcast(moved, 0)
            t.data.copy_(moved)


def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    broadcast_([*module.parameters(), *module.buffers()])


@contextlib.contextmanager
def process_group(device=None):
    """`maybe_initialize_distributed(device)` for the length of the block;
    a group made here is destroyed at its end (a caller's group is kept)."""
    owned = not is_initialized()
    maybe_initialize_distributed(device)
    try:
        yield
    finally:
        if owned and is_initialized():
            dist.destroy_process_group()
