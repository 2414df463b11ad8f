"""Training checkpoints with `torch.save`, the counterpart of
`lara_tpu/train/checkpoint.py` (Lightning ModelCheckpoint + resume,
train_lightning.py:58-64,85-90).

A checkpoint is one file `<dir>/step_{step:09d}.pt` holding the network's
parameters, the AdamW state, the micro-step count `step`, the `epoch`, and
the `.grad` buffers of an accumulation still open at `step` (optax
MultiSteps keeps its accumulator in `opt_state`, so a checkpoint taken
between the micro-steps of one accumulation loses nothing). Files are
written beside their final name and renamed, and the newest 5 are kept.

Under data parallelism every rank calls both functions. Rank 0 alone
writes, then all wait at a barrier. Each rank's `.grad` holds its slice's
part of an open accumulation, so the checkpoint keeps their sum over the
ranks (every parameter's; the JAX package's accumulator holds the global
batch's), and on restore rank 0 takes it and the others start from none.
Every rank reads the file; the trainer then replicates rank 0's state
(`parallel/mesh.py:replicate_state`).

The JAX package's `migrate_unrolled_layout` upgrades its own pre-scan
parameter trees; the port's layout is the reference's state dict, so it has
no counterpart here. A JAX parameter tree crosses over through
`models/convert.py:params_from_jax`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from lara_tpu_torch.parallel.distributed import barrier, is_initialized, is_main
from lara_tpu_torch.parallel.mesh import all_reduce_sum_
from lara_tpu_torch.train.state import TrainState

KEEP = 5
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state: TrainState, epoch: int) -> str:
    """Write the state at its micro-step `state.step`; keep the newest KEEP.
    Called on every rank; rank 0 writes."""
    grads = {n: p.grad for n, p in state.net.named_parameters() if p.grad is not None}
    if is_initialized() and state.step % state.cfg.grad_accum:
        named = list(state.net.named_parameters())
        summed = [torch.zeros_like(p) if p.grad is None else p.grad.clone() for _, p in named]
        all_reduce_sum_(summed)
        grads = {n: g for (n, _), g in zip(named, summed)}
    path = checkpoint_path(directory, int(state.step))
    if is_main():
        _write(directory, path, state, epoch, grads)
    barrier()
    return path


def _write(directory: str, path: str, state: TrainState, epoch: int, grads: Dict) -> None:
    os.makedirs(directory, exist_ok=True)
    payload = {
        "params": state.net.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "grads": grads,
    }
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-KEEP]:
        os.remove(checkpoint_path(directory, old))


def _load(path: str, step: Optional[int], map_location) -> Dict:
    """The payload at `path`: a checkpoint file, or a directory's checkpoint
    at `step` (its newest when None)."""
    if os.path.isdir(path):
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = checkpoint_path(path, step)
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(path: str, state: TrainState, step: Optional[int] = None) -> int:
    """Load parameters, optimizer state, `step` and the open accumulation's
    gradients into `state` (in place, on its device). Returns the saved
    epoch. Under data parallelism only rank 0 takes the gradients."""
    payload = _load(path, step, next(state.net.parameters()).device)
    state.net.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    grads = payload["grads"] if is_main() else {}
    for name, p in state.net.named_parameters():
        p.grad = grads[name].to(p.dtype) if name in grads else None
    return int(payload["epoch"])


def restore_params(path: str, step: Optional[int] = None) -> Dict:
    """The network's state dict alone, on the CPU (evaluation's weight-only
    load)."""
    return _load(path, step, "cpu")["params"]
