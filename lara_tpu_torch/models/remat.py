"""Per-layer rematerialisation, the counterpart of `lara_tpu/models/remat.py`:
a checkpointed layer keeps less than its activations and recomputes the
rest in the backward (`torch.utils.checkpoint`, non-reentrant, so it
composes with autocast, with custom autograd functions such as the flash
kernels, and with gradients that reach the inputs through other paths). It
applies only while gradients are recorded; inference runs the layer as it
is.

Policies (`ModelConfig.remat_policy`):
  "full": save nothing but the layer's inputs; recompute the whole layer.
  "dots": the counterpart of `jax.checkpoint_policies.
          dots_with_no_batch_dims_saveable`: save the outputs of the
          products without batch dimensions, which in PyTorch are the dense
          layers' `aten.mm` / `aten.addmm`, and recompute everything else
          (the attention's batched products, the flash kernel, norms,
          activations, convolutions), through
          `torch.utils.checkpoint.create_selective_checkpoint_contexts`.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_policy(name: str) -> str:
    if name not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {name!r} (expected full|dots)")
    return name


def maybe_remat(enabled: bool, fn, *args, policy: str = "full", **kwargs):
    """fn(*args, **kwargs), checkpointed under `policy` when `enabled` and
    grad mode is on."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    if check_policy(policy) == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)
