"""Per-layer rematerialisation, the counterpart of `lara_tpu/models/remat.py`
for its one ported policy, "full": a checkpointed layer keeps only its
inputs and recomputes its activations in the backward
(`torch.utils.checkpoint`, non-reentrant, so it composes with autocast and
with gradients that reach the inputs through other paths). It applies only
while gradients are recorded; inference runs the layer as it is."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def maybe_remat(enabled: bool, fn, *args, **kwargs):
    """fn(*args, **kwargs), checkpointed when `enabled` and grad mode is on."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)
