"""Optimizer, schedule and train state, the counterpart of
`lara_tpu/train/state.py` (lightning/system.py:78-118,
lightning/utils.py:89-107, train_lightning.py:73-74):

  - AdamW(lr, betas (0.9, 0.95), eps 1e-8, weight decay 0.05), with no
    decay on biases and LayerNorm weights (`decay_mask`);
  - linear warmup from 1e-10 over `warmup_iters`, then cosine to 0 at
    `max_iters`, evaluated at the optimizer-step count before the update
    (optax evaluates its schedule at its update count, so the first update
    uses the initial lr);
  - global-norm clipping to `grad_clip` (0.5) of the accumulated mean
    gradient, in optax's form g·c/‖g‖ when ‖g‖ ≥ c
    (`torch.nn.utils.clip_grad_norm_` divides by ‖g‖ + 1e-6 instead);
  - `grad_accum` micro-steps per optimizer step, as optax.MultiSteps: the
    gradients of the micro-steps are summed in `.grad` and their mean is
    applied on the last one; parameters do not change on the others;
  - under data parallelism the accumulated gradients are summed over the
    ranks once per optimizer step, on that last micro-step, before the
    1/grad_accum scale and the clip (`parallel/mesh.py`: each rank's
    gradient is its slice's part of the global loss's), so every rank
    clips the same norm and holds the same parameters after the update;
    under tensor parallelism each rank's gradient is a partial sum too
    (`parallel/tp.py`), and the same all-reduce over the world completes it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from lara_tpu_torch.config import TrainConfig
from lara_tpu_torch.parallel.mesh import all_reduce_grads_
from lara_tpu_torch.utils.trace import span


def decay_mask(net: nn.Module) -> Dict[str, bool]:
    """True (decay) for every parameter that is neither a bias nor a
    LayerNorm weight; pos_embed, cls_token and view_embed are decayed."""
    norm_weights = {id(m.weight) for m in net.modules()
                    if isinstance(m, nn.LayerNorm) and m.weight is not None}
    return {name: not (name.split(".")[-1] == "bias" or id(p) in norm_weights)
            for name, p in net.named_parameters()}


def cosine_warmup_schedule(base_lr: float, warmup_iters: int, max_iters: int,
                           initial_lr: float = 1e-10) -> Callable[[int], float]:
    """Linear warmup then cosine decay to 0 (lightning/utils.py:96-107)."""

    def schedule(step: int) -> float:
        if step <= warmup_iters:
            return initial_lr + (base_lr - initial_lr) * step / max(warmup_iters, 1)
        t = min(max((step - warmup_iters) / max(max_iters - warmup_iters, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm/‖g‖ where the global norm
    ‖g‖ ≥ max_norm (optax.clip_by_global_norm). Returns ‖g‖."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class TrainState:
    """The net, its AdamW and the micro-step count `step` (one per
    `apply_gradients`, as the JAX TrainState under MultiSteps)."""

    def __init__(self, net: nn.Module, cfg: TrainConfig, max_iters: int, step: int = 0):
        self.net, self.cfg, self.step = net, cfg, step
        self.schedule = cosine_warmup_schedule(cfg.lr, cfg.warmup_iters, max_iters)
        mask = decay_mask(net)
        named = list(net.named_parameters())
        self.params = [p for _, p in named]
        groups = [{"params": [p for n, p in named if mask[n] == decay],
                   "weight_decay": cfg.weight_decay if decay else 0.0}
                  for decay in (True, False)]
        self.optimizer = torch.optim.AdamW(groups, lr=cfg.lr,
                                           betas=(cfg.beta1, cfg.beta2), eps=1e-8)

    @property
    def opt_step(self) -> int:
        """Optimizer steps taken: the loss gates and the schedule read it."""
        return self.step // self.cfg.grad_accum

    def apply_gradients(self) -> Tuple[bool, Dict[str, float]]:
        """Count one micro-step whose gradients are in `.grad`; on every
        `grad_accum`-th, apply their mean and clear them. Returns (updated,
        info) with the pre-clip gradient norm and lr of an update."""
        self.step += 1
        k = self.cfg.grad_accum
        if self.step % k:
            return False, {}
        # a parameter the step did not reach (the fine MLP in a coarse step)
        # has a zero gradient under optax: its moments decay and its weight
        # decay applies, so it is not skipped here either
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with span("allreduce"):
            all_reduce_grads_(self.params)
        grads = [p.grad for p in self.params]
        if k > 1:
            torch._foreach_mul_(grads, 1.0 / k)
        norm = clip_by_global_norm_(grads, self.cfg.grad_clip)
        lr = self.schedule(self.opt_step - 1)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return True, {"grad_norm": norm, "lr": lr}
