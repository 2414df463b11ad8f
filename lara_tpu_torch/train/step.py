"""Train, eval and serving steps, the counterpart of `lara_tpu/train/step.py`
(lightning/system.py:24-45 and evaluation.py:61).

`with_fine` selects the coarse-only or the fine step, as the JAX training loop
switches at `train.start_fine`. The loss gates read the optimizer-step
count `state.step // grad_accum` (the reference's global_step), as
`lara_tpu/train/step.py:46` does.

Under data parallelism each rank calls the step on its slice of the global
batch; the loss and the stats a step returns are the global batch's
(`train/loss.py`), and the gradients are summed over the ranks once per
optimizer step (`train/state.py`). Under tensor parallelism the tp ranks of
one dp index call the step on the same scenes, and the forward splits its
work between them (`parallel/tp.py`, enabled by the caller).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from lara_tpu_torch.models.lara import LaRaNet
from lara_tpu_torch.train.loss import compute_losses
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.utils.trace import span


def make_train_step(net: LaRaNet, state: TrainState, with_fine: bool,
                    grad_accum: int = 1, n_views_sel: Optional[int] = None
                    ) -> Callable[[Dict], Dict]:
    """One micro-step per call: forward at the train raster budgets, losses,
    backward, then `state.apply_gradients()` (which updates the parameters
    on every `grad_accum`-th call). Returns the detached stats with "loss".
    `n_views_sel` (use_rand_views) encodes only the first n_views_sel
    input views."""

    def step(batch: Dict) -> Dict:
        net.train()
        out = net(batch, with_fine=with_fine, train=True, n_views_sel=n_views_sel)
        with span("loss"):
            loss, stats = compute_losses(batch, out, state.step // grad_accum)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            state.apply_gradients()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["loss"] = loss.detach()
        return stats

    return step


def make_eval_step(net: LaRaNet, with_fine: bool = True) -> Callable:
    """(batch, step) → (outputs, stats): the forward at the eval budgets and
    the losses at optimizer step `step`, without gradients."""

    @torch.no_grad()
    def step(batch: Dict, step: int) -> Tuple[Dict, Dict]:
        net.eval()
        out = net(batch, with_fine=with_fine, train=False)
        with span("loss"):
            loss, stats = compute_losses(batch, out, step)
        stats = dict(stats)
        stats["loss"] = loss
        return out, stats

    return step


def make_forward(net: LaRaNet, with_fine: bool = True, return_buffer: bool = False,
                 render_scale: float = 1.0) -> Callable[[Dict], Dict]:
    """Inference forward over a batch of tensors on the model's device
    (eval budgets, no autograd). Puts `net` in eval mode. `render_scale`
    is the reference's `render_img_scale` (lightning/network.py:467)."""
    net.eval()

    @torch.inference_mode()
    def fwd(batch: Dict) -> Dict:
        return net(batch, with_fine=with_fine, train=False,
                   return_buffer=return_buffer, render_scale=render_scale)

    return fwd
