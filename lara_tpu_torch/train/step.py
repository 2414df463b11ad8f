"""Serving entry point, the counterpart of
`lara_tpu/train/step.py:make_forward` (evaluation.py:61 equivalent)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from lara_tpu_torch.models.lara import LaRaNet


def make_forward(net: LaRaNet, with_fine: bool = True,
                 return_buffer: bool = False) -> Callable[[Dict], Dict]:
    """Inference forward over a batch of tensors on the model's device
    (eval budgets, no autograd). Puts `net` in eval mode."""
    net.eval()

    @torch.inference_mode()
    def fwd(batch: Dict) -> Dict:
        return net(batch, with_fine=with_fine, train=False,
                   return_buffer=return_buffer)

    return fwd
