"""LaRa's training objective and its first AdamW update in plain PyTorch
(lightning/loss.py, lightning/system.py:78-118 of autonomousvision/LaRa):

loss = Σ over the coarse and fine heads of MSE + 0.5·(1 − MS-SSIM)
     + 1000·distortion + 0.2·normal consistency (coarse head, optimizer
       step > 1000; the normal's alpha mask detached)

MS-SSIM as pytorch_msssim computes it: an 11-tap Gaussian window of σ 1.5
with valid padding, K1 0.01, K2 0.03, 2× average pooling between scales,
ReLU on each scale's mean, the scales' weights renormalised to those the
image size allows. The views of a scene are tiled side by side first.

The optimizer is AdamW with betas (0.9, 0.95), eps 1e-8, weight decay
0.05 on every parameter but biases and LayerNorm weights, a linear warm-up
then a cosine schedule, the micro-steps' gradients averaged over
`grad_accum` and clipped to a global norm of `grad_clip` (g·c/‖g‖ where
‖g‖ ≥ c).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _window(device):
    x = torch.arange(11, dtype=torch.float32, device=device) - 5.0
    g = torch.exp(-(x * x) / (2.0 * 1.5 * 1.5))
    return g / g.sum()


def _blur(x, win):
    c = x.shape[1]
    x = F.conv2d(x, win.view(1, 1, 11, 1).expand(c, 1, 11, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, 11).expand(c, 1, 1, 11), groups=c)


def ms_ssim(x, y, weights):
    win = _window(x.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    vals = []
    for i in range(len(weights)):
        mx, my = _blur(x, win), _blur(y, win)
        sxx = _blur(x * x, win) - mx * mx
        syy = _blur(y * y, win) - my * my
        sxy = _blur(x * y, win) - mx * my
        cs = (2.0 * sxy + c2) / (sxx + syy + c2)
        if i < len(weights) - 1:
            vals.append(torch.relu(cs.mean()))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
        else:
            vals.append(torch.relu((((2.0 * mx * my + c1) / (mx * mx + my * my + c1)) * cs).mean()))
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    return torch.prod(torch.clamp(torch.stack(vals), min=1e-6) ** w)


def losses(batch: Dict, out: Dict, opt_step: int) -> torch.Tensor:
    tar = batch["tar_rgb"]
    b, n, h, w, _ = tar.shape
    scales = max(1, min(5, int(math.floor(math.log2(min(h, w) / 11))) + 1))
    weights = tuple(x / sum(MSSSIM_WEIGHTS[:scales]) for x in MSSSIM_WEIGHTS[:scales])
    gate = 1.0 if opt_step > 1000 else 0.0
    loss = torch.zeros((), device=tar.device)
    for sfx in ("", "_fine"):
        img = out[f"image{sfx}"]
        loss = loss + torch.mean((img - tar) ** 2)
        tile = img.permute(0, 4, 2, 1, 3).reshape(b, 3, h, n * w)
        ref = tar.permute(0, 4, 2, 1, 3).reshape(b, 3, h, n * w)
        loss = loss + 0.5 * (1.0 - ms_ssim(tile, ref, weights))
        if sfx == "":
            loss = loss + gate * 1000.0 * torch.mean(out["rend_dist"])
            cos = torch.sum(out["rend_normal"] * out["depth_normal"], -1)
            loss = loss + gate * 0.2 * torch.mean((1.0 - cos) * out["acc_map"].detach())
    return loss


def decayed(net: nn.Module) -> Dict[str, bool]:
    norms = {id(m.weight) for m in net.modules() if isinstance(m, nn.LayerNorm)}
    return {name: not (name.endswith(".bias") or name == "bias" or id(p) in norms)
            for name, p in net.named_parameters()}


def schedule(lr: float, warmup: int, max_iters: int, step: int) -> float:
    if step <= warmup:
        return 1e-10 + (lr - 1e-10) * step / max(warmup, 1)
    t = min(max((step - warmup) / max(max_iters - warmup, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t))


def first_update(params: Dict[str, torch.Tensor], grads: List[Dict[str, torch.Tensor]],
                 decay: Dict[str, bool], tc: Dict, opt_step: int):
    """AdamW's first update from the micro-steps' gradients `grads`:
    (the clipped mean gradient it applies, the parameters after it)."""
    mean = {k: sum(g[k] for g in grads) / len(grads) for k in params}
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in mean.values()]))
    scale = torch.where(norm < tc["grad_clip"], 1.0, tc["grad_clip"] / norm)
    clipped = {k: g * scale for k, g in mean.items()}
    lr = schedule(tc["lr"], tc["warmup_iters"], tc["max_iters"], opt_step)
    b1, b2 = tc["beta1"], tc["beta2"]
    new = {}
    for k, p in params.items():
        g = clipped[k]
        m = (1 - b1) * g
        denom = torch.sqrt((1 - b2) * g * g) / math.sqrt(1 - b2) + 1e-8
        wd = tc["weight_decay"] if decay[k] else 0.0
        new[k] = p * (1 - lr * wd) - (lr / (1 - b1)) * m / denom
    return clipped, new
