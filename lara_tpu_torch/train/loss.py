"""Training losses, the counterpart of `lara_tpu/train/loss.py`
(lightning/loss.py):

loss = MSE + 0.5·(1 − MS-SSIM)                  (coarse and fine heads)
     + 1000·distortion   (coarse only, gated to step > 1000)
     + 0.2·normal-consistency (same gate; alpha mask detached)

`step` counts optimizer steps (the reference's global_step). The gates are
multiplications by 0 or 1, as in the JAX package, so every term is
computed at every step. MS-SSIM runs in float32 (`ops/msssim.py`).

Every batch mean is the global batch's (`parallel/mesh.py:global_mean`):
under data parallelism each rank holds its slice of the batch, and the
loss and the stats, PSNR from the global MSE included, are those of the
whole batch on every rank, as in the JAX package whatever its mesh. Without
a process group they are the one-process means. Under tensor parallelism
the outputs are gathered over tp first (`parallel/tp.py`), so each input of
a mean is replicated over tp and the same `global_mean` is the dp mean,
its 1/W seed each tp rank's share: nothing here changes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from lara_tpu_torch.ops.msssim import _MSSSIM_WEIGHTS, ms_ssim
from lara_tpu_torch.parallel.mesh import global_mean


def _num_scales(h: int, w: int, win: int = 11) -> int:
    # smallest scale must stay larger than the window
    n = int(math.floor(math.log2(min(h, w) / win))) + 1
    return max(1, min(5, n))


def compute_losses(batch: Dict, output: Dict, step) -> Tuple[torch.Tensor, Dict]:
    """batch/output follow the [B, N, H, W, ...] layout of LaRaNet (B:
    this rank's slice of the global batch). Returns (scalar loss, stats dict of scalar tensors) with the stats keys
    of the JAX package."""
    tar = batch["tar_rgb"].float()
    B, N, H, W, _ = tar.shape
    stats: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32, device=tar.device)

    weights = _MSSSIM_WEIGHTS[:_num_scales(H, W)]
    weights = tuple(w / sum(weights) for w in weights)
    gate = 1.0 if int(step) > 1000 else 0.0

    for prex in ("", "_fine"):
        if f"image{prex}" not in output:
            continue
        img = output[f"image{prex}"].float()
        mse = global_mean((img - tar) ** 2)
        loss = loss + mse
        stats[f"mse{prex}"] = mse
        stats[f"psnr{prex}"] = -10.0 * torch.log(mse) / math.log(10.0)

        # views tiled horizontally into one [B, 3, H, N·W] image before
        # MS-SSIM, as the reference does (lightning/loss.py:23,44)
        x = img.permute(0, 4, 2, 1, 3).reshape(B, 3, H, N * W)
        y = tar.permute(0, 4, 2, 1, 3).reshape(B, 3, H, N * W)
        ssim_val = ms_ssim(x, y, weights=weights)
        stats[f"ssim{prex}"] = ssim_val
        loss = loss + 0.5 * (1.0 - ssim_val)

        if f"rend_dist{prex}" in output and prex != "_fine":
            distortion = global_mean(output[f"rend_dist{prex}"].float())
            stats[f"distortion{prex}"] = distortion
            loss = loss + gate * distortion * 1000.0

            rend_normal = output[f"rend_normal{prex}"].float()
            depth_normal = output[f"depth_normal{prex}"].float()
            acc = output[f"acc_map{prex}"].float().detach()
            normal_err = global_mean(
                (1.0 - torch.sum(rend_normal * depth_normal, dim=-1)) * acc)
            stats[f"normal{prex}"] = normal_err
            loss = loss + gate * normal_err * 0.2

    return loss, stats
