"""Bilinear grid sampling with the JAX package's signature
(`lara_tpu/ops/grid_sample.py`): zero padding, align_corners=False — the
reference's two call sites (lightning/network.py:374, 405)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feats: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample feats [C, H, W] at normalized coords grid [..., 2] (x, y in
    [-1, 1]); returns [..., C]."""
    lead = grid.shape[:-1]
    out = F.grid_sample(feats[None], grid.reshape(1, 1, -1, 2).to(feats.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)             # [1, C, 1, P]
    return out[0, :, 0].transpose(0, 1).reshape(*lead, feats.shape[0])
