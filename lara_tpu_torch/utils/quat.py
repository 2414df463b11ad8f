"""Quaternion utilities, the counterpart of `lara_tpu/utils/quat.py`.

Quaternion layout is (w, x, y, z) — same as the reference and the 2DGS CUDA
kernels (lightning/renderer_2dgs.py:34-55).
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` as v·rsqrt(Σv²+eps²) (the JAX package's
    formulation: equal to v/‖v‖ away from zero)."""
    ss = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(ss + eps * eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (w,x,y,z), any norm -> rotation [..., 3, 3]."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)
