"""Row gathers, the counterpart of `lara_tpu/ops/gather.py`.

The JAX package wraps its gathers in custom VJPs that shape the backward on
the TPU; here autograd's `index_add` transpose of plain indexing serves,
with one rule of the JAX package kept: window slots past a tile's count
send no gradient to any packed row (`_window_gather_lazy` sums only valid
slots).
"""

from __future__ import annotations

import torch


def window_gather(packed: torch.Tensor, win_gidx: torch.Tensor,
                  entry_valid: torch.Tensor) -> torch.Tensor:
    """packed[win_gidx] ([V, F] × [T, K] → [T, K, F]) with the slots where
    `entry_valid` [T, K] is False set to 0. Those slots may hold the
    sentinel index 2^19-1, clamped here to the last row; the blend never
    reads them, and zeroing them keeps any gradient they get off that row."""
    rows = packed[torch.clamp(win_gidx, max=packed.shape[0] - 1)]
    return torch.where(entry_valid[..., None], rows, 0.0)
