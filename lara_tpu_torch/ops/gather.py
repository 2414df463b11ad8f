"""Row gathers, the counterpart of `lara_tpu/ops/gather.py`.

The JAX package wraps its gathers in custom VJPs that shape the backward on
the TPU. Here autograd's `index_add` transpose of plain indexing serves,
with one rule of the JAX package kept: window slots past a tile's count
send no gradient to any packed row (`_window_gather_lazy` sums only valid
slots). Where the counting-sort binning gives the gather's exact inverse
(`slot_pos`), the backward is that inverse's row gathers, as
`_window_gather_slots` does, and needs no `index_add`.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked_rows(packed, win_gidx, entry_valid):
    rows = packed[torch.clamp(win_gidx, max=packed.shape[0] - 1)]
    return torch.where(entry_valid[..., None], rows, 0.0)


class _WindowGatherSlots(torch.autograd.Function):
    """The masked window gather whose backward gathers the cotangent rows
    at each packed row's `slot_pos` (at most dup² window slots per row)."""

    @staticmethod
    def forward(ctx, packed, win_gidx, entry_valid, slot_pos):
        ctx.save_for_backward(slot_pos)
        return _masked_rows(packed, win_gidx, entry_valid)

    @staticmethod
    def backward(ctx, g):
        (slot_pos,) = ctx.saved_tensors
        t, k, f = g.shape
        m = t * k
        g2 = g.reshape(m, f)
        d = None
        for s in range(slot_pos.shape[1]):
            pos = slot_pos[:, s]
            term = torch.where((pos < m)[:, None], g2[torch.clamp(pos, max=m - 1)], 0.0)
            d = term if d is None else d + term
        return d, None, None, None


def window_gather(packed: torch.Tensor, win_gidx: torch.Tensor,
                  entry_valid: torch.Tensor,
                  slot_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """packed[win_gidx] ([V, F] × [T, K] → [T, K, F]) with the slots where
    `entry_valid` [T, K] is False set to 0. Those slots may hold a sentinel
    index (2^19-1, or 0), clamped here to a row; the blend never reads
    them, and zeroing them keeps any gradient they get off that row.

    `slot_pos` [V, dup²] (counting-sort binning): row i's flat window
    positions t·K + rank, ≥ T·K where absent. The backward then takes
    dup² masked row gathers of the cotangent instead of a scatter-add."""
    if slot_pos is not None:
        return _WindowGatherSlots.apply(packed, win_gidx, entry_valid, slot_pos)
    return _masked_rows(packed, win_gidx, entry_valid)
