"""Row gathers, the counterpart of `lara_tpu/ops/gather.py`.

The JAX package wraps its gathers in custom VJPs that shape the backward;
the serving forward needs only plain indexing (`x[idx]`, used directly by
its callers). The window gather clamps indices past the end, which is what
a JAX gather does with them.
"""

from __future__ import annotations

import torch


def window_gather(packed: torch.Tensor, win_gidx: torch.Tensor) -> torch.Tensor:
    """packed[win_gidx] ([V, F] × [T, K] → [T, K, F]). Window slots past a
    tile's count may hold the sentinel index 2^19-1; they are clamped to the
    last row and never read by the blend."""
    return packed[torch.clamp(win_gidx, max=packed.shape[0] - 1)]
