"""Multi-head (cross-)attention, the counterpart of
`lara_tpu/models/attention.py`: plain matmul + f32 softmax, scale
1/sqrt(head_dim) applied to q, and an optional key mask (torch MHA
key_padding_mask semantics, inverted: False keys are left out of the
softmax), which the view-selection paths use."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Lq, E], k/v [B, Lk, E] (already projected), kv_mask [B, Lk]
    bool or None → [B, Lq, E]. Masked keys get the logit -1e9, as in the
    JAX package."""
    b, lq, e = q.shape
    lk, hd = k.shape[1], e // num_heads
    q = q.reshape(b, lq, num_heads, hd).transpose(1, 2) * hd ** -0.5
    k = k.reshape(b, lk, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)).float()
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    out = probs.to(v.dtype) @ v
    return out.transpose(1, 2).reshape(b, lq, e)


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention(batch_first=True, bias=False) with
    kdim/vdim ≠ embed_dim, and its state-dict names (q_proj_weight,
    k_proj_weight, v_proj_weight, out_proj.weight): the cross-attentions of
    lightning/network.py:65-67 and 235-237."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj_weight = nn.Parameter(torch.empty(embed_dim, embed_dim))
        self.k_proj_weight = nn.Parameter(torch.empty(embed_dim, kdim))
        self.v_proj_weight = nn.Parameter(torch.empty(embed_dim, kdim))
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = F.linear(q_in, self.q_proj_weight)
        k = F.linear(kv_in, self.k_proj_weight)
        v = F.linear(kv_in, self.v_proj_weight)
        return self.out_proj(attend(q, k, v, self.num_heads, kv_mask))
