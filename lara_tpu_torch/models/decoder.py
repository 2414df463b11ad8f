"""Gaussian-parameter decoders, the counterpart of
`lara_tpu/models/decoder.py` (lightning/network.py:215-284).

The reference keeps both heads in one `decoder` module (state-dict names
`decoder.{mlp_coarse.*, norm, cross_att, mlp_fine.*}`), and so does this
port: `forward_coarse` is the JAX package's CoarseDecoder, `forward_fine`
its FineDecoder.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from lara_tpu_torch.models.attention import MultiHeadAttention


class Decoder(nn.Module):
    def __init__(self, in_dim: int, sh_dim: int, K: int, cond_dim: int = 8,
                 num_heads: int = 8, hidden: int = 64):
        super().__init__()
        self.K, self.sh_dim = K, sh_dim
        self.out_dim = 3 + sh_dim + 1 + 2 + 4
        self.mlp_coarse = nn.Sequential(
            nn.Linear(in_dim, in_dim), nn.ReLU(),
            nn.Linear(in_dim, in_dim), nn.ReLU(),
            nn.Linear(in_dim, self.out_dim * K))
        self.norm = nn.LayerNorm(in_dim, eps=1e-6)
        self.cross_att = MultiHeadAttention(in_dim, num_heads, kdim=cond_dim)
        self.mlp_fine = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.ReLU(), nn.Linear(hidden, sh_dim))

    def forward_coarse(self, feats, opacity_shift: float, scaling_shift: float):
        """feats [B, Nv, in_dim] → per-surfel params, N = Nv·K rows, in f32:
        (offset [B,N,3] in (-1,1), sh [B,N,sh_dim/3,3], scaling [B,N,2],
        rotation [B,N,4], opacity [B,N,1]) (lightning/network.py:259-278)."""
        x = self.mlp_coarse(feats).float()
        b = x.shape[0]
        x = x.reshape(b, -1, self.K, self.out_dim)
        offset, sh, opacity, scaling, rotation = torch.split(
            x, [3, self.sh_dim, 1, 2, 4], dim=-1)
        opacity = opacity + opacity_shift
        scaling = scaling + scaling_shift
        offset = torch.sigmoid(offset) * 2.0 - 1.0
        return (offset.reshape(b, -1, 3), sh.reshape(b, -1, self.sh_dim // 3, 3),
                scaling.reshape(b, -1, 2), rotation.reshape(b, -1, 4),
                opacity.reshape(b, -1, 1))

    def forward_fine(self, volume_feat, point_feats, view_mask=None):
        """volume_feat [M, in_dim]; point_feats [M, V, cond_dim] → SH
        residual [M, sh_dim] in f32 (lightning/network.py:280-284).
        view_mask [V] bool drops the deselected views (use_rand_views)."""
        q = self.norm(volume_feat)[:, None, :]                # [M, 1, C]
        kv_mask = (None if view_mask is None
                   else view_mask[None, :].expand(point_feats.shape[:2]))
        x = self.cross_att(q, point_feats, kv_mask)
        return self.mlp_fine(x)[:, 0, :].float()
