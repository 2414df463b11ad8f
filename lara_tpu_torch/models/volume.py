"""Volume transformer: group cross-attention over the 3D token grid, the
counterpart of `lara_tpu/models/volume.py` (the reference
VolTransformer/GroupAttBlock/ModLN, lightning/network.py:57-164,190-213),
with the reference's state-dict names.

Volumes are channel-last ([B, D, H, W, C]) at every public function, as in
the JAX package; the Conv3d / ConvTranspose3d permute to NCDHW and back.
LayerNorm eps follows the JAX package (1e-6 throughout). Under tensor
parallelism each layer's group attention and MLP run on this rank's group
rows (`parallel/tp.py`); the conv, the norm and the deconv see the whole
volume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from lara_tpu_torch.models.attention import MultiHeadAttention
from lara_tpu_torch.models.remat import check_policy, maybe_remat
from lara_tpu_torch.parallel import tp


def group_volume(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, D, H, W, C] → [B, G³, b³, C] with torch-unfold-compatible ordering
    (group index (gD,gH,gW) row-major; within-block (bD,bH,bW) row-major)."""
    b_, d, _, _, c = x.shape
    g = d // block
    x = x.reshape(b_, g, block, g, block, g, block, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b_, g * g * g, block * block * block, c)


def ungroup_volume(x: torch.Tensor, block: int, reso: int) -> torch.Tensor:
    """Inverse of group_volume: [B, G³, b³, C] → [B, D, H, W, C]."""
    b_, _, _, c = x.shape
    g = reso // block
    x = x.reshape(b_, g, g, g, block, block, block, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b_, reso, reso, reso, c)


def _channels_first(x):
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x):
    return x.permute(0, 2, 3, 4, 1)


class ModLN(nn.Module):
    """adaLN modulation: x ← LN(x)·(1+scale) + shift, (shift, scale) from a
    conditioning vector (lightning/network.py:190-213)."""

    def __init__(self, inner_dim: int, mod_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(inner_dim, eps=1e-6)
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(mod_dim, inner_dim * 2))

    def forward(self, x, cond):
        shift, scale = self.mlp(cond).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale) + shift


def _group_cond(image_feats: torch.Tensor, n_group: int,
                view_mask: Optional[torch.Tensor] = None):
    """Per-layer KV grouping (lightning/network.py:144-150): group each
    view's feature volume and flatten all views' tokens of a group into one
    sequence. [B, V, D, H, W, C] → ([B, G³, V·l, C], the [B, V] view mask
    spread to [B, G³, V·l], or None)."""
    b, v, d, h, w, c = image_feats.shape
    per_view = group_volume(image_feats.reshape(b * v, d, h, w, c), d // n_group)
    g3, l = per_view.shape[1], per_view.shape[2]
    per_view = per_view.reshape(b, v, g3, l, c)
    cond = per_view.transpose(1, 2).reshape(b, g3, v * l, c)
    if view_mask is None:
        return cond, None
    mask = view_mask[:, None, :, None].expand(b, g3, v, l)
    return cond, mask.reshape(b, g3, v * l)


class GroupAttBlock(nn.Module):
    """One volume-transformer layer (lightning/network.py:57-102): group
    cross-attention → MLP → LayerNorm → 3D-conv residual."""

    def __init__(self, inner_dim: int, cond_dim: int, num_heads: int,
                 mlp_ratio: float = 2.0):
        super().__init__()
        hidden = int(inner_dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(inner_dim, eps=1e-6)
        self.cross_attn = MultiHeadAttention(inner_dim, num_heads, kdim=cond_dim)
        self.cnn = nn.Conv3d(inner_dim, inner_dim, 3, padding=1, bias=False)
        self.norm2 = nn.LayerNorm(inner_dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(inner_dim, eps=1e-6)
        self.mlp = nn.Sequential(
            nn.Linear(inner_dim, hidden), nn.GELU(), nn.Dropout(0.0),
            nn.Linear(hidden, inner_dim), nn.Dropout(0.0))

    def forward(self, x, image_feats, block_size: int,
                view_mask: Optional[torch.Tensor] = None):
        """x [B, D, H, W, C]; image_feats the raw per-view feature volume
        [B, V, Df, Hf, Wf, C_cond], grouped here with this layer's blocks;
        view_mask [B, V] bool leaves the False views' tokens out of the
        attention."""
        b, d, _, _, c = x.shape
        cond, cond_mask = _group_cond(image_feats, d // block_size, view_mask)
        patches = group_volume(x, block_size)                 # [B, G, l, C]
        g = patches.shape[1]
        # tp splits the b·g group rows of the attention and the MLP
        flat = tp.shard_groups(patches.reshape(b * g, -1, c))
        cond_flat = tp.shard_groups(cond.reshape(b * g, cond.shape[2], cond.shape[3]))
        mask_flat = None if cond_mask is None else tp.shard_groups(cond_mask.reshape(b * g, -1))
        flat = flat + self.cross_attn(self.norm1(flat), cond_flat, mask_flat)
        flat = flat + self.mlp(self.norm2(flat))
        flat = self.norm3(flat)
        # the conv crosses groups: every row again (under remat the
        # backward's recomputation gathers once more, on every rank alike)
        flat = tp.shard_batch_dim(flat, b * g)
        vol = ungroup_volume(flat.reshape(b, g, -1, c), block_size, d)
        return vol + _channels_last(self.cnn(_channels_first(vol)))


class VolTransformer(nn.Module):
    """Stack of GroupAttBlocks over a learned 3D positional volume, with a
    final 2× transposed-conv upsample (lightning/network.py:105-164)."""

    def __init__(self, embed_dim: int, image_feat_dim: int, n_groups: Sequence[int],
                 vol_low_res: int, out_dim: int, num_layers: int, num_heads: int,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.remat, self.remat_policy = remat, check_policy(remat_policy)
        self.block_sizes = [vol_low_res // n for n in n_groups]
        r = vol_low_res
        self.pos_embed = nn.Parameter(torch.empty(1, embed_dim, r, r, r))
        self.layers = nn.ModuleList([
            GroupAttBlock(embed_dim, image_feat_dim, num_heads)
            for _ in range(num_layers)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.deconv = nn.ConvTranspose3d(embed_dim, out_dim, 2, stride=2)

    def forward(self, image_feats: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image_feats [B, V, D, H, W, C_img] → volume [B, 2D, 2H, 2W, out].
        view_mask [B, V] bool excludes the deselected views' tokens from
        every layer's attention (use_rand_views with static shapes)."""
        b = image_feats.shape[0]
        x = _channels_last(self.pos_embed).expand(b, -1, -1, -1, -1)
        for i, layer in enumerate(self.layers):
            x = maybe_remat(self.remat, layer, x, image_feats,
                            self.block_sizes[i % len(self.block_sizes)], view_mask,
                            policy=self.remat_policy)
        x = self.norm(x)
        return _channels_last(self.deconv(_channels_first(x)))
