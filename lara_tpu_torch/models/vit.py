"""DINO ViT image encoder with timm `vit_base_patch16_224.dino` naming, the
counterpart of `lara_tpu/models/vit.py` (the reference's `DinoWrapper`,
lightning/network.py:14-55): ImageNet normalization, 16×16 patch embed,
bicubic-resampled pos-embed (timm dynamic_img_size), 12 pre-norm blocks,
final LayerNorm, CLS token dropped. With `use_flash` the self-attention
runs through the flash kernels (`ops/flash.py`), as `use_flash` does in the
JAX package (lara_tpu/models/vit.py:83-86).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lara_tpu_torch.models.attention import attend
from lara_tpu_torch.models.remat import check_policy, maybe_remat
from lara_tpu_torch.ops.flash import flash_mha

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class TimmAttention(nn.Module):
    """timm attention: joint qkv projection with bias, then proj. The plain
    path scales q in the working dtype before the product, as the JAX
    einsum path does (lara_tpu/models/attention.py:76-79); with `use_flash`
    the flash kernels take the [B, L, h, hd] views of q, k and v and scale
    the logits in f32, as JAX's flash path does."""

    def __init__(self, dim: int, num_heads: int, use_flash: bool = False):
        super().__init__()
        self.num_heads, self.use_flash = num_heads, use_flash
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if not self.use_flash:
            return self.proj(attend(q, k, v, self.num_heads))
        b, l, e = q.shape
        heads = [t.reshape(b, l, self.num_heads, e // self.num_heads) for t in (q, k, v)]
        return self.proj(flash_mha(*heads).reshape(b, l, e))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TimmBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_flash: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TimmAttention(dim, num_heads, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class TimmViT(nn.Module):
    """timm VisionTransformer structure and state-dict names."""

    def __init__(self, dim: int, depth: int, num_heads: int, patch: int = 16,
                 native_grid: int = 14, remat: bool = False,
                 remat_policy: str = "full", use_flash: bool = False):
        super().__init__()
        self.native_grid, self.remat = native_grid, remat
        self.remat_policy = check_policy(remat_policy)
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, native_grid * native_grid + 1, dim))
        self.blocks = nn.ModuleList([TimmBlock(dim, num_heads, use_flash=use_flash)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x [B, 3, H, W] normalized → tokens [B, (H/p)(W/p), dim]."""
        b = x.shape[0]
        x = self.patch_embed.proj(x)                     # [B, C, gh, gw]
        gh, gw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        pos_cls, pos_grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.native_grid, self.native_grid):
            g = self.native_grid
            pos_grid = pos_grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
            pos_grid = F.interpolate(pos_grid, size=(gh, gw), mode="bicubic",
                                     align_corners=False)
            pos_grid = pos_grid.flatten(2).transpose(1, 2)
        x = x + pos_grid.to(x.dtype)
        cls_tok = (self.cls_token + pos_cls).expand(b, -1, -1).to(x.dtype)
        x = torch.cat([cls_tok, x], dim=1)
        for blk in self.blocks:
            x = maybe_remat(self.remat, blk, x, policy=self.remat_policy)
        return self.norm(x)[:, 1:]                       # drop CLS


class DinoViT(nn.Module):
    """The reference's `DinoWrapper`: images [B, H, W, 3] in [0, 1] →
    patch tokens [B, (H/p)(W/p), dim]; the timm model sits under `model`."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, remat: bool = False,
                 remat_policy: str = "full", use_flash: bool = False):
        super().__init__()
        self.model = TimmViT(dim, depth, num_heads, patch_size, remat=remat,
                             remat_policy=remat_policy, use_flash=use_flash)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        return self.model(x)
