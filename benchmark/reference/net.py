"""LaRa's network in plain PyTorch and float32 (lightning/network.py:14-533
of autonomousvision/LaRa): the DINO ViT-B/16 encoder, the ray-direction
ModLN, the feature volume, the group-attention volume transformer, the
coarse surfel decoder, the coarse renders, the fine stage (the top
`fine_budget` surfels by opacity get an SH residual from the fine decoder)
and the fine re-renders. Parameter names are the reference state dict's,
so one dict of weights loads into this module and into the program alike.

Every product of the network (dense layers, convolutions, attention) goes
through `q()`, the identity unless `fp8_products()` is on: then both
operands and the result are rounded to float8 e4m3 with one scale per
tensor, and the gradient flowing back through each to float8 e5m2, as
float8 training rounds them. That is the control: the network computed one
precision below the bfloat16 autocast it is served and trained in, where
every product's operands and result are bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import raster

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPACITY_SHIFT = -2.1792
_LOWP = {"fp8": False}


def _round(x, dtype):
    scale = torch.clamp(x.abs().amax(), min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def q(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x) if _LOWP["fp8"] else x


@contextlib.contextmanager
def fp8_products():
    """Round the network's products to float8 (the control)."""
    _LOWP["fp8"] = True
    try:
        yield
    finally:
        _LOWP["fp8"] = False


class Linear(nn.Linear):
    def forward(self, x):
        return q(F.linear(q(x), q(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return q(F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return q(F.conv3d(q(x), q(self.weight), self.bias, self.stride, self.padding))


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x):
        return q(F.conv_transpose3d(q(x), q(self.weight), self.bias, self.stride))


def attend(qv, k, v, heads: int, kv_mask=None):
    """Multi-head attention of projected q [B, Lq, E], k/v [B, Lk, E]."""
    b, lq, e = qv.shape
    lk, hd = k.shape[1], e // heads
    qv = qv.reshape(b, lq, heads, hd).transpose(1, 2) * hd ** -0.5
    k = k.reshape(b, lk, heads, hd).transpose(1, 2)
    v = v.reshape(b, lk, heads, hd).transpose(1, 2)
    logits = q(q(qv) @ q(k).transpose(-1, -2))
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    return q(q(probs) @ q(v)).transpose(1, 2).reshape(b, lq, e)


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention(batch_first, bias=False, kdim=vdim)."""

    def __init__(self, dim: int, heads: int, kdim: int):
        super().__init__()
        self.num_heads = heads
        self.q_proj_weight = nn.Parameter(torch.empty(dim, dim))
        self.k_proj_weight = nn.Parameter(torch.empty(dim, kdim))
        self.v_proj_weight = nn.Parameter(torch.empty(dim, kdim))
        self.out_proj = Linear(dim, dim, bias=False)

    def forward(self, x, kv, kv_mask=None):
        o = attend(q(F.linear(q(x), q(self.q_proj_weight))),
                   q(F.linear(q(kv), q(self.k_proj_weight))),
                   q(F.linear(q(kv), q(self.v_proj_weight))), self.num_heads, kv_mask)
        return self.out_proj(o)


class TimmAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.num_heads = heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        return self.proj(attend(*self.qkv(x).chunk(3, dim=-1), self.num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


def _remat(on: bool, fn, *args):
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ViT(nn.Module):
    """timm vit_base_patch16_224.dino: bicubic-resized 14² position grid."""

    def __init__(self, dim: int, depth: int, heads: int, patch: int, grid: int = 14):
        super().__init__()
        self.grid = grid
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList([Block(dim, heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, remat: bool):
        b = x.shape[0]
        x = self.patch_embed.proj(x)
        gh, gw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed[:, 1:]
        if (gh, gw) != (self.grid, self.grid):
            pos = pos.reshape(1, self.grid, self.grid, -1).permute(0, 3, 1, 2)
            pos = F.interpolate(pos, size=(gh, gw), mode="bicubic", align_corners=False)
            pos = pos.flatten(2).transpose(1, 2)
        x = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1), x + pos], 1)
        for blk in self.blocks:
            x = _remat(remat, blk, x)
        return self.norm(x)[:, 1:]


class DinoViT(nn.Module):
    def __init__(self, dim, depth, heads, patch):
        super().__init__()
        self.model = ViT(dim, depth, heads, patch)

    def forward(self, images, remat: bool):
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        return self.model(((images - mean) / std).permute(0, 3, 1, 2), remat)


class ModLN(nn.Module):
    def __init__(self, dim: int, mod_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential(nn.SiLU(), Linear(mod_dim, 2 * dim))

    def forward(self, x, cond):
        shift, scale = self.mlp(cond).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale) + shift


def group_volume(x, block: int):
    """[B, D, D, D, C] → [B, G³, block³, C] (torch unfold order)."""
    b, d, _, _, c = x.shape
    g = d // block
    x = x.reshape(b, g, block, g, block, g, block, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, g ** 3, block ** 3, c)


def ungroup_volume(x, block: int, reso: int):
    b, _, _, c = x.shape
    g = reso // block
    x = x.reshape(b, g, g, g, block, block, block, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, reso, reso, reso, c)


class GroupAttBlock(nn.Module):
    def __init__(self, dim: int, cond_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn = MultiHeadAttention(dim, heads, cond_dim)
        self.cnn = Conv3d(dim, dim, 3, padding=1, bias=False)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential(Linear(dim, 2 * dim), nn.GELU(), nn.Dropout(0.0),
                                 Linear(2 * dim, dim), nn.Dropout(0.0))

    def forward(self, x, feats, block: int):
        b, d, _, _, c = x.shape
        bv, v = feats.shape[0], feats.shape[1]
        per_view = group_volume(feats.flatten(0, 1), feats.shape[2] // (d // block))
        g3, ln = per_view.shape[1], per_view.shape[2]
        cond = per_view.reshape(bv, v, g3, ln, -1).transpose(1, 2).reshape(bv * g3, v * ln, -1)
        flat = group_volume(x, block).reshape(b * g3, -1, c)
        flat = flat + self.cross_attn(self.norm1(flat), cond)
        flat = self.norm3(flat + self.mlp(self.norm2(flat)))
        vol = ungroup_volume(flat.reshape(b, g3, -1, c), block, d)
        return vol + self.cnn(vol.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class VolTransformer(nn.Module):
    def __init__(self, dim, cond_dim, n_groups, reso, out_dim, layers, heads):
        super().__init__()
        self.blocks = [reso // n for n in n_groups]
        self.pos_embed = nn.Parameter(torch.empty(1, dim, reso, reso, reso))
        self.layers = nn.ModuleList([GroupAttBlock(dim, cond_dim, heads)
                                     for _ in range(layers)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.deconv = ConvTranspose3d(dim, out_dim, 2, stride=2)

    def forward(self, feats, remat: bool):
        x = self.pos_embed.permute(0, 2, 3, 4, 1).expand(feats.shape[0], -1, -1, -1, -1)
        for i, layer in enumerate(self.layers):
            x = _remat(remat, layer, x, feats, self.blocks[i % len(self.blocks)])
        x = self.norm(x).permute(0, 4, 1, 2, 3)
        return self.deconv(x).permute(0, 2, 3, 4, 1)


class Decoder(nn.Module):
    def __init__(self, dim: int, sh_dim: int, k: int):
        super().__init__()
        self.K, self.sh_dim = k, sh_dim
        self.out_dim = 3 + sh_dim + 1 + 2 + 4
        self.mlp_coarse = nn.Sequential(Linear(dim, dim), nn.ReLU(), Linear(dim, dim),
                                        nn.ReLU(), Linear(dim, self.out_dim * k))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.cross_att = MultiHeadAttention(dim, 8, 8)
        self.mlp_fine = nn.Sequential(Linear(dim, 64), nn.ReLU(), Linear(64, sh_dim))


def grid_sample_2d(feats, grid):
    """feats [C, H, W] sampled bilinearly at grid [P, 2] in [-1, 1]
    (zero padding, align_corners=False) → [P, C]."""
    out = F.grid_sample(feats[None], grid.reshape(1, 1, -1, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0, :, 0].transpose(0, 1)


def dense_grid(reso: int, scene_size: float, device):
    ax = (torch.arange(reso, dtype=torch.float32, device=device) + 0.5) / reso * 2.0 - 1.0
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3) * scene_size


def resize_linear(x, h: int, w: int):
    """[B, N, H, W, C] → [B, N, h, w, C]: linear, half-pixel centres,
    antialiased when shrinking (jax.image.resize "linear")."""
    b, n, hh, ww, c = x.shape
    flat = x.reshape(b * n, hh, ww, c).permute(0, 3, 1, 2)
    out = F.interpolate(flat, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).reshape(b, n, h, w, c)


class LaRa(nn.Module):
    """`cfg` is the benchmark configuration's dict (model, render, n_views)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        m = cfg["model"]
        self.cfg, self.m = cfg, m
        with torch.device("meta"):
            self.img_encoder = DinoViT(m["encoder_dim"], m["encoder_depth"],
                                       m["encoder_heads"], m["patch_size"])
            self.dir_norm = ModLN(m["encoder_dim"], 32)
            self.view_embed = nn.Parameter(torch.empty(1, 4, m["view_embed_dim"], 1, 1, 1))
            self.vol_decoder = VolTransformer(
                m["embedding_dim"], m["encoder_dim"] + m["view_embed_dim"], m["n_groups"],
                m["vol_embedding_reso"], m["vol_embedding_out_dim"], m["num_layers"],
                m["num_heads"])
            self.sh_dim = (m["sh_degree"] + 1) ** 2 * 3
            self.decoder = Decoder(m["vol_embedding_out_dim"], self.sh_dim, m["K"])
        voxel = 2.0 / (m["vol_embedding_reso"] * 2)
        self.scaling_shift = math.log(0.5 * voxel / 3.0)

    # -- the network -------------------------------------------------------
    def surfels(self, batch, remat: bool = False):
        """Coarse surfels of every scene: (centers [B, P, 3], sh [B, P, 4, 3],
        opacity [B, P, 1], scaling [B, P, 2], rotation [B, P, 4]) and the
        decoder's input volume [B, P/K, C]."""
        m = self.m
        rgb = batch["tar_rgb"]
        b, _, h, w, _ = rgb.shape
        n = self.cfg["n_views"]
        imgs = rgb[:, :n].reshape(b * n, h, w, 3)
        tokens = self.img_encoder(imgs, remat)
        p = m["patch_size"]
        feats = tokens.reshape(b * n, h // p, w // p, -1)
        plk = raster.ray_to_plucker(batch["tar_rays_down"][:, :n].reshape(b * n, h // p, w // p, 6))
        feats = self.dir_norm(feats, torch.cat([raster.rsh_cart(plk[..., :3], 3),
                                                raster.rsh_cart(plk[..., 3:], 3)], -1))
        reso = m["vol_feat_reso"]
        grid = dense_grid(reso, m["scene_size"], rgb.device)
        wh = torch.tensor([w, h], dtype=torch.float32, device=rgb.device)
        w2cs = batch["tar_w2c"][:, :n].reshape(-1, 4, 4)
        ixts = batch["tar_ixt"][:, :n].reshape(-1, 3, 3)
        vols = []
        for f, w2c, ixt in zip(feats, w2cs, ixts):
            img = (grid @ w2c[:3, :3].T + w2c[:3, 3]) @ ixt.T
            gridc = (img[:, :2] / img[:, 2:3] + 0.5) / wh * 2.0 - 1.0
            vols.append(grid_sample_2d(f.permute(2, 0, 1), gridc))
        vol = torch.stack(vols).reshape(b, n, reso, reso, reso, -1)
        ve = self.view_embed[0, :n, :, 0, 0, 0][None, :, None, None, None, :]
        vol = torch.cat([vol, ve.expand(b, n, reso, reso, reso, -1)], -1)
        volume = self.vol_decoder(vol, remat)
        feat_up = volume.reshape(b, -1, m["vol_embedding_out_dim"])
        x = self.decoder.mlp_coarse(feat_up).reshape(b, -1, m["K"], self.decoder.out_dim)
        offset, sh, opacity, scaling, rotation = torch.split(x, [3, self.sh_dim, 1, 2, 4], -1)
        offset = torch.sigmoid(offset) * 2.0 - 1.0
        centers_grid = dense_grid(2 * m["vol_embedding_reso"], m["scene_size"], rgb.device)
        half = 0.5 * m["scene_size"] / m["n_offset_groups"]
        centers = (centers_grid[None, :, None, :] + offset * half).reshape(b, -1, 3)
        return (centers, sh.reshape(b, -1, self.sh_dim // 3, 3),
                (opacity + OPACITY_SHIFT).reshape(b, -1, 1),
                (scaling + self.scaling_shift).reshape(b, -1, 2),
                rotation.reshape(b, -1, 4)), feat_up

    def select(self, opacity):
        """The fine stage's top-M of one scene by coarse opacity, ties to
        the lower index: (idx [M], kept [M] bool)."""
        m_sel = min(self.m["fine_budget"], opacity.shape[0])
        act = torch.sigmoid(opacity[..., 0].detach())
        score = torch.where(act > 0.005, act, -1.0)
        idx = torch.argsort(score, descending=True, stable=True)[:m_sel]
        return idx, score[idx] > 0.0

    def fine_sh(self, batch, coarse, sur, feat_up, b: int, idx, hw):
        """SH of every surfel of scene b after the fine residual."""
        centers, sh = sur[0], sur[1]
        h, w = hw
        wh = torch.tensor([w, h], dtype=torch.float32, device=centers.device)
        c_sel = centers[b][idx]
        pf = []
        for v in range(self.cfg["n_views"]):
            w2c, ixt = batch["tar_w2c"][b, v], batch["tar_ixt"][b, v]
            img = (c_sel @ w2c[:3, :3].T + w2c[:3, 3]) @ ixt.T
            z = img[:, 2]
            gridc = (img[:, :2] / z[:, None] + 0.5) / wh * 2.0 - 1.0
            stack = torch.cat([batch["tar_rgb"][b, v], coarse["image"][b, v],
                               coarse["acc_map"][b, v][..., None], coarse["depth"][b, v]], -1)
            samp = grid_sample_2d(stack.permute(2, 0, 1), gridc)
            pf.append(torch.cat([samp[:, :-1], torch.abs(samp[:, -1] - z)[:, None]], -1))
        dec = self.decoder
        x = dec.cross_att(dec.norm(feat_up[b][idx // self.m["K"]])[:, None, :],
                          torch.stack(pf, 1))
        res = dec.mlp_fine(x)[:, 0, :]
        return sh[b].index_add(0, idx, res.reshape(idx.shape[0], self.sh_dim // 3, 3))

    # -- the whole forward ---------------------------------------------------
    def forward(self, batch, train: bool, render_scale: float = 1.0, remat: bool = False):
        """The program's outputs at [B, N, H', W', ...] (coarse and `_fine`),
        plus `surfels` (coarse), `sh_fine` and `selected` ([B, P] bool)."""
        rc = self.cfg["render"]
        rgb = batch["tar_rgb"]
        b, n_all, h, w, _ = rgb.shape
        sur, feat_up = self.surfels(batch, remat)
        rays = batch["tar_rays"]
        hs, ws = h, w
        if render_scale != 1.0:
            t = rc["tile"]
            hs = max(t, int(round(h * render_scale / t)) * t)
            ws = max(t, int(round(w * render_scale / t)) * t)
            rays = resize_linear(rays, hs, ws)
        rcfg = raster.RasterConfig.from_render(rc, hs, ws, train, self.m["sh_degree"])
        cams = raster.cameras(batch)
        bg = batch["bg_color"]
        centers, sh, opacity, scaling, rotation = sur

        def render(bi, v, shs, keep=None, binned=None):
            return raster.render_view(
                raster.view(cams, bi, v), rays[bi, v], centers[bi], shs, opacity[bi],
                scaling[bi], rotation[bi], bg[bi, v], rcfg, keep=keep, binned=binned)

        def run(fn, *args):
            if remat and torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        frames, binned = [], []
        for bi in range(b):
            row = [run(render, bi, v, sh[bi]) for v in range(n_all)]
            frames.append([r[0] for r in row])
            binned.append([r[1] for r in row])
        out = raster.stack_frames(frames)
        src = out
        if (hs, ws) != (h, w):
            src = {k: resize_linear(out[k] if out[k].dim() == 5 else out[k][..., None], h, w)
                   for k in ("image", "acc_map", "depth")}
            src["acc_map"] = src["acc_map"][..., 0]
        sh_f, sel = [], []
        for bi in range(b):
            idx, kept = self.select(opacity[bi])
            sh_f.append(self.fine_sh(batch, src, sur, feat_up, bi, idx, (h, w)))
            mask = torch.zeros(opacity.shape[1], dtype=torch.bool, device=rgb.device)
            mask[idx] = kept
            sel.append(mask)
        fine = [[run(lambda bi, v: render(bi, v, sh_f[bi], sel[bi], binned[bi][v])[0], bi, v)
                 for v in range(n_all)] for bi in range(b)]
        out.update({f"{k}_fine": x for k, x in raster.stack_frames(fine).items()})
        out["surfels"] = sur
        out["sh_fine"] = torch.stack(sh_f)
        out["selected"] = torch.stack(sel)
        return out
