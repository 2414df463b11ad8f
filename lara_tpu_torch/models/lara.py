"""LaRa network: multi-view images → 2D Gaussian surfels → rendered views,
the counterpart of `lara_tpu/models/lara.py` (lightning/network.py:286-533)
for the serving forward and the training step (`train=True`: train raster
budgets, gradients through every render, coarse renders included).

The network runs under `torch.autocast` in `dtype` (bf16 by default, the
JAX package's working type; f32 disables autocast). Geometry, the
feature-volume sampling and the rasterizer run in f32 outside autocast.
Renders are a plain loop over scenes × views; the coarse pass keeps each
view's binning so the fine re-render skips the depth sort and window build.

Under tensor parallelism (`parallel/tp.py`) the encode prefix runs on this
rank's view rows, the volume transformer's group attention on its group
rows, and both render loops on its target views; each is gathered back
before the stage that reads all of it. With tp off those calls are the
identity.

Constants as in the reference: scene_size=0.5, opacity_shift=-2.1792,
voxel_size=2/(2·grid_reso), scaling_shift=log(0.5·voxel/3), offset half-cell
= 0.5·scene_size/n_offset_groups.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lara_tpu_torch.config import Config
from lara_tpu_torch.models.attention import MultiHeadAttention
from lara_tpu_torch.models.decoder import Decoder
from lara_tpu_torch.models.vit import DinoViT
from lara_tpu_torch.models.volume import ModLN, VolTransformer
from lara_tpu_torch.ops.grid_sample import grid_sample_2d
from lara_tpu_torch.ops.rasterizer import RasterizeConfig
from lara_tpu_torch.ops.rasterizer.api import resolve_backend
from lara_tpu_torch.ops.renderer import render_view, render_view_rebind
from lara_tpu_torch.parallel import tp
from lara_tpu_torch.utils.camera import Camera, invert_rigid, ray_to_plucker
from lara_tpu_torch.utils.sh import rsh_cart_3


def build_dense_grid(reso: int, scene_size: float, device=None) -> torch.Tensor:
    """Voxel-center grid [reso³, 3] in [-scene_size, scene_size]
    (lightning/network.py:345-349; row-major over (x, y, z) axes)."""
    ax = (torch.arange(reso, dtype=torch.float32, device=device) + 0.5) / reso * 2.0 - 1.0
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    return g.reshape(-1, 3) * scene_size


def make_cameras(c2ws: torch.Tensor, fovx, fovy, near, far) -> Camera:
    """Batched Camera from c2w poses [..., 4, 4] and per-scene scalars,
    including the campos=-c2w[:3,3] quirk of lightning/utils.py:48."""
    shape = c2ws.shape[:-2]
    return Camera(
        w2c=invert_rigid(c2ws),
        campos=-c2ws[..., :3, 3],
        tanfovx=torch.broadcast_to(torch.tan(0.5 * fovx), shape),
        tanfovy=torch.broadcast_to(torch.tan(0.5 * fovy), shape),
        near=torch.broadcast_to(near, shape),
        far=torch.broadcast_to(far, shape),
    )


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Resize [B, N, H, W, ...] maps to [B, N, h, w, ...] as
    `jax.image.resize(..., method="linear")` does: half-pixel centres, a
    triangle kernel widened by the scale when shrinking (antialiased), and
    weights renormalised at the borders."""
    b, n, hh, ww = x.shape[:4]
    rest = x.shape[4:]
    flat = x.reshape(b * n, hh, ww, -1).permute(0, 3, 1, 2)
    out = F.interpolate(flat.float(), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(b, n, h, w, *rest).to(x.dtype)


def _view(cams: Camera, b: int, v: int) -> Camera:
    return Camera(cams.w2c[b, v], cams.campos[b, v], cams.tanfovx[b, v],
                  cams.tanfovy[b, v], cams.near[b, v], cams.far[b, v])


def _stack_frames(frames):
    """[[frame dict per view] per scene] → dict of [B, N, ...] tensors."""
    return {k: torch.stack([torch.stack([f[k] for f in row]) for row in frames])
            for k in frames[0][0]}


class LaRaNet(nn.Module):
    """Parameters are f32 and named as the reference's state dict
    (img_encoder.model.*, dir_norm, view_embed, vol_decoder, decoder). They
    are drawn from `generator` (a CPU torch.Generator; seed 0 by default)
    and then placed on `device`: the CUDA device unless the caller asks for
    another (the tests pass device="cpu"); without a CUDA device the
    default raises instead of building on the CPU."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LaRaNet builds on the CUDA device, and none is available; "
                               "pass device='cpu' to build it on the CPU")
        self.cfg, self.dtype = cfg, dtype
        m = cfg.model
        with torch.device("meta"):
            # flash attention in the ViT only, as lara_tpu/models/lara.py:70
            self.img_encoder = DinoViT(m.encoder_dim, m.encoder_depth,
                                       m.encoder_heads, m.patch_size, remat=m.remat,
                                       remat_policy=m.remat_policy, use_flash=m.flash_attn)
            self.dir_norm = ModLN(m.encoder_dim, 32)
            self.view_embed = (nn.Parameter(torch.empty(1, 4, m.view_embed_dim, 1, 1, 1))
                               if m.view_embed_dim > 0 else None)
            self.vol_decoder = VolTransformer(
                m.embedding_dim, m.encoder_dim + m.view_embed_dim, m.n_groups,
                m.vol_embedding_reso, m.vol_embedding_out_dim, m.num_layers,
                m.num_heads, remat=m.remat, remat_policy=m.remat_policy)
            self.sh_dim = (m.sh_degree + 1) ** 2 * 3
            self.decoder = Decoder(m.vol_embedding_out_dim, self.sh_dim, m.K)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)
        self.to(device)

        self.opacity_shift = -2.1792
        self.voxel_size = 2.0 / (m.vol_embedding_reso * 2)
        self.scaling_shift = math.log(0.5 * self.voxel_size / 3.0)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialize every parameter as the JAX package does: xavier-uniform
        Linear/attention weights, lecun-normal convolutions, zero biases,
        unit LayerNorms, normal position/view embeddings."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        done = set()

        def init(p, fn):
            fn(p)
            done.add(id(p))

        xavier = lambda p: nn.init.xavier_uniform_(p, generator=generator)  # noqa: E731
        zero = lambda p: p.zero_()  # noqa: E731

        def normal(std):
            return lambda p: p.normal_(0.0, std, generator=generator)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init(mod.weight, xavier)
            elif isinstance(mod, MultiHeadAttention):
                for p in (mod.q_proj_weight, mod.k_proj_weight, mod.v_proj_weight):
                    init(p, xavier)
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                w = mod.weight
                fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose3d)
                          else w.shape[1]) * math.prod(w.shape[2:])
                init(w, normal(fan_in ** -0.5))
            elif isinstance(mod, nn.LayerNorm):
                init(mod.weight, lambda p: p.fill_(1.0))
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                                nn.LayerNorm)) and mod.bias is not None:
                init(mod.bias, zero)
        m = self.cfg.model
        vit = self.img_encoder.model
        init(vit.cls_token, zero)
        init(vit.pos_embed, normal(0.02))
        if self.view_embed is not None:
            init(self.view_embed, normal(m.view_embed_dim ** -0.5))
        init(self.vol_decoder.pos_embed, normal(m.embedding_dim ** -0.5))
        missed = [n for n, p in self.named_parameters() if id(p) not in done]
        if missed:
            raise RuntimeError(f"parameters without an initializer: {missed}")

    def _autocast(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        dev = next(self.parameters()).device
        return torch.autocast(device_type=dev.type, dtype=self.dtype)

    def _render_cfg(self, H: int, W: int, train: bool) -> RasterizeConfig:
        r = self.cfg.render
        budget = r.tile_budget if train else r.eval_tile_budget
        return RasterizeConfig(
            height=H, width=W, tile=r.tile, dup=r.dup, tile_budget=budget,
            sh_degree=self.cfg.model.sh_degree,
            visible_budget=r.visible_budget if train else r.eval_visible_budget,
            pallas_chunk=min(r.pallas_chunk, budget),
            stash_carries=r.pallas_stash_carries, bin_mode=r.bin_mode,
            pack_mode=r.pack_mode, backend=resolve_backend(r.backend))

    def encode_images(self, imgs: torch.Tensor, rays_down: torch.Tensor) -> torch.Tensor:
        """imgs [BV, H, W, 3], rays_down [BV, h, w, 6] (h = H/16) →
        direction-modulated feature maps [BV, h, w, C]
        (lightning/network.py:443-445 + 362-371)."""
        bv, h, w, _ = imgs.shape
        p = self.cfg.model.patch_size
        with self._autocast():
            tokens = self.img_encoder(imgs)                  # [BV, L, C]
            feats = tokens.reshape(bv, h // p, w // p, -1)
            plucker = ray_to_plucker(rays_down)
            dir_feat = torch.cat([rsh_cart_3(plucker[..., :3]),
                                  rsh_cart_3(plucker[..., 3:6])], dim=-1)
            return self.dir_norm(feats, dir_feat)

    def build_feat_vol(self, feats: torch.Tensor, w2cs: torch.Tensor,
                       ixts: torch.Tensor, img_hw) -> torch.Tensor:
        """Sample per-view features at projected voxel centers
        (lightning/network.py:352-379). feats [BV, th, tw, C] →
        [BV, D, D, D, C] with D = vol_feat_reso."""
        reso = self.cfg.model.vol_feat_reso
        grid_pts = build_dense_grid(reso, self.cfg.model.scene_size, feats.device)
        h, w = img_hw
        wh = torch.tensor([w, h], dtype=torch.float32, device=feats.device)
        sampled = []
        for feat_hw, w2c, ixt in zip(feats, w2cs, ixts):
            cam = grid_pts @ w2c[:3, :3].T + w2c[:3, 3]
            img = cam @ ixt.T
            xy = img[:, :2] / img[:, 2:3]
            gridc = (xy + 0.5) / wh * 2.0 - 1.0
            sampled.append(grid_sample_2d(feat_hw.float().permute(2, 0, 1), gridc))
        sampled = torch.stack(sampled)                       # [BV, P, C]
        return sampled.reshape(sampled.shape[0], reso, reso, reso, -1).to(feats.dtype)

    def forward(self, batch: Dict, with_fine: bool = False, train: bool = False,
                return_buffer: bool = False, render_scale: float = 1.0,
                n_views_sel: Optional[int] = None) -> Dict:
        """batch follows the reference schema (tensors on the model's
        device); returns per-view maps stacked as [B, N, H', W', ...] plus
        `_fine` variants when with_fine.

        `render_scale` renders the output maps at round(H·s) snapped to the
        tile grid (the reference's `render_img_scale`,
        lightning/network.py:467,477): the rays are resized linearly, as
        `jax.image.resize(..., "linear")` does; the encoder and the fine
        stage's feature sampling stay at the native resolution.

        use_rand_views (lightning/network.py:434-438), two ways:
          - `n_views_sel`: only the first n_views_sel input views are
            encoded (the dataset shuffles view order, so a prefix is a
            uniform random subset);
          - batch["view_mask"] (legacy): encode all n_views and leave the
            dropped views' tokens out of every cross-attention.
        """
        m = self.cfg.model
        tar_rgb = batch["tar_rgb"]
        B, N, H, W, _ = tar_rgb.shape
        n_in = self.cfg.n_views
        if n_views_sel is not None:
            if not 1 <= n_views_sel <= n_in:
                raise ValueError(f"n_views_sel={n_views_sel} is outside 1..{n_in}")
            n_in = n_views_sel
        if not render_scale > 0:
            raise ValueError(f"render_scale must be positive, got {render_scale}")
        view_mask = batch.get("view_mask")
        if view_mask is not None:
            view_mask = view_mask.to(torch.bool).reshape(-1, n_in)[:1].expand(B, n_in)

        # the encode prefix is per view: tp splits its B·n_in rows
        imgs = tp.shard_views(tar_rgb[:, :n_in].reshape(B * n_in, H, W, 3))
        rays_down = batch["tar_rays_down"][:, :n_in]
        feats = self.encode_images(
            imgs, tp.shard_views(rays_down.reshape(B * n_in, *rays_down.shape[2:])))
        w2cs = tp.shard_views(batch["tar_w2c"][:, :n_in].reshape(-1, 4, 4))
        ixts = tp.shard_views(batch["tar_ixt"][:, :n_in].reshape(-1, 3, 3))
        reso = m.vol_feat_reso
        feat_vol = self.build_feat_vol(feats, w2cs, ixts, (H, W))
        # cross-view from here (the volume transformer groups the views)
        feat_vol = tp.shard_batch_dim(feat_vol, B * n_in)
        feat_vol = feat_vol.reshape(B, n_in, reso, reso, reso, -1)
        if self.view_embed is not None:
            ve = self.view_embed[0, :n_in, :, 0, 0, 0]       # [n_in, C]
            ve = ve[None, :, None, None, None, :].expand(
                B, n_in, reso, reso, reso, -1).to(feat_vol.dtype)
            feat_vol = torch.cat([feat_vol, ve], dim=-1)

        with self._autocast():
            volume = self.vol_decoder(feat_vol, view_mask)   # [B, 2R, 2R, 2R, out]
            volume_feat_up = volume.reshape(B, -1, m.vol_embedding_out_dim)
            offset, sh_c, scaling_c, rotation_c, opacity_c = self.decoder.forward_coarse(
                volume_feat_up, self.opacity_shift, self.scaling_shift)

        # offsets live inside their voxel cell (lightning/network.py:425-429);
        # voxel v owns surfel rows v*K .. v*K+K-1
        group_centers = build_dense_grid(m.vol_embedding_reso * 2, m.scene_size,
                                         tar_rgb.device)
        half_cell = 0.5 * m.scene_size / m.n_offset_groups
        centers_c = (group_centers[None, :, None, :]
                     + offset.reshape(B, -1, m.K, 3) * half_cell).reshape(B, -1, 3)

        cams = make_cameras(batch["tar_c2w"], batch["fovx"][:, None],
                            batch["fovy"][:, None], batch["near_far"][:, None, 0],
                            batch["near_far"][:, None, 1])
        rays_full = batch["tar_rays"]
        if render_scale != 1.0:
            tile = self.cfg.render.tile
            Hs = max(tile, int(round(H * render_scale / tile)) * tile)
            Ws = max(tile, int(round(W * render_scale / tile)) * tile)
            rays_full = resize_linear(rays_full, Hs, Ws)
        else:
            Hs, Ws = H, W
        rcfg = self._render_cfg(Hs, Ws, train)
        bg = batch["bg_color"].float()

        # coarse renders of this rank's views (all N with tp off); with the
        # fine stage, keep each view's binning on the rank that made it
        views = tp.view_shard(N)
        frames, binned = [], []
        for b in range(B):
            res = [render_view(
                _view(cams, b, v), rays_full[b, v], centers_c[b], sh_c[b],
                opacity_c[b], scaling_c[b], rotation_c[b], bg[b, v], rcfg,
                return_binned=with_fine) for v in views]
            frames.append([r[0] for r in res] if with_fine else res)
            binned.append([r[1] for r in res] if with_fine else None)
        # the fine stage and the loss read every view
        outputs = tp.gather_views(_stack_frames(frames), N)
        buffers = {"coarse": (centers_c, sh_c, opacity_c, scaling_c, rotation_c)}

        if with_fine:
            fine_src = outputs
            if (Hs, Ws) != (H, W):
                # the fine stage samples the coarse renders on the native
                # image grid, beside the reference RGB
                fine_src = {k: resize_linear(outputs[k], H, W)
                            for k in ("image", "acc_map", "depth")}
            sh_fine, sel_mask = self._fine_stage(
                batch, fine_src, volume_feat_up, centers_c, sh_c, opacity_c,
                n_in, (H, W), view_mask)
            frames_f = [[render_view_rebind(
                _view(cams, b, v), rays_full[b, v], binned[b][i], centers_c[b],
                sh_fine[b], opacity_c[b], sel_mask[b], scaling_c[b],
                rotation_c[b], bg[b, v], rcfg) for i, v in enumerate(views)]
                for b in range(B)]
            fine = tp.gather_views(_stack_frames(frames_f), N)
            outputs.update({f"{k}_fine": v for k, v in fine.items()})
            # full-set fine surfels, deselected ones disabled with the
            # reference's -1e4 opacity logit
            op_f = torch.where(sel_mask[..., None], opacity_c, -1e4)
            buffers["fine"] = (centers_c, sh_fine, op_f, scaling_c, rotation_c)
        if return_buffer:
            outputs["render_pkg"] = buffers
        return outputs

    def _fine_stage(self, batch, coarse_out, volume_feat_up, centers, sh_c,
                    opacity_c, n_in: int, img_hw, view_mask=None):
        """Static-budget fine refinement (lightning/network.py:502-525):
        select the top-`fine_budget` surfels by coarse opacity, sample
        per-view point features from the coarse renders, predict an SH
        residual and add it back onto the full surfel set. Returns
        (sh_fine [B,P,SH,3], sel_mask [B,P] bool). view_mask [B, n_in]
        leaves the deselected views out of the fine decoder's attention
        (all scenes share scene 0's mask, as in the JAX package)."""
        m = self.cfg.model
        M = min(m.fine_budget, centers.shape[1])
        h, w = img_hw
        wh = torch.tensor([w, h], dtype=torch.float32, device=centers.device)
        # the selection is integer state: no gradient through the score
        # (stop_gradient in the JAX package)
        op_act = torch.sigmoid(opacity_c[..., 0].detach())
        score = torch.where(op_act > 0.005, op_act, -1.0)

        sh_out, masks = [], []
        for b in range(centers.shape[0]):
            # torch.topk may order equal scores unlike lax.top_k; the ties
            # that occur are at the -1 floor, and those entries are
            # deselected (vals <= 0), so the rendered set is the same
            vals, idx = torch.topk(score[b], M)
            c_sel = centers[b][idx]
            vol_sel = volume_feat_up[b][idx // m.K]     # K surfels per voxel
            pf = []
            for v in range(n_in):
                w2c, ixt = batch["tar_w2c"][b, v], batch["tar_ixt"][b, v]
                cam = c_sel @ w2c[:3, :3].T + w2c[:3, 3]
                img = cam @ ixt.T
                z = img[:, 2]
                gridc = (img[:, :2] / z[:, None] + 0.5) / wh * 2.0 - 1.0
                # channels: ref rgb(3) + coarse rgb(3) + acc(1) + depth(1)
                stack = torch.cat([batch["tar_rgb"][b, v].float(),
                                   coarse_out["image"][b, v],
                                   coarse_out["acc_map"][b, v][..., None],
                                   coarse_out["depth"][b, v]], dim=-1)
                samp = grid_sample_2d(stack.permute(2, 0, 1), gridc)
                zdiff = torch.abs(samp[:, -1] - z)
                pf.append(torch.cat([samp[:, :-1], zdiff[:, None]], dim=-1))
            pf = torch.stack(pf, dim=1)                      # [M, V, 8]
            with self._autocast():
                sh_res = self.decoder.forward_fine(
                    vol_sel, pf, None if view_mask is None else view_mask[0])
            sh_out.append(sh_c[b].index_add(
                0, idx, sh_res.reshape(M, self.sh_dim // 3, 3).to(sh_c.dtype)))
            mask = torch.zeros(centers.shape[1], dtype=torch.bool, device=centers.device)
            mask[idx] = vals > 0.0
            masks.append(mask)
        return torch.stack(sh_out), torch.stack(masks)
