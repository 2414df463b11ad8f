"""Surfel renderer: parameter activations + auxiliary-map post-processing,
the counterpart of `lara_tpu/ops/renderer.py` (the reference `Renderer`,
lightning/renderer_2dgs.py:91-268). The rasterizer runs in f32."""

from __future__ import annotations

from typing import Optional

import torch

from lara_tpu_torch.ops.rasterizer import (RasterizeConfig, rasterize,
                                           rasterize_and_bin, rasterize_rebind)
from lara_tpu_torch.utils.camera import Camera, depth_to_normal
from lara_tpu_torch.utils.quat import normalize as l2_normalize
from lara_tpu_torch.utils.trace import span, spanned


def opacity_activation(x):
    # torch.sigmoid is stable at the -1e4 logits the fine stage uses
    return torch.sigmoid(x.to(torch.float32))


def scaling_activation(x):
    return torch.exp(x.to(torch.float32))


def rotation_activation(x):
    return l2_normalize(x.to(torch.float32))


@spanned("raster.render")
def render_view(
    camera: Camera,
    rays: Optional[torch.Tensor],   # [H, W, 6] world rays for depth->normal; None to skip
    centers: torch.Tensor,          # [N, 3]
    shs: torch.Tensor,              # [N, SH, 3]
    opacity_raw: torch.Tensor,      # [N] or [N,1] pre-sigmoid
    scaling_raw: torch.Tensor,      # [N, 2] pre-exp
    rotation_raw: torch.Tensor,     # [N, 4] unnormalized quaternion
    bg_color: torch.Tensor,         # [3]
    cfg: RasterizeConfig,
    depth_ratio: float = 0.0,
    return_binned: bool = False,
):
    """Render one view; returns the reference frame dict
    (lightning/renderer_2dgs.py:258-268): image / depth / acc_map /
    rend_normal / rend_dist (/ depth_normal), all [H, W, ...]. With
    return_binned, also the view's binning for `render_view_rebind`."""
    f32 = torch.float32
    with span("raster.preprocess"):
        args = (centers.to(f32), shs.to(f32),
                opacity_activation(opacity_raw.reshape(-1)),
                scaling_activation(scaling_raw), rotation_activation(rotation_raw),
                camera, bg_color.to(f32), cfg)
    binned = None
    if return_binned:
        out, binned = rasterize_and_bin(*args)
    else:
        out = rasterize(*args)
    with span("raster.post"):
        frame = _postprocess(out, camera, rays, depth_ratio)
    return (frame, binned) if return_binned else frame


def _postprocess(out, camera: Camera, rays, depth_ratio: float):
    """Auxiliary maps shared by first renders and re-renders
    (lightning/renderer_2dgs.py:226-254)."""
    # camera → world normal (row vectors @ w2c[:3,:3] ≡ R_c2w · n)
    rend_normal = out.normal @ camera.w2c[:3, :3]
    surf_depth = out.depth_expected * (1.0 - depth_ratio) + depth_ratio * out.depth_median
    frame = {
        "image": torch.clamp(out.image, 0.0, 1.0),
        "depth": surf_depth[..., None],
        "acc_map": out.alpha,
        "rend_normal": rend_normal,
        "rend_dist": out.distortion,
    }
    if rays is not None:
        # finite-difference surface normal, alpha-masked with the alpha
        # detached as the reference's `surf_normal * render_alpha.detach()`
        # (renderer_2dgs.py:254): the normal-consistency loss gets no
        # gradient path through the opacity accumulator
        dn, _ = depth_to_normal(rays, surf_depth)
        frame["depth_normal"] = dn * out.alpha.detach()[..., None]
    return frame


@spanned("raster.rerender")
def render_view_rebind(
    camera: Camera,
    rays: Optional[torch.Tensor],
    binned,                         # BinnedView from render_view(return_binned);
                                    # None on the reference backend (re-rasterizes)
    centers: torch.Tensor,          # [N, 3] — SAME geometry as the first render
    shs: torch.Tensor,              # [N, SH, 3] updated coefficients
    opacity_raw: torch.Tensor,      # [N] or [N,1] pre-sigmoid (original)
    keep_mask: torch.Tensor,        # [N] bool — False entries render as absent
    scaling_raw: torch.Tensor,
    rotation_raw: torch.Tensor,
    bg_color: torch.Tensor,
    cfg: RasterizeConfig,
    depth_ratio: float = 0.0,
):
    """Re-render a view whose geometry is unchanged but whose SH and
    opacity mask differ — the LaRa fine stage
    (lightning/network.py:502-525); `keep_mask` reproduces the reference's
    -1e4-logit disabling of deselected surfels."""
    f32 = torch.float32
    with span("raster.preprocess"):
        opacity = torch.where(keep_mask, opacity_activation(opacity_raw.reshape(-1)), 0.0)
        args = (centers.to(f32), shs.to(f32), opacity,
                scaling_activation(scaling_raw), rotation_activation(rotation_raw),
                camera, bg_color.to(f32), cfg)
    out = rasterize_rebind(binned, *args)
    with span("raster.post"):
        return _postprocess(out, camera, rays, depth_ratio)
