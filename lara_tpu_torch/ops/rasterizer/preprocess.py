"""Per-surfel preprocessing: camera transform, screen bounds, SH color —
the counterpart of `lara_tpu/ops/rasterizer/preprocess.py` (the CUDA
rasterizer's preprocess stage, SURVEY.md §2.3 step 1)."""

from __future__ import annotations

import math

import torch

from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels, RasterizeConfig
from lara_tpu_torch.utils.camera import Camera
from lara_tpu_torch.utils.quat import quat_to_rotmat
from lara_tpu_torch.utils.sh import eval_sh_color


def preprocess_surfels(
    means3d: torch.Tensor,    # [N, 3] world centers
    shs: torch.Tensor,        # [N, (deg+1)^2, 3]
    opacities: torch.Tensor,  # [N] activated (sigmoid applied)
    scales: torch.Tensor,     # [N, 2] activated (exp applied)
    rotations: torch.Tensor,  # [N, 4] quaternions (w,x,y,z), any norm
    camera: Camera,
    cfg: RasterizeConfig,
    return_overflow: bool = False,
):
    """With return_overflow, also returns the fraction of valid surfels
    whose unclamped footprint exceeds cfg.max_radius: those lose coverage
    (and gradient) outside their dup×dup tile ring."""
    f32 = torch.float32
    means3d = means3d.to(f32)
    scales = scales.to(f32)

    R_w = quat_to_rotmat(rotations.to(f32))                 # [N,3,3]
    R_wc = camera.w2c[:3, :3].to(f32)
    t_wc = camera.w2c[:3, 3].to(f32)

    center_cam = means3d @ R_wc.T + t_wc                    # [N,3]
    axes_cam = R_wc @ R_w                                   # [N,3,3]
    unit_u, unit_v, normal = axes_cam[..., 0], axes_cam[..., 1], axes_cam[..., 2]

    s_u = torch.clamp(scales[:, 0], min=1e-8)
    s_v = torch.clamp(scales[:, 1], min=1e-8)
    # offsets dotted with au/bv land directly in σ units of the splat frame
    au = unit_u / s_u[:, None]
    bv = unit_v / s_v[:, None]

    # flip the normal toward the camera (2DGS convention: sign of -dot(p, n))
    cosang = -torch.sum(center_cam * normal, dim=-1)
    normal = normal * torch.where(cosang >= 0, 1.0, -1.0)[:, None]

    # screen projection (pixel centers at u+0.5 ⇔ principal point at W/2)
    z = center_cam[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    fx = cfg.width / (2.0 * camera.tanfovx)
    fy = cfg.height / (2.0 * camera.tanfovy)
    cx2d = fx * center_cam[:, 0] / z_safe + cfg.width / 2.0
    cy2d = fy * center_cam[:, 1] / z_safe + cfg.height / 2.0
    center2d = torch.stack([cx2d, cy2d], dim=-1)

    def _proj(p):  # [N,3] camera space -> [N,2] pixels
        pz = torch.clamp(p[:, 2], min=1e-3)
        return torch.stack([fx * p[:, 0] / pz + cfg.width / 2.0,
                            fy * p[:, 1] / pz + cfg.height / 2.0], dim=-1)

    # Opacity-aware cutoff: a pixel beyond σ·sqrt(2·ln(op/alpha_min)) can
    # never pass the blend's α ≥ alpha_min test, so the claimed footprint is
    # min(3σ, that cutoff).
    op_clamped = torch.clamp(opacities, cfg.alpha_min, 0.99)
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(op_clamped / cfg.alpha_min), min=0.0))
    cut = torch.clamp(cut, max=3.0)

    ext = torch.zeros_like(z)
    for axis, s in ((unit_u, s_u), (unit_v, s_v)):
        off = (cut * s)[:, None] * axis
        for sgn in (1.0, -1.0):
            d = torch.abs(_proj(center_cam + sgn * off) - center2d)
            ext = torch.maximum(ext, torch.maximum(d[:, 0], d[:, 1]))
    filter_r = cut / math.sqrt(cfg.filter2d_invsq)
    # dup clamp: the fixed dup×dup tile fan-out must cover the footprint
    radius_unclamped = ext + filter_r
    radius = torch.clamp(radius_unclamped, max=cfg.max_radius)

    # view-dependent color from the direction to `campos`
    viewdir = means3d - camera.campos.to(f32)
    viewdir = viewdir / torch.clamp(
        torch.linalg.vector_norm(viewdir, dim=-1, keepdim=True), min=1e-12)
    rgb = eval_sh_color(shs.to(f32), viewdir, cfg.sh_degree)

    # frustum cull: behind the near plane or with an off-screen footprint
    margin = cfg.max_radius
    on_screen = ((cx2d > -margin) & (cx2d < cfg.width + margin)
                 & (cy2d > -margin) & (cy2d < cfg.height + margin))
    valid = (z > cfg.near_cull) & on_screen & (opacities > cfg.alpha_min)

    g = ProjectedSurfels(
        center_cam=center_cam, au=au, bv=bv, normal=normal, rgb=rgb,
        opacity=opacities.to(f32), depth=z, center2d=center2d,
        radius=radius, valid=valid)
    if return_overflow:
        n_valid = torch.clamp(valid.to(f32).sum(), min=1.0)
        overflow = (valid & (radius_unclamped > cfg.max_radius)).to(f32).sum() / n_valid
        return g, overflow
    return g
