"""Slow, exact per-pixel rasterizer backend, the counterpart of
`lara_tpu/ops/rasterizer/reference.py` (with `composite`,
`normalize_outputs` and `pixel_rays` of `lara_tpu/ops/rasterizer/blend.py`).

Every valid surfel is composited against every pixel in one global
center-depth order (a stable sort, invalid surfels last), with no dup
clamp, no tile budget and no visible budget, so it is the ground truth the
binned "cuda" backend is held to. Transmittance is log-domain, an
exclusive cumulative sum of log(1 - α), and an entry is blended while
T·(1 - α) stays at or above `transmittance_min`, the set the early-exiting
CUDA loop processes.

The JAX function composites all N surfels against a chunk of 4,096 pixels
at once; at N = 524,288 that is ~8.6 GB per [K, P] field. Here the pixels
go in chunks of `pixel_chunk` and, inside each, the depth-sorted surfels in
chunks of `surfel_chunk`, carrying per pixel the log-transmittance, the
accumulators, the median depth and the distortion's running sums (Σw,
Σw·m, Σw·m²) from chunk to chunk, so the result depends on the chunk sizes
only through f32 rounding. A pixel chunk stops taking surfel chunks once
every pixel's transmittance is below `transmittance_min`: no later entry
can then be blended. Surfels that fail the cull (invalid) contribute
nothing and are not walked.

Plain torch, differentiable by autograd, on whatever device its tensors
are on (it launches no kernel of this repository). Gradients are for test
sizes; at the flagship size it is a forward-only ground truth.
"""

from __future__ import annotations

import torch

from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.types import (ProjectedSurfels, RasterizeConfig,
                                                 RenderOutput)
from lara_tpu_torch.utils.camera import Camera

PIXEL_CHUNK = 4096
SURFEL_CHUNK = 4096


def rasterize_reference(
    means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
    pixel_chunk: int = PIXEL_CHUNK, surfel_chunk: int = SURFEL_CHUNK,
) -> RenderOutput:
    g = preprocess_surfels(means3d, shs, opacities, scales, rotations, camera, cfg)
    order = torch.argsort(torch.where(g.valid, g.depth, torch.inf), stable=True)
    order = order[:int(g.valid.sum())]          # invalid surfels sort last
    g = ProjectedSurfels(*(f[order] for f in g))

    H, W = cfg.height, cfg.width
    dev = means3d.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix_xy = torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], dim=-1)   # [P, 2]
    chunks = [composite(g, xy, pixel_rays(cfg, camera.tanfovx, camera.tanfovy, xy),
                        bg, cfg, surfel_chunk)
              for xy in torch.split(pix_xy, pixel_chunk)]
    out = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    out = normalize_outputs(out)
    return RenderOutput(
        image=out["image"].reshape(H, W, 3),
        alpha=out["alpha"].reshape(H, W),
        depth_expected=out["depth_expected"].reshape(H, W),
        depth_median=out["depth_median"].reshape(H, W),
        normal=out["normal"].reshape(H, W, 3),
        distortion=out["distortion"].reshape(H, W),
    )


def surfel_alpha(g: ProjectedSurfels, pix_xy: torch.Tensor, pix_dir: torch.Tensor,
                 cfg: RasterizeConfig):
    """Ray-surfel intersection and Gaussian falloff of K depth-sorted
    surfels over P pixels: (alpha [P, K], depth [P, K]; the JAX package's
    are [K, P], here the surfel axis is the inner one, so the prefix sums
    run along contiguous memory), the JAX package's
    `blend.surfel_alpha` (the object-space low-pass: the 3D falloff or the
    σ² = 1/2 px screen-space one, whichever is nearer, with the center
    depth where the screen-space one wins). The dot products with the rays
    are written out, so no matmul (and no TF32) is involved."""
    def dot_dir(a):                                        # [K, 3] · [P, 3] -> [P, K]
        return (pix_dir[:, 0:1] * a[:, 0] + pix_dir[:, 1:2] * a[:, 1]
                + pix_dir[:, 2:3] * a[:, 2])

    nd = dot_dir(g.normal)
    small = torch.abs(nd) < 1e-8
    t = torch.sum(g.normal * g.center_cam, dim=-1) / torch.where(small, 1e-8, nd)
    u = t * dot_dir(g.au) - torch.sum(g.au * g.center_cam, dim=-1)
    v = t * dot_dir(g.bv) - torch.sum(g.bv * g.center_cam, dim=-1)
    rho3d = torch.where(small, torch.inf, u * u + v * v)
    d2 = ((pix_xy[:, 0:1] - g.center2d[:, 0]) ** 2
          + (pix_xy[:, 1:2] - g.center2d[:, 1]) ** 2)
    rho2d = cfg.filter2d_invsq * d2
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    depth = torch.where(use3d, t, g.depth)
    alpha = torch.clamp(g.opacity * torch.exp(-0.5 * rho), max=0.99)
    keep = (alpha >= cfg.alpha_min) & (depth >= cfg.near_cull) & g.valid
    return torch.where(keep, alpha, 0.0), depth


def composite(g: ProjectedSurfels, pix_xy: torch.Tensor, pix_dir: torch.Tensor,
              bg: torch.Tensor, cfg: RasterizeConfig, surfel_chunk: int = SURFEL_CHUNK) -> dict:
    """Composite the depth-sorted surfels over P pixels, `surfel_chunk` at
    a time. Returns per-pixel maps: image [P, 3] (over `bg`), alpha [P],
    depth_expected (the unnormalized accumulator) [P], depth_median [P],
    normal [P, 3] (camera space), distortion [P]."""
    f32 = torch.float32
    n, p = g.depth.shape[0], pix_xy.shape[0]

    def zeros(*shape):
        return torch.zeros((p, *shape), dtype=f32, device=pix_xy.device)

    log_t_run, a_run, m1_run, m2_run = zeros(), zeros(), zeros(), zeros()
    image, normal = zeros(3), zeros(3)
    alpha_acc, depth_acc, depth_median, distortion = zeros(), zeros(), zeros(), zeros()
    nrm = cfg.dist_far / (cfg.dist_far - cfg.dist_near)
    for k0 in range(0, n, surfel_chunk):
        if k0 and not bool((torch.exp(log_t_run) >= cfg.transmittance_min).any()):
            break
        gc = ProjectedSurfels(*(f[k0:k0 + surfel_chunk] for f in g))
        alpha, depth = surfel_alpha(gc, pix_xy, pix_dir, cfg)           # [P, K]

        log_t = torch.log1p(-alpha)                                      # α ≤ 0.99
        cum = log_t_run[:, None] + torch.cumsum(log_t, dim=1)
        t_excl = torch.exp(cum - log_t)                  # transmittance before entry k
        # the CUDA loop stops before the entry that would take T below the
        # threshold
        live = t_excl * (1.0 - alpha) >= cfg.transmittance_min
        w = torch.where(live, alpha * t_excl, 0.0)

        alpha_acc = alpha_acc + w.sum(1)
        image = image + torch.stack([(w * gc.rgb[:, c]).sum(1) for c in range(3)], -1)
        normal = normal + torch.stack([(w * gc.normal[:, c]).sum(1) for c in range(3)], -1)
        depth_acc = depth_acc + (w * depth).sum(1)

        # median depth: the last contributing entry with T still above 0.5
        k_idx = torch.arange(alpha.shape[1], device=alpha.device)
        med_idx = torch.amax(torch.where((t_excl > 0.5) & (w > 0.0), k_idx, -1), dim=1)
        med = torch.gather(depth, 1, torch.clamp(med_idx, min=0)[:, None])[:, 0]
        depth_median = torch.where(med_idx >= 0, med, depth_median)

        # depth distortion Σ_{i<j} w_i w_j |m_i - m_j| through running moments
        m = nrm * (1.0 - cfg.dist_near / torch.clamp(depth, min=1e-6))
        m = torch.where(w > 0.0, m, 0.0)
        wm = w * m
        wm2 = wm * m
        a_excl = a_run[:, None] + (torch.cumsum(w, dim=1) - w)
        m1_excl = m1_run[:, None] + (torch.cumsum(wm, dim=1) - wm)
        m2_excl = m2_run[:, None] + (torch.cumsum(wm2, dim=1) - wm2)
        distortion = distortion + (w * (m * m * a_excl + m2_excl - 2.0 * m * m1_excl)).sum(1)

        log_t_run = cum[:, -1]
        a_run = a_run + w.sum(1)
        m1_run = m1_run + wm.sum(1)
        m2_run = m2_run + wm2.sum(1)

    return {
        "image": image + (1.0 - alpha_acc)[:, None] * bg.to(f32)[None, :],
        "alpha": alpha_acc,
        "depth_expected": depth_acc,
        "depth_median": depth_median,
        "normal": normal,
        "distortion": distortion,
    }


def normalize_outputs(out: dict) -> dict:
    """Alpha-normalize the expected depth (lightning/renderer_2dgs.py:237-239,
    nan-safe), as every backend does."""
    alpha = out["alpha"]
    out = dict(out)
    out["depth_expected"] = torch.where(
        alpha > 1e-6, out["depth_expected"] / torch.clamp(alpha, min=1e-6), 0.0)
    return out


def pixel_rays(cfg: RasterizeConfig, tanfovx, tanfovy, pix_xy: torch.Tensor) -> torch.Tensor:
    """Camera-space ray directions (z = 1) through the pixel coords [P, 2]."""
    fx = cfg.width / (2.0 * tanfovx)
    fy = cfg.height / (2.0 * tanfovy)
    dx = (pix_xy[:, 0] - cfg.width / 2.0) / fx
    dy = (pix_xy[:, 1] - cfg.height / 2.0) / fy
    return torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
