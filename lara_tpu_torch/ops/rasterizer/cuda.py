"""CUDA rasterizer backend: torch preprocess/binning + the blend kernel —
the counterpart of `lara_tpu/ops/rasterizer/pallas.py`.

`rasterize_cuda(..., return_binned=True)` also returns the per-view
`BinnedView`, and `blend_binned_cuda` re-composites it with new colors: the
fine-stage re-render (same geometry, new SH) skips the depth sort and the
window construction.
"""

from __future__ import annotations

import torch

from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import BinnedView, bin_view
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig, RenderOutput
from lara_tpu_torch.utils.camera import Camera
from lara_tpu_torch.utils.trace import span


def rasterize_cuda(
    means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
    return_binned: bool = False,
):
    if cfg.tile_budget % cfg.pallas_chunk:
        raise ValueError("tile_budget must be a multiple of pallas_chunk")
    with span("raster.preprocess"):
        g = preprocess_surfels(means3d, shs, opacities, scales, rotations, camera, cfg)
    with span("raster.bin"):
        packed, binned = bin_view(g, cfg)
    out = blend_binned_cuda(packed, binned, camera, bg, cfg)
    return (out, binned) if return_binned else out


def blend_binned_cuda(
    packed: torch.Tensor, binned: BinnedView,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
) -> RenderOutput:
    """Composite from an existing binning (packed from `bin_view` for the
    first render, or `repack_from_binned` for a re-render)."""
    with span("raster.gather"):
        entries = window_gather(packed, binned.win_gidx, binned.entry_valid,
                                binned.slot_pos)                  # [T, K, 13]
    # tan fov stays on the device: no host sync per render
    scalars = torch.stack([camera.tanfovx, camera.tanfovy]).to(torch.float32)
    out = cuda_blend.blend_tiles(entries, binned.counts, scalars, cfg)  # [T, C, P]

    tile = cfg.tile

    def to_image(a):  # [T, P, ...] -> [H, W, ...]
        ch = a.shape[2:]
        a = a.reshape(cfg.tiles_y, cfg.tiles_x, tile, tile, *ch)
        return a.transpose(1, 2).reshape(cfg.height, cfg.width, *ch)

    with span("raster.post"):
        chans = out.transpose(1, 2)                               # [T, P, C]
        alpha = to_image(chans[..., 3])
        image = to_image(chans[..., 0:3]) + (1.0 - alpha)[..., None] * bg.to(torch.float32)
        dsum = to_image(chans[..., 4])
        depth_expected = torch.where(alpha > 1e-6, dsum / torch.clamp(alpha, min=1e-6), 0.0)
        return RenderOutput(
            image=image,
            alpha=alpha,
            depth_expected=depth_expected,
            depth_median=to_image(chans[..., 5]),
            normal=to_image(chans[..., 6:9]),
            distortion=to_image(chans[..., 9]),
        )
