"""Public rasterizer entry points, the counterpart of
`lara_tpu/ops/rasterizer/api.py`. The port has one backend, "cuda": the
torch preprocess + binning and the hand-written blend kernel."""

from __future__ import annotations

import torch

from lara_tpu_torch.ops.rasterizer.cuda import blend_binned_cuda, rasterize_cuda
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import BinnedView, repack_from_binned
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig, RenderOutput
from lara_tpu_torch.utils.camera import Camera


def resolve_backend(backend: str) -> str:
    """Map a config's backend name to the port's one backend. "auto" and
    "pallas" (the JAX package's kernel backend) both mean the CUDA kernel;
    the JAX package's "tiled" and "reference" formulations are not ported."""
    if backend in ("auto", "cuda", "pallas"):
        return "cuda"
    raise ValueError(f"rasterizer backend {backend!r} is not available in "
                     "lara_tpu_torch (use 'auto' or 'cuda')")


def rasterize(
    means3d: torch.Tensor,    # [N, 3] world-space surfel centers
    shs: torch.Tensor,        # [N, (deg+1)^2, 3] SH coefficients
    opacities: torch.Tensor,  # [N] activated opacities (sigmoid applied)
    scales: torch.Tensor,     # [N, 2] activated tangent scales (exp applied)
    rotations: torch.Tensor,  # [N, 4] quaternions (w,x,y,z)
    camera: Camera,
    bg: torch.Tensor,         # [3] background color
    cfg: RasterizeConfig,
) -> RenderOutput:
    """2D Gaussian surfel rasterization of one view (the reference's
    `GaussianRasterizer`, lightning/renderer_2dgs.py:209-218)."""
    return rasterize_cuda(means3d, shs, opacities, scales, rotations, camera, bg, cfg)


def rasterize_and_bin(
    means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
):
    """`rasterize` that also returns the view's binning for re-renders."""
    return rasterize_cuda(means3d, shs, opacities, scales, rotations, camera,
                          bg, cfg, return_binned=True)


def rasterize_rebind(
    binned: BinnedView, means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
) -> RenderOutput:
    """Re-render the SAME geometry as the `rasterize_and_bin` call that made
    `binned`, with new SH coefficients / opacities: preprocess + the pack
    (one row gather, or elementwise with pack_mode "fused"), then the blend
    through the cached tile windows. `opacities` are
    activated; entries the caller disabled must be exactly 0."""
    g = preprocess_surfels(means3d, shs, opacities, scales, rotations, camera, cfg)
    packed = repack_from_binned(g, binned, cfg)
    return blend_binned_cuda(packed, binned, camera, bg, cfg)
