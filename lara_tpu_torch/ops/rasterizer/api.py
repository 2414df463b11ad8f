"""Public rasterizer entry points with backend dispatch, the counterpart of
`lara_tpu/ops/rasterizer/api.py`. Two backends: "cuda", the torch
preprocess + binning and the hand-written blend kernel, and "reference",
every surfel composited against every pixel (`reference.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from lara_tpu_torch.ops.rasterizer.cuda import blend_binned_cuda, rasterize_cuda
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.reference import rasterize_reference
from lara_tpu_torch.ops.rasterizer.tiled import BinnedView, repack_from_binned
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig, RenderOutput
from lara_tpu_torch.utils.camera import Camera


def resolve_backend(backend: str) -> str:
    """Map a config's backend name to the port's RasterizeConfig.backend.
    "auto" and "pallas" (the JAX package's kernel backend) mean the CUDA
    kernel; "reference" is the reference. The JAX package's "tiled" is its
    XLA formulation of the binned blend: the port's counterpart is the
    blend's plain version, which runs only for CPU tensors, so it is no
    backend here."""
    if backend in ("auto", "cuda", "pallas"):
        return "cuda"
    if backend == "reference":
        return "reference"
    if backend == "tiled":
        raise ValueError(
            "rasterizer backend 'tiled' is the JAX package's XLA formulation of the "
            "binned blend; the port's counterpart is the blend kernel's plain version, "
            "which runs only for CPU tensors (blend_tiles does so there by itself): "
            "use 'cuda' (or 'auto') for the binned path, 'reference' for the exact one")
    raise ValueError(f"unknown rasterizer backend {backend!r} "
                     "(lara_tpu_torch takes 'auto', 'cuda', 'pallas' or 'reference')")


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
    if cfg.backend == "reference":
        return rasterize_reference(means3d, shs, opacities, scales, rotations, camera, bg, cfg)
    return rasterize_cuda(means3d, shs, opacities, scales, rotations, camera, bg, cfg)


def rasterize_and_bin(
    means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
):
    """`rasterize` that also returns the view's binning for re-renders
    (None on the reference backend, which has no binning)."""
    if cfg.backend == "reference":
        return rasterize(means3d, shs, opacities, scales, rotations, camera, bg, cfg), None
    return rasterize_cuda(means3d, shs, opacities, scales, rotations, camera,
                          bg, cfg, return_binned=True)


def rasterize_rebind(
    binned: Optional[BinnedView], means3d, shs, opacities, scales, rotations,
    camera: Camera, bg: torch.Tensor, cfg: RasterizeConfig,
) -> RenderOutput:
    """Re-render the SAME geometry as the `rasterize_and_bin` call that made
    `binned`, with new SH coefficients / opacities: preprocess + the pack
    (one row gather, or elementwise with pack_mode "fused"), then the blend
    through the cached tile windows. Without a binning (the reference
    backend) it rasterizes again. `opacities` are activated; entries the
    caller disabled must be exactly 0."""
    if binned is None or cfg.backend == "reference":
        return rasterize(means3d, shs, opacities, scales, rotations, camera, bg, cfg)
    g = preprocess_surfels(means3d, shs, opacities, scales, rotations, camera, cfg)
    packed = repack_from_binned(g, binned, cfg)
    return blend_binned_cuda(packed, binned, camera, bg, cfg)
