"""Tile-based 2D Gaussian surfel (2DGS) rasterizer for an NVIDIA GPU, the
counterpart of `lara_tpu.ops.rasterizer`:

  1. preprocess — per-surfel camera transform, ray-space axes, SH→RGB,
                  screen bounds, frustum cull (torch);
  2. binning    — stable depth sort, fixed dup×dup tile fan-out, one key
                  sort, per-tile windows (torch);
  3. blending   — the hand-written CUDA kernel `csrc/blend_fwd.cu`.
"""

from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig, RenderOutput
from lara_tpu_torch.ops.rasterizer.api import (rasterize, rasterize_and_bin,
                                               rasterize_rebind)

__all__ = ["RasterizeConfig", "RenderOutput", "rasterize",
           "rasterize_and_bin", "rasterize_rebind"]
