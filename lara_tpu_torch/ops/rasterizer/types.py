"""Static configuration and output types for the 2DGS rasterizer, the
counterpart of `lara_tpu/ops/rasterizer/types.py`."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterizer configuration: the fields of the JAX package's
    RasterizeConfig that the port's backends read.

    height/width: output image extent in pixels (multiples of `tile`).
    tile:        square tile edge in pixels (16 → 256 px per tile); the CUDA
                 blend kernels run 8, 16 and 32 natively (two pixels per
                 thread) and any other edge as sub-tiles of one of them.
    dup:         each surfel claims up to dup×dup tiles; its screen radius
                 is clamped to (dup-1)*tile/2 px.
    tile_budget: max depth-sorted entries composited per tile.
    visible_budget: only the nearest `visible_budget` valid surfels are
                 binned (0 keeps all).
    pallas_chunk: entries the blend kernel stages in shared memory per step;
                 must divide `tile_budget`.
    alpha_min / transmittance_min / near_cull: culling thresholds of the
                 upstream 2DGS CUDA kernels (1/255, 1e-4, 0.2).
    dist_near / dist_far: depth-normalization range of the distortion
                 accumulator.
    filter2d_invsq: inverse variance of the screen-space low-pass filter.
    stash_carries: training renders keep the forward's per-chunk carries
                 for the backward (True), or the backward replays each
                 tile's forward walk (False; RenderConfig's
                 pallas_stash_carries).
    bin_mode:    tile-window construction, "sort" (one key sort +
                 searchsorted) or "count" (a prefix-sum counting sort);
                 both give the same windows.
    pack_mode:   "gather" (pack the kept surfels' rows in depth order) or
                 "fused" (sort binning only: the pack stays elementwise
                 and the windows hold original surfel ids).
    backend:     "cuda" (binning + the blend kernels) or "reference" (every
                 surfel against every pixel, `reference.py`: no dup clamp,
                 no budgets; the binned path's ground truth).
    """

    height: int = 512
    width: int = 512
    tile: int = 16
    dup: int = 3
    tile_budget: int = 256
    sh_degree: int = 1
    visible_budget: int = 0
    pallas_chunk: int = 32
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    near_cull: float = 0.2
    dist_near: float = 0.2
    dist_far: float = 100.0
    filter2d_invsq: float = 2.0
    stash_carries: bool = True
    bin_mode: str = "sort"
    pack_mode: str = "gather"
    backend: str = "cuda"

    def __post_init__(self):
        if self.height % self.tile or self.width % self.tile:
            raise ValueError("image extent must be a multiple of the tile size")
        if self.bin_mode not in ("sort", "count"):
            raise ValueError(f"bin_mode must be 'sort' or 'count', got {self.bin_mode!r}")
        if self.pack_mode not in ("gather", "fused"):
            raise ValueError(f"pack_mode must be 'gather' or 'fused', got {self.pack_mode!r}")
        if self.backend not in ("cuda", "reference"):
            raise ValueError(f"backend must be 'cuda' or 'reference', got {self.backend!r} "
                             "(api.resolve_backend maps a config's name)")

    @property
    def tiles_x(self) -> int:
        return self.width // self.tile

    @property
    def tiles_y(self) -> int:
        return self.height // self.tile

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def max_radius(self) -> float:
        return (self.dup - 1) * self.tile / 2.0


class RenderOutput(NamedTuple):
    """Per-camera rasterizer outputs, all [H, W, ...]; `normal` is in camera
    space, `depth_expected` alpha-normalized, `depth_median` 0 where alpha
    never crosses 0.5."""

    image: torch.Tensor           # [H, W, 3]
    alpha: torch.Tensor           # [H, W]
    depth_expected: torch.Tensor  # [H, W]
    depth_median: torch.Tensor    # [H, W]
    normal: torch.Tensor          # [H, W, 3] camera space
    distortion: torch.Tensor      # [H, W]


class ProjectedSurfels(NamedTuple):
    """Per-surfel camera-space quantities produced by preprocess (SoA)."""

    center_cam: torch.Tensor  # [N, 3]
    au: torch.Tensor          # [N, 3] tangent axis u / s_u
    bv: torch.Tensor          # [N, 3] tangent axis v / s_v
    normal: torch.Tensor      # [N, 3] unit plane normal, flipped toward camera
    rgb: torch.Tensor         # [N, 3] SH-evaluated color
    opacity: torch.Tensor     # [N]
    depth: torch.Tensor       # [N] camera-space z of the center
    center2d: torch.Tensor    # [N, 2] pixel coords (pixel centers at +0.5)
    radius: torch.Tensor      # [N] clamped screen radius in pixels
    valid: torch.Tensor       # [N] bool
