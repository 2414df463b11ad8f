"""Depth sort + tile binning, the counterpart of the `sort` + `gather`
default of `lara_tpu/ops/rasterizer/tiled.py`:

  1. surfels are depth-sorted once per camera (stable) and the nearest
     `visible_budget` valid ones packed into one [V, 13] row matrix;
  2. each surfel claims a fixed dup×dup fan-out of tile slots;
  3. one int32 sort of `tile << 19 | depth_rank` groups the slots by tile
     and orders them by depth within the tile; per-tile ranges come from
     searchsorted on the raw keys;
  4. every tile keeps its first `tile_budget` entries (the nearest).

The binning is integer state that the fine-stage re-render reuses
(`repack_from_binned`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels, RasterizeConfig

_GIDX_BITS = 19   # supports V ≤ 524288 surfels (64³·K=2, the LaRa maximum)
_BOUND_BITS = 5   # bits per packed tile-bound field (tiles_x/y ≤ 32)
_INT32_MAX = 2 ** 31 - 1
PACK_COLS = 13


class BinnedView(NamedTuple):
    """Per-view binning state, reusable to re-render the SAME geometry
    with other colors/opacities.

    order_v:     [V] original surfel row per depth-compacted row.
    win_gidx:    [T, K] per-tile entry windows (indices into packed rows).
    entry_valid: [T, K] window-entry validity.
    counts:      [T] int32 per-tile entry counts (≤ K).
    """

    order_v: torch.Tensor
    win_gidx: torch.Tensor
    entry_valid: torch.Tensor
    counts: torch.Tensor


def pack_surfels(g: ProjectedSurfels) -> torch.Tensor:
    """SoA → one [N, 13] f32 row matrix: center_cam, au, bv, rgb, opacity.
    The blend recomputes the normal, depth and screen center from these;
    invalid surfels are encoded as opacity 0."""
    return torch.cat([
        g.center_cam, g.au, g.bv, g.rgb,
        torch.where(g.valid, g.opacity, 0.0)[:, None],
    ], dim=-1)


def _pack_tile_bounds(g: ProjectedSurfels, cfg: RasterizeConfig) -> torch.Tensor:
    """Per-surfel clipped tile-rectangle bounds bit-packed into one int32:
    tx_lo | ty_lo<<b | tx_hi<<2b | ty_hi<<3b. Invalid surfels get an empty
    rectangle (tx_lo > tx_hi)."""
    if max(cfg.tiles_x, cfg.tiles_y) > (1 << _BOUND_BITS):
        raise ValueError("at most 32 tiles per image axis")
    c2d, radius, tile = g.center2d, g.radius, cfg.tile

    def bound(x, hi):
        return torch.clamp(torch.floor(x / tile), 0, hi - 1).to(torch.int32)

    tx_lo = bound(c2d[:, 0] - radius, cfg.tiles_x)
    ty_lo = bound(c2d[:, 1] - radius, cfg.tiles_y)
    tx_hi = bound(c2d[:, 0] + radius, cfg.tiles_x)
    ty_hi = bound(c2d[:, 1] + radius, cfg.tiles_y)
    b = _BOUND_BITS
    packed = tx_lo | (ty_lo << b) | (tx_hi << (2 * b)) | (ty_hi << (3 * b))
    return torch.where(g.valid, packed, (1 << b) - 1)


def bin_view(g: ProjectedSurfels, cfg: RasterizeConfig):
    """Depth-sort, compact to the nearest `visible_budget` valid surfels,
    pack their rows and build the per-tile entry windows.
    Returns (packed [V, 13], BinnedView)."""
    n = g.depth.shape[0]
    v = min(cfg.visible_budget, n) if cfg.visible_budget else n
    if v > (1 << _GIDX_BITS) or cfg.num_tiles >= (1 << 11):
        raise ValueError("binning keys hold at most 2^19 surfels and 2^11 tiles")
    bounds_all = _pack_tile_bounds(g, cfg)
    depth_key = torch.where(g.valid, g.depth, torch.inf)
    order_v = torch.argsort(depth_key, stable=True)[:v]
    packed = pack_surfels(g)[order_v]
    win_gidx, entry_valid, counts = _windows_sort(bounds_all[order_v], cfg)
    return packed, BinnedView(order_v=order_v, win_gidx=win_gidx,
                              entry_valid=entry_valid, counts=counts)


def _windows_sort(bounds_v: torch.Tensor, cfg: RasterizeConfig):
    """Tile windows via one dup²·V-key sort + searchsorted + slicing."""
    n = bounds_v.shape[0]
    dev = bounds_v.device
    b = _BOUND_BITS
    mask = (1 << b) - 1
    tx_lo, ty_lo = bounds_v & mask, (bounds_v >> b) & mask
    tx_hi, ty_hi = (bounds_v >> (2 * b)) & mask, (bounds_v >> (3 * b)) & mask

    d = cfg.dup
    slot = torch.arange(d * d, dtype=torch.int32, device=dev)
    si, sj = slot // d, slot % d
    tx = tx_lo[:, None] + sj[None, :]
    ty = ty_lo[:, None] + si[None, :]
    slot_ok = (tx <= tx_hi[:, None]) & (ty <= ty_hi[:, None])
    tile_id = torch.where(slot_ok, ty * cfg.tiles_x + tx, cfg.num_tiles)

    gidx = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    keys = ((tile_id << _GIDX_BITS) | gidx).reshape(-1)
    sorted_keys = torch.sort(keys).values

    tids = torch.arange(cfg.num_tiles + 1, dtype=torch.int32, device=dev) << _GIDX_BITS
    bounds = torch.searchsorted(sorted_keys, tids, side="left").to(torch.int32)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]

    # entry k of tile t sits at sorted position starts[t]+k; K sentinel
    # entries pad the tail, and slots past counts[t] are invalid
    k_budget = cfg.tile_budget
    k_iota = torch.arange(k_budget, dtype=torch.int32, device=dev)
    flat = starts[:, None] + k_iota[None, :]
    padded = torch.cat([sorted_keys, torch.full(
        (k_budget,), _INT32_MAX, dtype=torch.int32, device=dev)])
    win_gidx = padded[flat] & ((1 << _GIDX_BITS) - 1)
    counts = torch.clamp(counts, max=k_budget)
    entry_valid = k_iota[None, :] < counts[:, None]
    return win_gidx, entry_valid, counts


def repack_from_binned(g: ProjectedSurfels, binned: BinnedView) -> torch.Tensor:
    """Packed rows for a re-render of the same geometry (new colors /
    opacities) through the cached windows: one row gather into the cached
    depth order, no sort."""
    return pack_surfels(g)[binned.order_v]
