"""Depth sort + tile binning, the counterpart of
`lara_tpu/ops/rasterizer/tiled.py` (`bin_view` in every `bin_mode` and
`pack_mode`):

  1. surfels are depth-sorted once per camera (stable) and the nearest
     `visible_budget` valid ones kept;
  2. each surfel claims a fixed dup×dup fan-out of tile slots;
  3. the windows: `bin_mode="sort"` sorts the int32 keys
     `tile << 19 | depth_rank`, which groups the slots by tile and orders
     them by depth within the tile, and takes per-tile ranges by
     searchsorted; `bin_mode="count"` counts each slot's depth rank inside
     its tile with a prefix sum over the depth axis and scatters the slots
     straight into the windows;
  4. every tile keeps its first `tile_budget` entries (the nearest).

`pack_mode="gather"` packs the kept surfels' rows in depth order ([V, 13])
and the windows index them; `pack_mode="fused"` (sort binning only) keeps
the pack elementwise ([N, 13], unpermuted) and the windows hold original
surfel ids. The binning is integer state that the fine-stage re-render
reuses (`repack_from_binned`).

The JAX package's `take_rows` with its inverse-order VJP
(`inv_order`, `TAKE_ROWS_MODE`) shapes the TPU's backward; here the row
gathers are plain indexing under autograd, and `BinnedView` has no
`inv_order`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lara_tpu_torch.ops.rasterizer.cuda_windows import tile_windows_reference
from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels, RasterizeConfig
from lara_tpu_torch.utils import trace

_GIDX_BITS = 19   # supports V ≤ 524288 surfels (64³·K=2, the LaRa maximum)
_BOUND_BITS = 5   # bits per packed tile-bound field (tiles_x/y ≤ 32)
# surfels per step of the counting-sort prefix sum: a [T, C] int32 block
# (32 MB at T = 1024), 16 steps at the train budget V = 131,072
_COUNT_CHUNK = 8192
PACK_COLS = 13


class BinnedView(NamedTuple):
    """Per-view binning state, reusable to re-render the SAME geometry
    with other colors/opacities.

    order_v:     [V] original surfel row per depth-compacted row.
    win_gidx:    [T, K] per-tile entry windows: indices into the packed
                 rows (compacted rows, or original ids with pack_mode
                 "fused").
    entry_valid: [T, K] window-entry validity.
    counts:      [T] int32 per-tile entry counts (≤ K).
    slot_pos:    [V, dup²] int32 flat window position t·K + rank of each
                 compacted row's tile claims, ≥ T·K where absent (each
                 absent claim a distinct value); from the counting-sort
                 binning only, else None. It is the window gather's exact
                 inverse, so the gather's backward is dup² row gathers
                 (`ops/gather.py:window_gather`).
    """

    order_v: torch.Tensor
    win_gidx: torch.Tensor
    entry_valid: torch.Tensor
    counts: torch.Tensor
    slot_pos: Optional[torch.Tensor] = None


def pack_surfels(g: ProjectedSurfels) -> torch.Tensor:
    """SoA → one [..., N, 13] f32 row matrix: center_cam, au, bv, rgb,
    opacity. The blend recomputes the normal, depth and screen center from
    these; invalid surfels are encoded as opacity 0."""
    return torch.cat([
        g.center_cam, g.au, g.bv, g.rgb,
        torch.where(g.valid, g.opacity, 0.0)[..., None],
    ], dim=-1)


def _pack_tile_bounds(g: ProjectedSurfels, cfg: RasterizeConfig) -> torch.Tensor:
    """Per-surfel clipped tile-rectangle bounds bit-packed into one int32
    [..., N]: tx_lo | ty_lo<<b | tx_hi<<2b | ty_hi<<3b. Invalid surfels get
    an empty rectangle (tx_lo > tx_hi)."""
    if max(cfg.tiles_x, cfg.tiles_y) > (1 << _BOUND_BITS):
        raise ValueError("at most 32 tiles per image axis")
    c2d, radius, tile = g.center2d, g.radius, cfg.tile

    def bound(x, hi):
        return torch.clamp(torch.floor(x / tile), 0, hi - 1).to(torch.int32)

    tx_lo = bound(c2d[..., 0] - radius, cfg.tiles_x)
    ty_lo = bound(c2d[..., 1] - radius, cfg.tiles_y)
    tx_hi = bound(c2d[..., 0] + radius, cfg.tiles_x)
    ty_hi = bound(c2d[..., 1] + radius, cfg.tiles_y)
    b = _BOUND_BITS
    packed = tx_lo | (ty_lo << b) | (tx_hi << (2 * b)) | (ty_hi << (3 * b))
    return torch.where(g.valid, packed, (1 << b) - 1)


def _unpack_bounds(bounds_v: torch.Tensor):
    """(tx_lo, ty_lo, tx_hi, ty_hi) of `_pack_tile_bounds`."""
    b = _BOUND_BITS
    mask = (1 << b) - 1
    return (bounds_v & mask, (bounds_v >> b) & mask,
            (bounds_v >> (2 * b)) & mask, (bounds_v >> (3 * b)) & mask)


def _slot_tiles(bounds_v: torch.Tensor, cfg: RasterizeConfig):
    """(tile id [..., V, dup²] of each slot, num_tiles where the slot falls
    outside the surfel's rectangle; the slot's row-major tile id unmasked)."""
    tx_lo, ty_lo, tx_hi, ty_hi = _unpack_bounds(bounds_v)
    d = cfg.dup
    slot = torch.arange(d * d, dtype=torch.int32, device=bounds_v.device)
    tx = tx_lo[..., None] + slot % d
    ty = ty_lo[..., None] + slot // d
    slot_ok = (tx <= tx_hi[..., None]) & (ty <= ty_hi[..., None])
    tid = ty * cfg.tiles_x + tx
    return torch.where(slot_ok, tid, cfg.num_tiles), tid


def slot_keys(bounds_v: torch.Tensor, cfg: RasterizeConfig) -> torch.Tensor:
    """The binning's sort keys [..., V·dup²] of the depth-ordered bounds
    [..., V]: tile << 19 | depth rank."""
    tile_id, _ = _slot_tiles(bounds_v, cfg)
    gidx = torch.arange(bounds_v.shape[-1], dtype=torch.int32, device=bounds_v.device)
    return ((tile_id << _GIDX_BITS) | gidx[:, None]).flatten(-2)


def tile_ranges(sorted_keys: torch.Tensor, cfg: RasterizeConfig):
    """(starts [..., T], raw counts [..., T]) int32 of each tile's run of
    the sorted keys [..., M]."""
    tids = torch.arange(cfg.num_tiles + 1, dtype=torch.int32,
                        device=sorted_keys.device) << _GIDX_BITS
    tids = tids.expand(*sorted_keys.shape[:-1], -1).contiguous()
    bounds = torch.searchsorted(sorted_keys, tids, side="left").to(torch.int32)
    return bounds[..., :-1], bounds[..., 1:] - bounds[..., :-1]


def bin_view(g: ProjectedSurfels, cfg: RasterizeConfig):
    """Depth-sort, compact to the nearest `visible_budget` valid surfels
    and build the per-tile entry windows. Returns (packed, BinnedView):
    packed is [V, 13] in depth order, or with pack_mode "fused" (and
    bin_mode "sort") [N, 13] elementwise, the windows holding original ids.
    bin_mode "count" always packs in depth order: its slot_pos inverse is
    defined over compacted rows. Under a profiler it adds to the binning's
    counters (`utils/trace.py`) where the tile budget clamps the counts."""
    n = g.depth.shape[0]
    v = min(cfg.visible_budget, n) if cfg.visible_budget else n
    if v > (1 << _GIDX_BITS) or cfg.num_tiles >= (1 << 11):
        raise ValueError("binning keys hold at most 2^19 surfels and 2^11 tiles")
    bounds_all = _pack_tile_bounds(g, cfg)
    depth_key = torch.where(g.valid, g.depth, torch.inf)
    order_v = torch.argsort(depth_key, stable=True)[:v]
    bounds_v = bounds_all[order_v]
    slot_pos = None
    if cfg.pack_mode == "fused" and cfg.bin_mode != "count":
        packed = pack_surfels(g)
        win_gidx, entry_valid, counts = _windows_sort(bounds_v, cfg, order_v=order_v)
    else:
        packed = pack_surfels(g)[order_v]
        if cfg.bin_mode == "count":
            win_gidx, entry_valid, counts, slot_pos = _windows_count(bounds_v, cfg)
        else:
            win_gidx, entry_valid, counts = _windows_sort(bounds_v, cfg)
    return packed, BinnedView(order_v=order_v, win_gidx=win_gidx,
                              entry_valid=entry_valid, counts=counts,
                              slot_pos=slot_pos)


def _windows_sort(bounds_v: torch.Tensor, cfg: RasterizeConfig, order_v=None):
    """Tile windows via one dup²·V-key sort + searchsorted + slicing.

    With `order_v` (pack_mode "fused") the key sort carries each slot's
    original surfel id and the windows hold those ids (sentinel 0 past a
    tile's run), so the blend gathers from the unpermuted [N, 13] pack."""
    keys = slot_keys(bounds_v, cfg)
    sorted_keys, perm = torch.sort(keys)
    starts, counts = tile_ranges(sorted_keys, cfg)

    # entry k of tile t sits at sorted position starts[t]+k; slots past the
    # end of the sorted array hold a sentinel, and slots past counts[t] are
    # invalid
    k_budget = cfg.tile_budget
    if order_v is None:
        win_gidx = tile_windows_reference(sorted_keys, starts, k_budget) \
            & ((1 << _GIDX_BITS) - 1)
    else:
        # equal keys (a surfel's absent slots) carry the same id, so the
        # order the sort leaves them in does not matter
        d2 = cfg.dup * cfg.dup
        sorted_orig = order_v.to(torch.int32)[torch.div(perm, d2, rounding_mode="floor")]
        padded = torch.cat([sorted_orig, sorted_orig.new_zeros(k_budget)])
        k_iota = torch.arange(k_budget, dtype=torch.int32, device=keys.device)
        win_gidx = padded[starts[:, None] + k_iota]
    return (win_gidx, *_validity(counts, k_budget))


def _validity(raw: torch.Tensor, k_budget: int):
    """(entry_valid [T, K], the raw counts clamped to K)."""
    counts = torch.clamp(raw, max=k_budget)
    trace.count_binning(raw, counts, k_budget)
    k_iota = torch.arange(k_budget, dtype=torch.int32, device=counts.device)
    return k_iota[None, :] < counts[:, None], counts


def _windows_count(bounds_v: torch.Tensor, cfg: RasterizeConfig, chunk: int = _COUNT_CHUNK):
    """Counting-sort tile windows: no key sort, no searchsorted.

    The surfels arrive depth-ordered, so a slot's rank in its tile is the
    number of earlier surfels whose rectangle holds that tile: an exclusive
    prefix sum over the depth axis of the [V, T] membership matrix. It runs
    over chunks of `chunk` surfels as an int32 `torch.cumsum` of the chunk's
    tile-major [T, C] block plus a carried per-tile total, exact at any size
    (the JAX package's bf16 triangular product is the TPU's way to the same
    integers).
    Each kept slot (rank < K) then knows its window position t·K + rank,
    and one scatter of distinct positions fills the windows; dropped slots
    get distinct positions past T·K, which the scatter writes into scratch.
    Returns (win_gidx, entry_valid, counts, slot_pos [V, dup²])."""
    v = bounds_v.shape[0]
    dev = bounds_v.device
    t_total, k_budget = cfg.num_tiles, cfg.tile_budget
    d2 = cfg.dup * cfg.dup
    tx_lo, ty_lo, tx_hi, ty_hi = _unpack_bounds(bounds_v)
    tile_id, tid_raw = _slot_tiles(bounds_v, cfg)
    tid_c = torch.clamp(tid_raw, 0, t_total - 1).long()
    tx_iota = torch.arange(cfg.tiles_x, dtype=torch.int32, device=dev)
    ty_iota = torch.arange(cfg.tiles_y, dtype=torch.int32, device=dev)

    carry = torch.zeros((t_total,), dtype=torch.int32, device=dev)
    ranks = []
    for c0 in range(0, v, chunk):
        sl = slice(c0, min(c0 + chunk, v))
        # tile-major [T, C], so the prefix sum runs along the innermost
        # axis: a scan along the outer axis of [C, T] gets one thread per
        # tile on the card
        rx = (tx_iota[:, None] >= tx_lo[sl]) & (tx_iota[:, None] <= tx_hi[sl])  # [TX, C]
        ry = (ty_iota[:, None] >= ty_lo[sl]) & (ty_iota[:, None] <= ty_hi[sl])  # [TY, C]
        member = (ry[:, None, :] & rx[None, :, :]).reshape(t_total, -1)         # [T, C]
        incl = torch.cumsum(member, dim=1, dtype=torch.int32)
        # a kept slot's tile is in its surfel's rectangle (member = 1), so
        # its exclusive rank is the inclusive count - 1
        col = torch.arange(sl.stop - sl.start, device=dev)[:, None]
        ranks.append(carry[tid_c[sl]] + incl[tid_c[sl], col] - 1)
        carry = carry + incl[:, -1]
    ranks = torch.cat(ranks)                                                    # [V, D2]

    ok = (tile_id < t_total) & (ranks < k_budget)
    flat_iota = torch.arange(v * d2, dtype=torch.int32, device=dev).reshape(v, d2)
    slot_pos = torch.where(ok, tile_id * k_budget + ranks, t_total * k_budget + flat_iota)
    gidx = torch.arange(v, dtype=torch.int32, device=dev)[:, None].expand(v, d2)
    win = torch.zeros((t_total * k_budget + v * d2,), dtype=torch.int32, device=dev)
    win.scatter_(0, slot_pos.reshape(-1).long(), gidx.reshape(-1))
    win_gidx = win[:t_total * k_budget].reshape(t_total, k_budget)
    return (win_gidx, *_validity(carry, k_budget), slot_pos)


def repack_from_binned(g: ProjectedSurfels, binned: BinnedView,
                       cfg: RasterizeConfig) -> torch.Tensor:
    """Packed rows for a re-render of the same geometry (new colors /
    opacities) through the cached windows, no sort: elementwise with
    pack_mode "fused" (the windows hold original ids), else one row gather
    into the cached depth order."""
    if cfg.pack_mode == "fused" and cfg.bin_mode != "count":
        return pack_surfels(g)
    return pack_surfels(g)[binned.order_v]
