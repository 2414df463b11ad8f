"""Per-tile surfel compositing: the hand-written CUDA kernels and their
plain PyTorch version, the counterpart of
`lara_tpu/ops/rasterizer/pallas_blend.py` (`blend_tiles_pallas` and its
custom VJP, with `pallas_stash_carries` True or False).

`blend_tiles` returns the raw accumulators [T, NUM_CHANNELS, tile²]: rgb,
alpha, depth sum, median depth, normal xyz, distortion (no background
blend, unnormalized depth).
  - CPU tensors run `blend_tiles_reference` under ordinary autograd: it is
    the plain version of every kernel here.
  - CUDA tensors launch `csrc/blend_fwd.cu`. When autograd will need the
    gradient of `entries`, the backward launches `csrc/blend_bwd.cu`:
    with `cfg.stash_carries` the forward writes its stash (per-chunk
    carries and processed-chunk counts) and the backward reads it; without
    it the forward writes nothing more and the backward replays each
    tile's forward walk to rebuild the carries (the replay mode, the
    counterpart of `_run_bwd`). The median's gradient is 0 in both
    versions, as in the TPU kernel. A kernel that cannot be built or
    launched raises: nothing falls back.

The kernels are instantiated at tiles 8, 16 and 32 (`TILES`; one block of
tile²/2 threads per tile, two pixels a thread). Any other tile edge t runs
as sub-tiles: ⌈t/s⌉² blocks of an instantiated edge s (`subtile`), each
given its pixels' places in the tile; where s does not divide t, the
pixels past the tile's edge start saturated and are never written. The
rule for s: the edge of `TILES` that launches the fewest pixels,
⌈t/s⌉²·s², ties to the larger edge (fewer blocks): 64 → 32 (4 sub-tiles),
48 → 16 (9), 24 → 8 (9), 12 → 16 (one, 144 of its 256 pixels in the
tile), 20 → 8 (9, masked), 4 → 8 (one). A sub-tile walks until its own
pixels are saturated, which leaves every pixel's accumulators as the
whole tile's walk leaves them; the stash forward (and the replay when it
writes its walk) then gives each tile the largest of its sub-tiles'
processed-chunk counts and carries every sub-tile's final carry up to
that slot (`blend_common.cuh:fill_stash_kernel`), so the stash and ndone
are per tile exactly as at an instantiated edge. The backward writes each
sub-tile's rows [parts, T, K, 13] and sums them in sub-tile order
(`blend_bwd.cu:sum_parts_kernel`, no atomics: two calls agree bit for
bit, and the replay equals the stash path bit for bit). Shared memory,
threads, the reduction group and the backward's form follow the
sub-tile's edge (`bwd_smem(tile, ...)` takes the tile and maps it).

Each wrapper counts its launches in `LAUNCHES` (forward, forward with
stash, backward from the stash, replay backward), per tile: `launch_key`
names the tile-16 counts as before ("blend_fwd") and the others with the
tile ("blend_fwd_t32", "blend_fwd_t64"). The backward has two forms,
chosen by (tile, budget, chunk, mode) alone (`bwd_form`): the hit bits and
end values of the chunks it keeps live in shared memory where that fits a
block's 232,448 B, else in a scratch buffer the wrapper allocates. The
libraries are built by `lara_tpu_torch/ops/_build.py`.
"""

from __future__ import annotations

import torch

from lara_tpu_torch.ops import _build
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig

NUM_CHANNELS = 10   # rgb3 + alpha + depth_sum + depth_med + normal3 + dist
PACK_COLS = 13
TILES = (8, 16, 32)         # instantiated edges: one block per tile
KINDS = ("blend_fwd", "blend_fwd_stash", "blend_bwd", "blend_bwd_replay")
# dynamic shared memory a block may ask for on sm_90; a backward whose kept
# hit bits would pass it takes the global form (blend_bwd.cu)
MAX_SMEM = 232448
MAX_STAGED = 512    # entries staged at a time: a longer chunk is staged in pieces
RECORD = 20         # f32 per staged entry (blend_common.cuh: five float4)
SUB = 32            # entries per sub-block of the backward: one word of hit bits
PARTIALS = 19       # per-entry partial gradients summed over a tile's pixels


def subtile(tile: int) -> int:
    """The instantiated edge that runs `tile`: the tile itself at 8, 16 and
    32, else the edge of TILES whose sub-tiles launch the fewest pixels,
    ties to the larger edge (see the module's docstring)."""
    if tile in TILES:
        return tile
    if tile < 1:
        raise ValueError(f"a tile has at least one pixel, not {tile}")
    return min(TILES, key=lambda s: ((-(-tile // s) * s) ** 2, -s))


def parts_x(tile: int) -> int:
    """Sub-tiles a side of a tile (1 at an instantiated edge)."""
    return -(-tile // subtile(tile))


def launch_key(kind: str, tile: int) -> str:
    """The `LAUNCHES` key of kernel `kind` at `tile`."""
    return kind if tile == 16 else f"{kind}_t{tile}"


# every launch is counted under its tile's key; the keys of the
# instantiated edges and of the sub-tiled tiles the checks run exist from
# the start, another tile's from its first launch
LAUNCHES = {launch_key(k, t): 0 for t in TILES + (4, 12, 20, 24, 48, 64) for k in KINDS}
# the kernel behind each instantiation, as ptxas names it in the build log:
# (launch kind, edge, global form, split: the chunk staged in pieces or
# reduced in groups, `split_chunk`; sub: the sub-tiled kernel)
KERNELS = {f"blend_fwd{sub}_kernel<{t}, {s}>": ("blend_fwd", t, False, bool(s), bool(sub))
           for sub in ("", "_sub") for t in TILES for s in (0, 1)}
KERNELS.update({f"blend_bwd{sub}_kernel<{t}, {r}, {g}, {s}>":
                (KINDS[2 + r], t, bool(g), bool(s), bool(sub))
                for sub in ("", "_sub") for t in TILES for r in (0, 1) for g in (0, 1)
                for s in (0, 1)})


def threads(tile: int) -> int:
    """Threads per block of every blend kernel at `tile`: two pixels each
    of its (sub-)tile."""
    edge = subtile(tile)
    return edge * edge // 2


def fwd_min_smem(tile: int) -> int:
    """Dynamic shared memory the forward asks for at least, so that at most
    20 warps share an SM (blend_fwd.cu, min_smem): 5 blocks at edge 16, 20
    at edge 8; none at edge 32, whose registers allow one block."""
    blocks = 20 // (threads(tile) // 32)
    return 233472 // (blocks + 1) - 1024 + 16 if blocks >= 2 else 0


def reduce_group(tile: int) -> int:
    """Entries whose per-warp partials the backward reduces together, at
    most (blend_bwd.cu, reduce_group of the edge)."""
    return 128 if subtile(tile) == 16 else SUB


def split_chunk(kind: str, tile: int, chunk: int) -> bool:
    """Whether kernel `kind` runs its split instantiation at `chunk`: the
    forward stages a chunk past MAX_STAGED in pieces, the backward reduces
    a chunk past `reduce_group` in groups (blend_fwd.cu, blend_bwd.cu)."""
    return chunk > (MAX_STAGED if kind.startswith("blend_fwd") else reduce_group(tile))


def _kept(chunk: int, budget: int, replay: bool) -> int:
    return budget // chunk if replay else 1


def bwd_smem(tile: int, chunk: int, budget: int, replay: bool, global_form: bool) -> int:
    """`blend_bwd.cu:smem_bytes` at the edge that runs `tile`: the staged
    records (at most MAX_STAGED entries), the hit bits and end
    transmittance of each 32-entry sub-block of one chunk (stash mode) or
    of every chunk of the budget (replay mode) for the (sub-)tile's pixels,
    in the shared form only, and the per-warp partials of a reduction
    group."""
    edge = subtile(tile)
    pixels, nsub = edge * edge, -(-chunk // SUB)
    bits = 0 if global_form else 2 * _kept(chunk, budget, replay) * nsub * pixels
    return 4 * (RECORD * min(chunk, MAX_STAGED) + bits
                + pixels // 64 * min(chunk, reduce_group(tile)) * PARTIALS)


def bwd_global(tile: int, chunk: int, budget: int, replay: bool) -> bool:
    """Whether the backward takes its global form at this config: the shared
    form would ask for more than MAX_SMEM."""
    return bwd_smem(tile, chunk, budget, replay, False) > MAX_SMEM


def bwd_form(cfg: RasterizeConfig, replay: bool) -> str:
    """"shared" or "global": where the backward keeps its hit bits."""
    return "global" if bwd_global(cfg.tile, cfg.pallas_chunk, cfg.tile_budget, replay) else "shared"


def scratch_words(cfg: RasterizeConfig, replay: bool) -> int:
    """32-bit words of the global form's scratch: per tile and sub-tile,
    the hit bits and end values of every sub-block of the kept chunks for
    its pixels."""
    nsub, edge = -(-cfg.pallas_chunk // SUB), subtile(cfg.tile)
    return (cfg.num_tiles * parts_x(cfg.tile) ** 2 * 2
            * _kept(cfg.pallas_chunk, cfg.tile_budget, replay) * nsub * edge * edge)


def kernel_smem(chunk: int, budget: int | None = None, tile: int = 16) -> dict:
    """Dynamic shared memory per block (bytes) of each blend kernel at
    `pallas_chunk` = chunk, `tile_budget` = budget (default: one chunk) and
    `tile`, as its launch asks for it: the forward's staged records, at
    least `fwd_min_smem`; each backward mode's `bwd_smem` in the form it
    takes there (`bwd_global`)."""
    budget = budget or chunk
    bwd = {kind: bwd_smem(tile, chunk, budget, replay, bwd_global(tile, chunk, budget, replay))
           for kind, replay in (("blend_bwd", False), ("blend_bwd_replay", True))}
    return {"blend_fwd": max(4 * RECORD * min(chunk, MAX_STAGED), fwd_min_smem(tile)), **bwd}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_inputs(entries, counts, scalars, cfg: RasterizeConfig):
    t, k, p = cfg.num_tiles, cfg.tile_budget, cfg.tile * cfg.tile
    if entries.shape != (t, k, PACK_COLS) or entries.dtype != torch.float32:
        raise ValueError(f"entries must be f32 [{t}, {k}, {PACK_COLS}], got "
                         f"{entries.dtype} {tuple(entries.shape)}")
    if counts.shape != (t,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 [{t}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if scalars.shape != (2,) or scalars.dtype != torch.float32:
        raise ValueError("scalars must be f32 [2] (tan fov x, tan fov y)")
    if cfg.pallas_chunk <= 0 or k % cfg.pallas_chunk:
        raise ValueError(f"pallas_chunk {cfg.pallas_chunk} must divide the "
                         f"tile budget {k}")
    return t, p


def _cuda_args(dev, *tensors):
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"a blend input is on {x.device}, entries on {dev}")
    return [x.contiguous() for x in tensors]


def _raster_args(cfg: RasterizeConfig):
    return (cfg.num_tiles, cfg.tiles_x, cfg.tile, cfg.width, cfg.height,
            cfg.tile_budget, cfg.pallas_chunk, cfg.alpha_min,
            cfg.transmittance_min, cfg.near_cull, cfg.dist_near,
            cfg.dist_far, cfg.filter2d_invsq)


def blend_fwd(entries, counts, scalars, cfg: RasterizeConfig, stash: bool = False):
    """Launch `blend_fwd.cu` on CUDA tensors. Returns the accumulators
    [T, 10, P], and with `stash` also the carries
    [T, budget/chunk + 1, 4, P] (slots past ndone unwritten) and the
    processed-chunk counts ndone int32 [T]."""
    t, p = _check_inputs(entries, counts, scalars, cfg)
    edge, parts = subtile(cfg.tile), parts_x(cfg.tile) ** 2
    entries, counts, scalars = _cuda_args(entries.device, entries, counts, scalars)
    dev = entries.device
    lib = _build.build_library()["blend_fwd"]
    out = torch.empty((t, NUM_CHANNELS, p), dtype=torch.float32, device=dev)
    carries = ndone = None
    if stash:
        slots = cfg.tile_budget // cfg.pallas_chunk + 1
        carries = torch.empty((t, slots, 4, p), dtype=torch.float32, device=dev)
        ndone = torch.empty((t,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [entries.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
                out.data_ptr(), None if carries is None else carries.data_ptr(),
                None if ndone is None else ndone.data_ptr(), *_raster_args(cfg), stream]
        if edge == cfg.tile:
            err = lib.lara_blend_fwd(*args)
        else:
            # the sub-tiles' counts, for the stash's fill
            part_ndone = (torch.empty((t, parts), dtype=torch.int32, device=dev)
                          if stash and parts > 1 else None)
            err = lib.lara_blend_fwd_sub(
                *args, edge, None if part_ndone is None else part_ndone.data_ptr())
    _build.raise_on(err, "blend_fwd")
    key = launch_key("blend_fwd_stash" if stash else "blend_fwd", cfg.tile)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return (out, carries, ndone) if stash else out


def _launch_bwd(entries, counts, scalars, carries, ndone, cot,
                cfg: RasterizeConfig, replay: bool) -> torch.Tensor:
    _check_inputs(entries, counts, scalars, cfg)
    edge, parts = subtile(cfg.tile), parts_x(cfg.tile) ** 2
    dev = entries.device
    entries, counts, scalars, cot = _cuda_args(
        dev, entries, counts, scalars, cot.to(torch.float32))
    if carries is not None:
        carries, ndone = _cuda_args(dev, carries, ndone)
    lib = _build.build_library()["blend_bwd"]
    grad = torch.empty_like(entries)
    args = [entries.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
            None if carries is None else carries.data_ptr(),
            None if ndone is None else ndone.data_ptr(), cot.data_ptr(),
            grad.data_ptr(), int(replay), *_raster_args(cfg)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = None
        if bwd_form(cfg, replay) == "global":
            scratch = torch.empty((scratch_words(cfg, replay),), dtype=torch.int32, device=dev)
        if edge != cfg.tile:
            # each sub-tile's rows, summed in order; the sub-tiles' counts of
            # a replay that writes its walk, for the fill
            part_grads = torch.empty((parts,) + grad.shape, dtype=torch.float32,
                                     device=dev) if parts > 1 else None
            part_ndone = (torch.empty((entries.shape[0], parts), dtype=torch.int32, device=dev)
                          if replay and carries is not None and parts > 1 else None)
            err = lib.lara_blend_bwd_sub(
                *args, stream, None if scratch is None else scratch.data_ptr(), edge,
                None if part_grads is None else part_grads.data_ptr(),
                None if part_ndone is None else part_ndone.data_ptr())
        elif scratch is not None:
            err = lib.lara_blend_bwd_global(*args, stream, scratch.data_ptr())
        else:
            err = lib.lara_blend_bwd(*args, stream)
    kind = "blend_bwd_replay" if replay else "blend_bwd"
    _build.raise_on(err, kind)
    key = launch_key(kind, cfg.tile)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return grad


def blend_bwd(entries, counts, scalars, carries, ndone, cot,
              cfg: RasterizeConfig) -> torch.Tensor:
    """Launch `blend_bwd.cu` on CUDA tensors: the gradient [T, K, 13] of
    the entries from the cotangent `cot` [T, 10, P] of the accumulators
    (channel 5, the median, is ignored) and the stash of
    `blend_fwd(..., stash=True)`."""
    return _launch_bwd(entries, counts, scalars, carries, ndone, cot, cfg, replay=False)


def blend_bwd_replay(entries, counts, scalars, cot, cfg: RasterizeConfig,
                     return_carries: bool = False):
    """Launch `blend_bwd.cu` in replay mode on CUDA tensors: the same
    gradient as `blend_bwd`, with each tile's carries rebuilt in the kernel
    by replaying its forward walk. With `return_carries` the kernel also
    writes what it replayed, in the layout of the stash forward (carries
    [T, budget/chunk + 1, 4, P], slots past ndone unwritten, and ndone),
    for a check against the stash; returns (grad, carries, ndone) then."""
    carries = ndone = None
    if return_carries:
        t, p = _check_inputs(entries, counts, scalars, cfg)
        slots = cfg.tile_budget // cfg.pallas_chunk + 1
        carries = torch.empty((t, slots, 4, p), dtype=torch.float32, device=entries.device)
        ndone = torch.empty((t,), dtype=torch.int32, device=entries.device)
    grad = _launch_bwd(entries, counts, scalars, carries, ndone, cot, cfg, replay=True)
    return (grad, carries, ndone) if return_carries else grad


class _BlendFunction(torch.autograd.Function):
    """The forward and the backward kernel as one differentiable op (the
    counterpart of `blend_tiles_pallas`'s custom VJP): with
    `cfg.stash_carries` the stash forward and the backward from it, else
    the forward without stash and the replay backward, which keeps only
    the forward's inputs alive between the passes. Without `train` (no
    gradient wanted) the forward alone, under the same op, which owns the
    kernel's launch in a profile."""

    @staticmethod
    def forward(ctx, entries, counts, scalars, cfg, train):
        ctx.cfg = cfg
        if not train:
            return blend_fwd(entries, counts, scalars, cfg)
        if cfg.stash_carries:
            out, carries, ndone = blend_fwd(entries, counts, scalars, cfg, stash=True)
            ctx.save_for_backward(entries, counts, scalars, carries, ndone)
        else:
            out = blend_fwd(entries, counts, scalars, cfg)
            ctx.save_for_backward(entries, counts, scalars)
        return out

    @staticmethod
    def backward(ctx, cot):
        if ctx.cfg.stash_carries:
            grad = blend_bwd(*ctx.saved_tensors, cot, ctx.cfg)
        else:
            grad = blend_bwd_replay(*ctx.saved_tensors, cot, ctx.cfg)
        return grad, None, None, None, None


def blend_tiles(entries: torch.Tensor, counts: torch.Tensor,
                scalars: torch.Tensor, cfg: RasterizeConfig) -> torch.Tensor:
    """entries [T, K, 13] depth-sorted per-tile windows; counts [T] int32;
    scalars [2] = (tanfovx, tanfovy). Returns raw accumulators
    [T, NUM_CHANNELS, tile²], differentiable in `entries`. CUDA tensors
    launch the kernels; CPU tensors take the plain version."""
    _check_inputs(entries, counts, scalars, cfg)
    dev = entries.device
    if dev.type == "cpu":
        return blend_tiles_reference(entries, counts, scalars, cfg)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles runs on cuda or cpu tensors, not {dev}")
    return _BlendFunction.apply(entries, counts, scalars, cfg,
                                torch.is_grad_enabled() and entries.requires_grad)


def blend_tiles_reference(entries: torch.Tensor, counts: torch.Tensor,
                          scalars: torch.Tensor, cfg: RasterizeConfig,
                          return_stash: bool = False):
    """Plain PyTorch version of the blend: `_chunk_fn` + the `_fwd_one_tile`
    chunk loop of the TPU kernel, vectorized over tiles. Log-domain
    transmittance with an inclusive cumsum per chunk (pallas_cumsum
    "shift"); a tile stops taking chunks once its count is exhausted or
    every pixel's transmittance is below `transmittance_min`.

    Differentiable in `entries` under autograd, with the median's gradient
    0 as in the TPU kernel. With `return_stash`, also returns what the
    stash forward writes: the carries [T, budget/chunk + 1, 4, P] (slot ci
    holds chunk ci's carry-in, slots from ndone on the final carry) and
    ndone int32 [T]."""
    dev = entries.device
    f32 = torch.float32
    t_tiles, p, chunk = cfg.num_tiles, cfg.tile * cfg.tile, cfg.pallas_chunk
    n = torch.clamp(counts, max=cfg.tile_budget)[:, None, None]      # [T,1,1]
    tanx, tany = scalars[0], scalars[1]
    fx = cfg.width / (2.0 * tanx)
    fy = cfg.height / (2.0 * tany)
    tid = torch.arange(t_tiles, device=dev)
    pid = torch.arange(p, device=dev)
    px = ((tid % cfg.tiles_x) * cfg.tile).to(f32)[:, None, None] + (pid % cfg.tile).to(f32) + 0.5
    py = ((tid // cfg.tiles_x) * cfg.tile).to(f32)[:, None, None] + (pid // cfg.tile).to(f32) + 0.5
    dx = (px - cfg.width / 2.0) / fx                                   # [T,1,P]
    dy = (py - cfg.height / 2.0) / fy
    kk = torch.arange(chunk, device=dev)[None, :, None]               # [1,C,1]
    nrm_c = cfg.dist_far / (cfg.dist_far - cfg.dist_near)

    def zeros():
        return torch.zeros((t_tiles, 1, p), dtype=f32, device=dev)

    t_run, a_run, m1_run, m2_run = torch.ones_like(zeros()), zeros(), zeros(), zeros()
    acc = [zeros() for _ in range(9)]
    med = zeros()
    carries, ndone = [], torch.zeros((t_tiles,), dtype=torch.int32, device=dev)
    for k0 in range(0, cfg.tile_budget, chunk):
        if return_stash:
            carries.append(torch.cat([t_run, a_run, m1_run, m2_run], dim=1))
        active = (k0 < n) & (torch.amax(t_run, dim=2, keepdim=True) >= cfg.transmittance_min)
        if not bool(active.any()):
            break
        ndone = ndone + active[:, 0, 0].to(torch.int32)
        rows = entries[:, k0:k0 + chunk, :].to(f32)                   # [T,C,13]
        (cx, cy, cz, au0, au1, au2, bv0, bv1, bv2,
         rr, gg, bb, op) = (rows[..., c:c + 1] for c in range(PACK_COLS))
        n0 = au1 * bv2 - au2 * bv1
        n1 = au2 * bv0 - au0 * bv2
        n2 = au0 * bv1 - au1 * bv0
        inv = 1.0 / torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20)
        sgn = torch.where(cx * n0 + cy * n1 + cz * n2 <= 0.0, inv, -inv)
        n0, n1, n2 = n0 * sgn, n1 * sgn, n2 * sgn
        cz_safe = torch.where(torch.abs(cz) < 1e-6, 1e-6, cz)
        c2x = fx * cx / cz_safe + cfg.width / 2.0
        c2y = fy * cy / cz_safe + cfg.height / 2.0

        nd = n0 * dx + n1 * dy + n2                                    # [T,C,P]
        nc = n0 * cx + n1 * cy + n2 * cz
        nd_ok = torch.abs(nd) >= 1e-8
        tt = nc / torch.where(nd_ok, nd, 1e-8)
        u = tt * (au0 * dx + au1 * dy + au2) - (au0 * cx + au1 * cy + au2 * cz)
        v = tt * (bv0 * dx + bv1 * dy + bv2) - (bv0 * cx + bv1 * cy + bv2 * cz)
        rho3d = torch.where(nd_ok, u * u + v * v, torch.inf)
        rho2d = cfg.filter2d_invsq * ((px - c2x) ** 2 + (py - c2y) ** 2)
        use3d = rho3d <= rho2d
        rho = torch.where(use3d, rho3d, rho2d)
        depth = torch.where(use3d, tt, cz)

        alpha = torch.clamp(op * torch.exp(-0.5 * rho), max=0.99)
        keep = ((alpha >= cfg.alpha_min) & (depth >= cfg.near_cull)
                & (op > 0.0) & (k0 + kk < n))
        alpha = torch.where(keep, alpha, 0.0)

        log_t = torch.log1p(-alpha)
        t_excl = t_run * torch.exp(torch.cumsum(log_t, 1) - log_t)
        live = t_excl * (1.0 - alpha) >= cfg.transmittance_min
        w = torch.where(live, alpha * t_excl, 0.0)

        m = nrm_c * (1.0 - cfg.dist_near / torch.clamp(depth, min=1e-6))
        m = torch.where(w > 0.0, m, 0.0)
        wm, wm2 = w * m, w * m * m
        a_excl = a_run + (torch.cumsum(w, 1) - w)
        m1_excl = m1_run + (torch.cumsum(wm, 1) - wm)
        m2_excl = m2_run + (torch.cumsum(wm2, 1) - wm2)
        partials = [(w * x).sum(1, keepdim=True) for x in (rr, gg, bb)]
        a_add = w.sum(1, keepdim=True)
        partials += [a_add, (w * depth).sum(1, keepdim=True)]
        partials += [(w * x).sum(1, keepdim=True) for x in (n0, n1, n2)]
        partials.append((w * (m * m * a_excl + m2_excl - 2.0 * m * m1_excl)).sum(1, keepdim=True))

        # median: depth of the last entry with w > 0 while T > 0.5
        mmask = (t_excl > 0.5) & (w > 0.0)
        midx = torch.amax(torch.where(mmask, kk, -1), dim=1, keepdim=True)
        # no gradient through the median, as in the TPU kernel's VJP
        dsel = torch.gather(depth.detach(), 1, torch.clamp(midx, min=0))
        new_med = torch.where(midx >= 0, dsel, med)

        acc = [torch.where(active, a + pa, a) for a, pa in zip(acc, partials)]
        med = torch.where(active, new_med, med)
        t_run = torch.where(active, t_run * torch.exp(log_t.sum(1, keepdim=True)), t_run)
        a_run = torch.where(active, a_run + a_add, a_run)
        m1_run = torch.where(active, m1_run + wm.sum(1, keepdim=True), m1_run)
        m2_run = torch.where(active, m2_run + wm2.sum(1, keepdim=True), m2_run)

    img_r, img_g, img_b, a_acc, dsum, nx, ny, nz, dist = acc
    out = torch.cat([img_r, img_g, img_b, a_acc, dsum, med, nx, ny, nz, dist], dim=1)
    if not return_stash:
        return out
    final = torch.cat([t_run, a_run, m1_run, m2_run], dim=1)
    carries += [final] * (cfg.tile_budget // chunk + 1 - len(carries))
    return out, torch.stack(carries, dim=1), ndone
