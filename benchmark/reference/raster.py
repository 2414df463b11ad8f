"""The 2D Gaussian surfel rasterizer of LaRa at the binned budgets, in plain
PyTorch and float32 (the 2DGS rasterizer of lightning/renderer_2dgs.py as
the TPU version bins it): per-surfel preprocess, one stable depth sort
keeping the nearest `visible_budget` surfels, a dup×dup fan-out of tile
slots, per-tile windows of the nearest `tile_budget` entries, and the
compositing of each tile's window in chunks, stopping where a tile is
exhausted or saturated. The fine re-render keeps the coarse render's
windows and changes only the colours and opacities.

The blend runs over blocks of tiles, so a 2048² render at 8,192 entries a
tile fits beside nothing else on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch

SH_C0, SH_C1 = 0.28209479177387814, 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
       -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
GIDX_BITS, BOUND_BITS = 19, 5
TILE_BLOCK_PIXELS = 1 << 20   # pixels of the tiles blended at once


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    height: int
    width: int
    tile: int
    dup: int
    tile_budget: int
    visible_budget: int
    chunk: int
    sh_degree: int = 1
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    near_cull: float = 0.2
    dist_near: float = 0.2
    dist_far: float = 100.0
    filter2d_invsq: float = 2.0

    @staticmethod
    def from_render(r: Dict, h: int, w: int, train: bool, sh_degree: int) -> "RasterConfig":
        budget = r["tile_budget"] if train else r["eval_tile_budget"]
        return RasterConfig(
            height=h, width=w, tile=r["tile"], dup=r["dup"], tile_budget=budget,
            visible_budget=r["visible_budget"] if train else r["eval_visible_budget"],
            chunk=min(r["pallas_chunk"], budget), sh_degree=sh_degree)

    @property
    def tiles_x(self):
        return self.width // self.tile

    @property
    def tiles_y(self):
        return self.height // self.tile

    @property
    def max_radius(self):
        return (self.dup - 1) * self.tile / 2.0


class Cam(NamedTuple):
    w2c: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor


def invert_rigid(m):
    r, t = m[..., :3, :3], m[..., :3, 3]
    rt = r.transpose(-1, -2)
    top = torch.cat([rt, -(rt @ t[..., None])], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=m.device).expand(*m.shape[:-2], 1, 4)
    return torch.cat([top, bottom], -2)


def cameras(batch) -> Cam:
    """Every view's camera; the SH direction's origin is -c2w[:3, 3], the
    reference's quirk (lightning/utils.py:48)."""
    c2w = batch["tar_c2w"]
    shape = c2w.shape[:-2]
    return Cam(invert_rigid(c2w), -c2w[..., :3, 3],
               torch.broadcast_to(torch.tan(0.5 * batch["fovx"])[:, None], shape),
               torch.broadcast_to(torch.tan(0.5 * batch["fovy"])[:, None], shape))


def view(c: Cam, b: int, v: int) -> Cam:
    return Cam(c.w2c[b, v], c.campos[b, v], c.tanfovx[b, v], c.tanfovy[b, v])


def rsh_cart(xyz, degree: int):
    x, y, z = xyz.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [_C2[0] * x * y, _C2[1] * y * z, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * x * z, _C2[4] * (xx - yy)]
    if degree >= 3:
        out += [_C3[0] * y * (3.0 * xx - yy), _C3[1] * x * y * z,
                _C3[2] * y * (4.0 * zz - xx - yy), _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy), _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, -1)


def ray_to_plucker(rays):
    o, d = rays[..., :3], rays[..., 3:6]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([d, torch.linalg.cross(o, d, dim=-1)], -1)


def l2_normalize(v):
    return v * torch.rsqrt(torch.sum(v * v, -1, keepdim=True) + 1e-24)


def quat_to_rotmat(qt):
    w, x, y, z = l2_normalize(qt).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Projected(NamedTuple):
    center_cam: torch.Tensor
    au: torch.Tensor
    bv: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor
    center2d: torch.Tensor
    radius: torch.Tensor
    valid: torch.Tensor


def preprocess(means, shs, opac, scales, rots, cam: Cam, cfg: RasterConfig) -> Projected:
    """Camera-space surfel frames, screen footprints (clamped to the dup
    ring), SH colours and the cull."""
    r_wc, t_wc = cam.w2c[:3, :3], cam.w2c[:3, 3]
    cc = means @ r_wc.T + t_wc
    axes = r_wc @ quat_to_rotmat(rots)
    unit_u, unit_v = axes[..., 0], axes[..., 1]
    s_u, s_v = torch.clamp(scales[:, 0], min=1e-8), torch.clamp(scales[:, 1], min=1e-8)
    z = cc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    fx, fy = cfg.width / (2.0 * cam.tanfovx), cfg.height / (2.0 * cam.tanfovy)
    c2d = torch.stack([fx * cc[:, 0] / z_safe + cfg.width / 2.0,
                       fy * cc[:, 1] / z_safe + cfg.height / 2.0], -1)

    def proj(p):
        pz = torch.clamp(p[:, 2], min=1e-3)
        return torch.stack([fx * p[:, 0] / pz + cfg.width / 2.0,
                            fy * p[:, 1] / pz + cfg.height / 2.0], -1)

    op_c = torch.clamp(opac, cfg.alpha_min, 0.99)
    cut = torch.clamp(torch.sqrt(torch.clamp(2.0 * torch.log(op_c / cfg.alpha_min), min=0.0)),
                      max=3.0)
    ext = torch.zeros_like(z)
    for axis, s in ((unit_u, s_u), (unit_v, s_v)):
        off = (cut * s)[:, None] * axis
        for sgn in (1.0, -1.0):
            d = torch.abs(proj(cc + sgn * off) - c2d)
            ext = torch.maximum(ext, torch.maximum(d[:, 0], d[:, 1]))
    radius = torch.clamp(ext + cut / math.sqrt(cfg.filter2d_invsq), max=cfg.max_radius)
    vd = means - cam.campos
    vd = vd / torch.clamp(torch.linalg.vector_norm(vd, dim=-1, keepdim=True), min=1e-12)
    basis = rsh_cart(vd, cfg.sh_degree)
    rgb = torch.clamp(torch.sum(basis[..., None] * shs, -2) + 0.5, min=0.0)
    m = cfg.max_radius
    valid = ((z > cfg.near_cull) & (c2d[:, 0] > -m) & (c2d[:, 0] < cfg.width + m)
             & (c2d[:, 1] > -m) & (c2d[:, 1] < cfg.height + m) & (opac > cfg.alpha_min))
    return Projected(cc, unit_u / s_u[:, None], unit_v / s_v[:, None], rgb, opac, z,
                     c2d, radius, valid)


def pack(g: Projected):
    """[N, 13] rows: centre, u / s_u, v / s_v, rgb, opacity (0 if culled)."""
    return torch.cat([g.center_cam, g.au, g.bv, g.rgb,
                      torch.where(g.valid, g.opacity, 0.0)[:, None]], -1)


class Binned(NamedTuple):
    order: torch.Tensor       # [V] surfel of each depth-ordered row
    windows: torch.Tensor     # [T, K] row of each window entry
    valid: torch.Tensor       # [T, K]
    counts: torch.Tensor      # [T] entries (≤ K)


def bin_view(g: Projected, cfg: RasterConfig) -> Binned:
    """Nearest `visible_budget` valid surfels in depth order; each claims
    the tiles of its clipped footprint within a dup×dup ring; each tile
    keeps its nearest `tile_budget` claims."""
    n = g.depth.shape[0]
    v = min(cfg.visible_budget, n) if cfg.visible_budget else n
    order = torch.argsort(torch.where(g.valid, g.depth, torch.inf), stable=True)[:v]
    c2d, rad = g.center2d[order], g.radius[order]
    tile = cfg.tile

    def bound(x, hi):
        return torch.clamp(torch.floor(x / tile), 0, hi - 1).to(torch.int64)

    ok_v = g.valid[order]
    tx_lo, tx_hi = bound(c2d[:, 0] - rad, cfg.tiles_x), bound(c2d[:, 0] + rad, cfg.tiles_x)
    ty_lo, ty_hi = bound(c2d[:, 1] - rad, cfg.tiles_y), bound(c2d[:, 1] + rad, cfg.tiles_y)
    d = cfg.dup
    slot = torch.arange(d * d, device=order.device)
    tx, ty = tx_lo[:, None] + slot % d, ty_lo[:, None] + slot // d
    claim = (tx <= tx_hi[:, None]) & (ty <= ty_hi[:, None]) & ok_v[:, None]
    n_tiles = cfg.tiles_x * cfg.tiles_y
    tid = torch.where(claim, ty * cfg.tiles_x + tx, n_tiles)
    keys = (tid << GIDX_BITS) | torch.arange(v, device=order.device)[:, None]
    keys = torch.sort(keys.flatten()).values
    edges = torch.arange(n_tiles + 1, device=order.device) << GIDX_BITS
    pos = torch.searchsorted(keys, edges)
    starts, counts = pos[:-1], pos[1:] - pos[:-1]
    k = cfg.tile_budget
    at = torch.clamp(starts[:, None] + torch.arange(k, device=order.device), max=keys.shape[0] - 1)
    rows = keys[at] & ((1 << GIDX_BITS) - 1)
    counts = torch.clamp(counts, max=k)
    valid = torch.arange(k, device=order.device)[None, :] < counts[:, None]
    return Binned(order, torch.where(valid, rows, 0), valid, counts)


def blend(entries, counts, cam: Cam, cfg: RasterConfig, t0: int, t1: int):
    """Composite tiles t0..t1-1 of their windows entries [t1-t0, K, 13]:
    ([t1-t0, 10, P] accumulators (rgb, alpha, depth sum, median depth,
    normal, distortion), the chunks each tile took [t1-t0]). Transmittance
    in the log domain within a chunk; a tile takes no further chunk once
    its entries or its pixels' light are spent; the median depth carries
    no gradient."""
    dev, f32 = entries.device, torch.float32
    t_n, p, chunk = t1 - t0, cfg.tile * cfg.tile, cfg.chunk
    n = counts[:, None, None]
    fx, fy = cfg.width / (2.0 * cam.tanfovx), cfg.height / (2.0 * cam.tanfovy)
    tid = torch.arange(t0, t1, device=dev)
    pid = torch.arange(p, device=dev)
    px = ((tid % cfg.tiles_x) * cfg.tile).to(f32)[:, None, None] + (pid % cfg.tile).to(f32) + 0.5
    py = ((tid // cfg.tiles_x) * cfg.tile).to(f32)[:, None, None] + (pid // cfg.tile).to(f32) + 0.5
    dx, dy = (px - cfg.width / 2.0) / fx, (py - cfg.height / 2.0) / fy
    kk = torch.arange(chunk, device=dev)[None, :, None]
    nrm = cfg.dist_far / (cfg.dist_far - cfg.dist_near)

    def zeros():
        return torch.zeros((t_n, 1, p), dtype=f32, device=dev)

    t_run, a_run, m1_run, m2_run = torch.ones_like(zeros()), zeros(), zeros(), zeros()
    acc = [zeros() for _ in range(9)]
    med = zeros()
    ndone = torch.zeros((t_n,), dtype=torch.int64, device=dev)
    for k0 in range(0, cfg.tile_budget, chunk):
        active = (k0 < n) & (torch.amax(t_run, dim=2, keepdim=True) >= cfg.transmittance_min)
        if not bool(active.any()):
            break
        ndone = ndone + active[:, 0, 0]
        rows = entries[:, k0:k0 + chunk]
        cx, cy, cz, au0, au1, au2, bv0, bv1, bv2, rr, gg, bb, op = (
            rows[..., c:c + 1] for c in range(13))
        n0, n1, n2 = au1 * bv2 - au2 * bv1, au2 * bv0 - au0 * bv2, au0 * bv1 - au1 * bv0
        inv = 1.0 / torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20)
        sgn = torch.where(cx * n0 + cy * n1 + cz * n2 <= 0.0, inv, -inv)
        n0, n1, n2 = n0 * sgn, n1 * sgn, n2 * sgn
        cz_s = torch.where(torch.abs(cz) < 1e-6, 1e-6, cz)
        c2x, c2y = fx * cx / cz_s + cfg.width / 2.0, fy * cy / cz_s + cfg.height / 2.0
        nd = n0 * dx + n1 * dy + n2
        nc = n0 * cx + n1 * cy + n2 * cz
        nd_ok = torch.abs(nd) >= 1e-8
        tt = nc / torch.where(nd_ok, nd, 1e-8)
        u = tt * (au0 * dx + au1 * dy + au2) - (au0 * cx + au1 * cy + au2 * cz)
        v = tt * (bv0 * dx + bv1 * dy + bv2) - (bv0 * cx + bv1 * cy + bv2 * cz)
        rho3 = torch.where(nd_ok, u * u + v * v, torch.inf)
        rho2 = cfg.filter2d_invsq * ((px - c2x) ** 2 + (py - c2y) ** 2)
        use3 = rho3 <= rho2
        depth = torch.where(use3, tt, cz)
        alpha = torch.clamp(op * torch.exp(-0.5 * torch.where(use3, rho3, rho2)), max=0.99)
        keep = (alpha >= cfg.alpha_min) & (depth >= cfg.near_cull) & (op > 0.0) & (k0 + kk < n)
        alpha = torch.where(keep, alpha, 0.0)
        log_t = torch.log1p(-alpha)
        t_ex = t_run * torch.exp(torch.cumsum(log_t, 1) - log_t)
        w = torch.where(t_ex * (1.0 - alpha) >= cfg.transmittance_min, alpha * t_ex, 0.0)
        m = torch.where(w > 0.0, nrm * (1.0 - cfg.dist_near / torch.clamp(depth, min=1e-6)), 0.0)
        wm, wm2 = w * m, w * m * m
        a_ex = a_run + torch.cumsum(w, 1) - w
        m1_ex = m1_run + torch.cumsum(wm, 1) - wm
        m2_ex = m2_run + torch.cumsum(wm2, 1) - wm2
        a_add = w.sum(1, keepdim=True)
        parts = [(w * x).sum(1, keepdim=True) for x in (rr, gg, bb)]
        parts += [a_add, (w * depth).sum(1, keepdim=True)]
        parts += [(w * x).sum(1, keepdim=True) for x in (n0, n1, n2)]
        parts.append((w * (m * m * a_ex + m2_ex - 2.0 * m * m1_ex)).sum(1, keepdim=True))
        midx = torch.amax(torch.where((t_ex > 0.5) & (w > 0.0), kk, -1), dim=1, keepdim=True)
        dsel = torch.gather(depth.detach(), 1, torch.clamp(midx, min=0))
        med = torch.where(active & (midx >= 0), dsel, med)
        acc = [torch.where(active, a + pa, a) for a, pa in zip(acc, parts)]
        t_run = torch.where(active, t_run * torch.exp(log_t.sum(1, keepdim=True)), t_run)
        a_run = torch.where(active, a_run + a_add, a_run)
        m1_run = torch.where(active, m1_run + wm.sum(1, keepdim=True), m1_run)
        m2_run = torch.where(active, m2_run + wm2.sum(1, keepdim=True), m2_run)
    r, g, b, a, dsum, nx, ny, nz, dist = acc
    return torch.cat([r, g, b, a, dsum, med, nx, ny, nz, dist], 1), ndone


def blend_blocks(entries, counts, cam: Cam, cfg: RasterConfig):
    """`blend` of every tile, in blocks of tiles: (accumulators [T, 10, P],
    chunks taken [T])."""
    n_tiles = entries.shape[0]
    block = max(1, TILE_BLOCK_PIXELS // (cfg.tile * cfg.tile))
    parts = [blend(entries[t0:t0 + block], counts[t0:t0 + block], cam, cfg,
                   t0, min(t0 + block, n_tiles)) for t0 in range(0, n_tiles, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def composite(packed, bn: Binned, cam: Cam, bg, cfg: RasterConfig):
    """Per-pixel maps of a binned view: (image, alpha, expected depth,
    camera-space normal, distortion)."""
    rows = packed[bn.order]
    entries = torch.where(bn.valid[..., None], rows[bn.windows], 0.0)
    out = blend_blocks(entries, bn.counts, cam, cfg)[0]
    t = cfg.tile

    def image(x):
        ch = x.shape[2:]
        x = x.reshape(cfg.tiles_y, cfg.tiles_x, t, t, *ch)
        return x.transpose(1, 2).reshape(cfg.height, cfg.width, *ch)

    ch = out.transpose(1, 2)
    alpha = image(ch[..., 3])
    dsum = image(ch[..., 4])
    return (image(ch[..., 0:3]) + (1.0 - alpha)[..., None] * bg, alpha,
            torch.where(alpha > 1e-6, dsum / torch.clamp(alpha, min=1e-6), 0.0),
            image(ch[..., 6:9]), image(ch[..., 9]))


def depth_to_normal(rays, depth):
    pts = rays[..., :3] + depth[..., None] * rays[..., 3:6]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    nn_ = torch.linalg.cross(dx, dy, dim=-1)
    nn_ = nn_ * torch.rsqrt(torch.sum(nn_ * nn_, -1, keepdim=True) + 1e-20)
    return torch.nn.functional.pad(nn_, (0, 0, 1, 1, 1, 1))


def render_view(cam: Cam, rays, centers, shs, opacity_raw, scaling_raw, rotation_raw,
                bg, cfg: RasterConfig, keep=None, binned=None):
    """One view's frame dict (image, depth, acc_map, rend_normal,
    rend_dist, depth_normal) and its binning. With `binned` (the coarse
    render's) the windows are kept and only colours and opacities change;
    `keep` False renders a surfel as absent."""
    opac = torch.sigmoid(opacity_raw.reshape(-1))
    if keep is not None:
        opac = torch.where(keep, opac, 0.0)
    g = preprocess(centers, shs, opac, torch.exp(scaling_raw), l2_normalize(rotation_raw),
                   cam, cfg)
    if binned is None:
        binned = bin_view(g, cfg)
    image, alpha, depth, normal, dist = composite(pack(g), binned, cam, bg, cfg)
    frame = {"image": torch.clamp(image, 0.0, 1.0), "depth": depth[..., None],
             "acc_map": alpha, "rend_normal": normal @ cam.w2c[:3, :3], "rend_dist": dist}
    frame["depth_normal"] = depth_to_normal(rays, depth) * alpha.detach()[..., None]
    return frame, binned


def stack_frames(frames):
    return {k: torch.stack([torch.stack([f[k] for f in row]) for row in frames])
            for k in frames[0][0]}
