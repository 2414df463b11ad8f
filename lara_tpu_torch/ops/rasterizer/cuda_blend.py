"""Per-tile surfel compositing: the hand-written CUDA kernel and its plain
PyTorch version — the counterpart of `lara_tpu/ops/rasterizer/pallas_blend.py`
(forward only; the backward kernels belong to training).

`blend_tiles` launches `csrc/blend_fwd.cu` for CUDA tensors and raises if the
kernel cannot be built or launched; for CPU tensors it runs
`blend_tiles_reference`. Both return the same raw accumulators
[T, NUM_CHANNELS, tile²]: rgb, alpha, depth sum, median depth, normal xyz,
distortion (no background blend, unnormalized depth).

The library is compiled at first use with nvcc into
`build/lara_tpu_torch/` of the checkout, keyed by a hash of the source and
flags, and bound with ctypes (plain C entry point, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig

NUM_CHANNELS = 10   # rgb3 + alpha + depth_sum + depth_med + normal3 + dist
PACK_COLS = 13
MAX_CHUNK = 512     # 19 staged f32 per entry must fit 48 KB of shared memory

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "blend_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "lara_tpu_torch"
# --fmad=false: every product and sum rounds on its own, as in the plain
# version's elementwise ops, so alpha is computed bit for bit alike and the
# alpha >= alpha_min cull takes the same decisions in both
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]
_lib = None
build_log = ""      # nvcc's output (registers, shared memory) of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the blend library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"blend_fwd_{key}.so"
    if not so_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)
        build_log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so_path))
    fn = lib.lara_blend_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


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
    if not 0 < cfg.pallas_chunk <= MAX_CHUNK or k % cfg.pallas_chunk:
        raise ValueError(f"pallas_chunk {cfg.pallas_chunk} must divide the "
                         f"tile budget {k} and be at most {MAX_CHUNK}")
    if p > 1024:
        raise ValueError("one thread per pixel: tile² must be ≤ 1024")
    return t, p


def blend_tiles(entries: torch.Tensor, counts: torch.Tensor,
                scalars: torch.Tensor, cfg: RasterizeConfig) -> torch.Tensor:
    """entries [T, K, 13] depth-sorted per-tile windows; counts [T] int32;
    scalars [2] = (tanfovx, tanfovy). Returns raw accumulators
    [T, NUM_CHANNELS, tile²]. CUDA tensors launch the kernel (and count the
    launch in `blend_tiles.launches`); CPU tensors take the plain version."""
    t, p = _check_inputs(entries, counts, scalars, cfg)
    dev = entries.device
    if dev.type == "cpu":
        return blend_tiles_reference(entries, counts, scalars, cfg)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles runs on cuda or cpu tensors, not {dev}")
    for name, x in (("counts", counts), ("scalars", scalars)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, entries on {dev}")
    entries, counts, scalars = (x.contiguous() for x in (entries, counts, scalars))
    lib = build_library()
    out = torch.empty((t, NUM_CHANNELS, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lara_blend_fwd(
            entries.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
            out.data_ptr(), t, cfg.tiles_x, cfg.tile, cfg.width, cfg.height,
            cfg.tile_budget, cfg.pallas_chunk, cfg.alpha_min,
            cfg.transmittance_min, cfg.near_cull, cfg.dist_near, cfg.dist_far,
            cfg.filter2d_invsq, stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed (cudaError {err})")
    blend_tiles.launches += 1
    return out


blend_tiles.launches = 0


def blend_tiles_reference(entries: torch.Tensor, counts: torch.Tensor,
                          scalars: torch.Tensor, cfg: RasterizeConfig) -> torch.Tensor:
    """Plain PyTorch version of the blend: `_chunk_fn` + the `_fwd_one_tile`
    chunk loop of the TPU kernel, vectorized over tiles. Log-domain
    transmittance with an inclusive cumsum per chunk (pallas_cumsum
    "shift"); a tile stops taking chunks once its count is exhausted or
    every pixel's transmittance is below `transmittance_min`."""
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
    for k0 in range(0, cfg.tile_budget, chunk):
        active = (k0 < n) & (torch.amax(t_run, dim=2, keepdim=True) >= cfg.transmittance_min)
        if not bool(active.any()):
            break
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
        dsel = torch.gather(depth, 1, torch.clamp(midx, min=0))
        new_med = torch.where(midx >= 0, dsel, med)

        acc = [torch.where(active, a + pa, a) for a, pa in zip(acc, partials)]
        med = torch.where(active, new_med, med)
        t_run = torch.where(active, t_run * torch.exp(log_t.sum(1, keepdim=True)), t_run)
        a_run = torch.where(active, a_run + a_add, a_run)
        m1_run = torch.where(active, m1_run + wm.sum(1, keepdim=True), m1_run)
        m2_run = torch.where(active, m2_run + wm2.sum(1, keepdim=True), m2_run)

    img_r, img_g, img_b, a_acc, dsum, nx, ny, nz, dist = acc
    return torch.cat([img_r, img_g, img_b, a_acc, dsum, med, nx, ny, nz, dist], dim=1)
