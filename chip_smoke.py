#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: require CUDA, print `nvidia-smi` name and power limit;
  2. build the blend kernel from `lara_tpu_torch/csrc/blend_fwd.cu`;
  3. kernel vs plain version (`blend_tiles_reference`) on a random
     524,288-surfel scene at 512², binned at the train (budget 128) and eval
     (budget 512) raster configs, plus opaque, empty-tile and over-budget
     cases; max error per channel and median ms per call of both;
  4. three flagship-width serving requests (B=1, 4+4 views at 512², seeded
     random weights) through `make_forward`, each checked for shapes,
     finite values, coverage and exactly 16 kernel launches; then one
     request with the blend swapped for the plain version;
  5. a JSON line describing the kernel, the `nvidia-smi` line, and as the
     last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lara_tpu_torch.config import Config
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.train.step import make_forward
from lara_tpu_torch.utils.camera import Camera, build_rays_np, fov_to_ixt, invert_rigid

H = W = 512
N_SURFELS = 524288                     # 64³ voxels × K=2, the flagship scene
FOV = 0.8
# blend tolerances (tests/test_pallas.py): channels 4 (depth sum) and 5
# (median) at 1e-3, the rest at 2e-4; the median may flip on ≤ 0.1% of pixels
# whose transmittance sits at 0.5
ATOL = [2e-4, 2e-4, 2e-4, 2e-4, 1e-3, 1e-3, 2e-4, 2e-4, 2e-4, 2e-4]
MEDIAN_MAX_FLIPS = 1e-3
SLICE_ATOL = 1e-3
CHANNELS = ["r", "g", "b", "alpha", "depth_sum", "median", "nx", "ny", "nz", "dist"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def orbit_c2ws(n: int) -> np.ndarray:
    """n cameras on a circle of radius 2 around the origin, looking at it
    (the poses of tests/test_model.py:synthetic_batch)."""
    c2ws = []
    for i in range(n):
        ang = i * (2 * np.pi / n) + 0.3
        eye = np.array([2.0 * np.sin(ang), 0.4, -2.0 * np.cos(ang)], np.float32)
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        c2ws.append(c2w)
    return np.stack(c2ws)


def make_batch(seed: int, n_views: int, device) -> dict:
    """One B=1 request in the reference schema, built with numpy as
    tests/test_model.py:synthetic_batch builds it (first n_views views are
    inputs, the rest novel views)."""
    rng = np.random.default_rng(seed)
    n = 2 * n_views
    ixt = fov_to_ixt(np.array([FOV, FOV]), np.array([W, H]))
    c2ws = orbit_c2ws(n)
    r = np.linalg.norm(c2ws[0, :3, 3])
    ixts = np.tile(ixt[None], (n, 1, 1))
    batch = {
        "tar_rgb": rng.uniform(size=(1, n, H, W, 3)).astype(np.float32),
        "tar_c2w": c2ws[None],
        "tar_w2c": np.linalg.inv(c2ws)[None],
        "tar_ixt": ixts[None],
        "tar_rays": build_rays_np(c2ws, ixts, H, W, 1.0)[None],
        "tar_rays_down": build_rays_np(c2ws, ixts, H, W, 1.0 / 16)[None],
        "near_far": np.array([[r - 0.8, r + 0.8]], np.float32),
        "fovx": np.full((1,), FOV, np.float32),
        "fovy": np.full((1,), FOV, np.float32),
        "bg_color": np.ones((1, n, 3), np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def camera(device) -> Camera:
    c2w = torch.from_numpy(orbit_c2ws(1)[0]).to(device)
    tan = torch.tan(torch.tensor(0.5 * FOV, device=device))
    return Camera(w2c=invert_rigid(c2w), campos=-c2w[:3, 3], tanfovx=tan,
                  tanfovy=tan, near=torch.tensor(1.2, device=device),
                  far=torch.tensor(2.8, device=device))


def random_scene(n: int, seed: int, device, extent=0.5, corner=False):
    """Surfels with the statistics of the coarse decoder at init: centers in
    the scene box, scales around the voxel-size shift, opacities around
    sigmoid(-2.18). `corner` packs them into one small region instead."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3))
    if corner:
        means = means * 0.1 + np.array([0.25, 0.25, 0.0])
    shs = rng.normal(size=(n, 4, 3)) * 0.3
    shs[:, 0, :] += 1.0
    op = 1.0 / (1.0 + np.exp(-rng.normal(-2.18, 1.5, n)))
    scales = np.exp(rng.normal(np.log(0.5 * (2.0 / 64) / 3.0), 0.5, (n, 2)))
    quats = rng.normal(size=(n, 4))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (means, shs, op, scales, quats))


def opaque_stack(device, n=48):
    """Opaque surfels stacked along the view axis: tiles exit early."""
    cam_dir = -orbit_c2ws(1)[0][:3, 3] / 2.0
    t = np.linspace(-0.3, 0.3, n)[:, None]
    means = t * cam_dir[None]
    shs = np.zeros((n, 4, 3))
    shs[:, 0, :] = 1.0
    op = np.full((n,), 0.97)
    scales = np.full((n, 2), 0.3)
    quats = np.tile([[1.0, 0.0, 0.0, 0.0]], (n, 1))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (means, shs, op, scales, quats))


def windows(scene, cfg, cam):
    g = preprocess_surfels(*scene, cam, cfg)
    packed, binned = bin_view(g, cfg)
    entries = window_gather(packed, binned.win_gidx).contiguous()
    scalars = torch.stack([cam.tanfovx, cam.tanfovy]).float()
    return entries, binned.counts, scalars


def median_ms(fn, reps):
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_case(name, entries, counts, scalars, cfg, timed=False):
    got = cuda_blend.blend_tiles(entries, counts, scalars, cfg)
    torch.cuda.synchronize()
    want = cuda_blend.blend_tiles_reference(entries, counts, scalars, cfg)
    err = (got - want).abs().amax(dim=(0, 2)).tolist()
    flips = ((got[:, 5] - want[:, 5]).abs() > ATOL[5]).float().mean().item()
    over = [int(((got[:, c] - want[:, c]).abs() > ATOL[c]).sum()) for c in range(len(ATOL))]
    busy = (counts > 0).float().mean().item()
    print(f"[kernel] {name}: budget {cfg.tile_budget} chunk {cfg.pallas_chunk} "
          f"tiles with entries {busy:.3f} mean count {counts.float().mean().item():.1f} "
          f"max alpha {want[:, 3].max().item():.4f}")
    print("[kernel] " + name + " max |kernel - plain| per channel: "
          + " ".join(f"{c}={e:.3e}" for c, e in zip(CHANNELS, err))
          + f" median-flip share={flips:.2e} pixels over tolerance per channel {over}")
    for c, (e, tol) in enumerate(zip(err, ATOL)):
        if c != 5 and not e <= tol:
            raise AssertionError(f"{name}: channel {CHANNELS[c]} differs by {e} > {tol}")
    if not flips <= MEDIAN_MAX_FLIPS:
        raise AssertionError(f"{name}: median differs on {flips:.2%} of pixels")
    res = {"max_abs_err": max(e for c, e in enumerate(err) if c != 5)}
    if timed:
        res["ms"] = median_ms(lambda: cuda_blend.blend_tiles(entries, counts, scalars, cfg), 30)
        res["plain_ms"] = median_ms(
            lambda: cuda_blend.blend_tiles_reference(entries, counts, scalars, cfg), 5)
        print(f"[kernel] {name}: median ms per call kernel {res['ms']:.4f} "
              f"plain {res['plain_ms']:.4f}")
    return res


def kernel_phase(dev) -> dict:
    cam = camera(dev)
    scene = random_scene(N_SURFELS, 0, dev)
    results = {}
    for name, budget, visible in (("train", 128, 131072), ("eval", 512, 262144)):
        cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                              visible_budget=visible, pallas_chunk=min(64, budget))
        entries, counts, scalars = windows(scene, cfg, cam)
        results[name] = compare_case(name, entries, counts, scalars, cfg, timed=True)
        if name == "eval":
            over = counts + 300        # raw counts past the budget: clamped to K
            results["over_budget"] = compare_case("over_budget", entries, over, scalars, cfg)
    cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=512,
                          visible_budget=262144, pallas_chunk=64)
    results["opaque"] = compare_case("opaque", *windows(opaque_stack(dev), cfg, cam), cfg)
    corner = random_scene(4096, 1, dev, corner=True)
    results["empty_tiles"] = compare_case("empty_tiles", *windows(corner, cfg, cam), cfg)
    return results


def check_outputs(out: dict, n_views: int):
    for key in ("image", "depth", "acc_map", "rend_normal", "rend_dist", "depth_normal"):
        for k in (key, key + "_fine"):
            want = {"image": (3,), "depth": (1,), "rend_normal": (3,),
                    "depth_normal": (3,)}.get(key, ())
            shape = (1, 2 * n_views, H, W) + want
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{k}: non-finite values")
    for k in ("acc_map", "acc_map_fine"):
        if not out[k].max().item() > 0.0:
            raise AssertionError(f"{k} is zero everywhere")


def slice_phase(dev) -> dict:
    cfg = Config()
    n_views = cfg.n_views
    t0 = time.perf_counter()
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    fwd = make_forward(net, with_fine=True)
    batches = [make_batch(seed, n_views, dev) for seed in range(3)]
    torch.cuda.synchronize()
    print(f"[slice] flagship Config(): {sum(p.numel() for p in net.parameters())} "
          f"parameters, set-up {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_blend.blend_tiles.launches = 0
    seconds, first = [], None
    for i, batch in enumerate(batches):
        before = cuda_blend.blend_tiles.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launched = cuda_blend.blend_tiles.launches - before
        check_outputs(out, n_views)
        if launched != 4 * n_views:
            raise AssertionError(f"request {i}: {launched} kernel launches, "
                                 f"expected {4 * n_views}")
        print(f"[slice] request {i}: {seconds[-1]:.4f} s, {launched} kernel launches, "
              f"max acc_map {out['acc_map'].max().item():.4f} "
              f"mean acc_map_fine {out['acc_map_fine'].mean().item():.4f}")
        if first is None:
            first = out["image_fine"].clone()
        del out
    launches = cuda_blend.blend_tiles.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[slice] seconds per request: {' '.join(f'{s:.4f}' for s in seconds)}; "
          f"peak device memory {peak_gb:.2f} GB")

    kernel = cuda_blend.blend_tiles
    cuda_blend.blend_tiles = cuda_blend.blend_tiles_reference
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = fwd(batches[0])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        cuda_blend.blend_tiles = kernel
    diff = (plain["image_fine"] - first).abs().max().item()
    print(f"[slice] request 0 with the plain blend: {plain_s:.4f} s; "
          f"max |image_fine kernel - plain| = {diff:.3e}")
    if not diff <= SLICE_ATOL:
        raise AssertionError(f"slice: kernel and plain blend differ by {diff}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    t0 = time.perf_counter()
    cuda_blend.build_library()
    print(f"[build] blend_fwd library ready in {time.perf_counter() - t0:.2f} s")
    for line in cuda_blend.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    kernel = kernel_phase(dev)
    slice_res = slice_phase(dev)

    record = {
        "name": "blend_fwd", "route": "cuda",
        "source": "lara_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "lara_tpu/ops/rasterizer/pallas_blend.py:303",
        "launches": slice_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": kernel["eval"]["ms"], "plain_ms": kernel["eval"]["plain_ms"],
    }
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
