#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (the script then exits non-zero);
each prints its seconds:
  1. device: require CUDA, print `nvidia-smi` name and power limit; TF32
     off in matmuls and cuDNN convolutions;
  2. build both blend kernels (`lara_tpu_torch/csrc/blend_{fwd,bwd}.cu`,
     one nvcc each, started together);
  3. forward kernel vs plain version (`blend_tiles_reference`) on a random
     524,288-surfel scene at 512², binned at the train (budget 128) and eval
     (budget 512) raster configs, plus opaque, empty-tile and over-budget
     cases; max error per channel and median ms per call of both;
  4. backward: the stash forward and `blend_bwd` at the train raster config
     (random scene, over-budget, opaque, empty tiles) with a seeded random
     cotangent, against autograd of the plain version: processed-chunk
     counts equal, stashed carries, per-column gradient error, the stash
     forward's accumulators bit for bit those of the plain forward kernel;
     median ms of both kernels and of their plain versions;
  5. serving: two flagship-width requests (B=1, 4+4 views at 512², seeded
     random weights) through `make_forward`, each checked for shapes,
     finite values, coverage and exactly 16 forward launches; then one
     request with the blend swapped for the plain version;
  6. training, reduced config (tests/test_model.py:tiny_config at 128², f32):
     one fine micro-step through the kernels and one through the plain
     blend give the same loss and gradients; 10 optimizer steps on one
     batch lower the loss;
  7. training, flagship `Config()` at B=3 (4+4 views at 512², bf16
     autocast): one coarse micro-step and four fine micro-steps (two AdamW
     updates) from micro-step 2002, each with exactly 24 or 48 stash-forward
     and backward launches, finite stats, a gradient in every stage, and
     parameters changed only on the second micro-step of a pair; then one
     `make_eval_step` call;
  8. a JSON line describing the kernels, the `nvidia-smi` line, and as the
     last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lara_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.train.loss import compute_losses
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_eval_step, make_forward, make_train_step
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
# gradient bar of tests/test_pallas.py: |kernel - plain| <= 5e-4 + 1e-3 |plain|
# per element; a share of the processed rows up to GRAD_MAX_FLIPS may miss
# it where a threshold decision (the log-domain vs multiplicative
# transmittance test) flips between the two versions
GRAD_ATOL, GRAD_RTOL, GRAD_MAX_FLIPS = 5e-4, 1e-3, 1e-3
COLUMNS = ["cx", "cy", "cz", "au0", "au1", "au2", "bv0", "bv1", "bv2",
           "r", "g", "b", "op"]
# kernel path vs plain blend at the reduced train config: every parameter
# gradient within this relative L2 difference (the bar of
# tests/test_torch_train.py against the JAX package)
TRAIN_GRAD_RTOL = 5e-3
STAGES = ("img_encoder.", "vol_decoder.", "decoder.mlp_coarse.", "decoder.mlp_fine.")
CHANNELS = ["r", "g", "b", "alpha", "depth_sum", "median", "nx", "ny", "nz", "dist"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def orbit_c2ws(n: int, turn: float = 0.0) -> np.ndarray:
    """n cameras on a circle of radius 2 around the origin, looking at it
    (the poses of tests/test_model.py:synthetic_batch), turned by `turn`."""
    c2ws = []
    for i in range(n):
        ang = i * (2 * np.pi / n) + 0.3 + turn
        eye = np.array([2.0 * np.sin(ang), 0.4, -2.0 * np.cos(ang)], np.float32)
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        c2ws.append(c2w)
    return np.stack(c2ws)


def make_batch(seed: int, n_views: int, device, scenes: int = 1, size: int = H) -> dict:
    """`scenes` scenes of 2·n_views views at size², in the reference schema,
    built with numpy as tests/test_model.py:synthetic_batch builds them
    (the first n_views views are inputs, the rest novel views); scene s
    has random colors from seed + s and its orbit turned by s radians."""
    rng = np.random.default_rng(seed)
    n = 2 * n_views
    ixt = fov_to_ixt(np.array([FOV, FOV]), np.array([size, size]))
    ixts = np.tile(ixt[None], (n, 1, 1))
    rows = []
    for s in range(scenes):
        c2ws = orbit_c2ws(n, turn=float(s))
        r = np.linalg.norm(c2ws[0, :3, 3])
        rows.append({
            "tar_rgb": rng.uniform(size=(n, size, size, 3)),
            "tar_c2w": c2ws,
            "tar_w2c": np.linalg.inv(c2ws),
            "tar_ixt": ixts,
            "tar_rays": build_rays_np(c2ws, ixts, size, size, 1.0),
            "tar_rays_down": build_rays_np(c2ws, ixts, size, size, 1.0 / 16),
            "near_far": np.array([r - 0.8, r + 0.8]),
            "fovx": np.array(FOV),
            "fovy": np.array(FOV),
            "bg_color": np.ones((n, 3)),
        })
    return {k: torch.from_numpy(np.stack([row[k] for row in rows]).astype(np.float32)).to(device)
            for k in rows[0]}


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
    entries = window_gather(packed, binned.win_gidx, binned.entry_valid).contiguous()
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


def train_raster_cfg():
    return RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=128,
                           visible_budget=131072, pallas_chunk=64)


def backward_case(name, entries, counts, scalars, cfg, seed, timed=False):
    """The stash forward and the backward kernel against the plain version
    and its autograd, on one set of windows and a seeded random cotangent."""
    gen = torch.Generator().manual_seed(seed)
    cot = torch.randn((cfg.num_tiles, cuda_blend.NUM_CHANNELS, cfg.tile ** 2),
                      generator=gen).to(entries.device)
    out_s, carries, ndone = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)
    out = cuda_blend.blend_fwd(entries, counts, scalars, cfg)
    grad = cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone, cot, cfg)
    torch.cuda.synchronize()
    if not torch.equal(out_s, out):
        raise AssertionError(f"{name}: the stash forward's accumulators differ from the forward's")

    e = entries.clone().requires_grad_(True)
    want, carries_p, ndone_p = cuda_blend.blend_tiles_reference(
        e, counts, scalars, cfg, return_stash=True)
    (grad_p,) = torch.autograd.grad(want, e, cot, retain_graph=timed)
    if not torch.equal(ndone, ndone_p):
        bad = int((ndone != ndone_p).sum())
        raise AssertionError(f"{name}: processed-chunk count differs on {bad} tiles")
    # carries of the processed slots (0..ndone); T only where a version has
    # the pixel alive: a dead pixel keeps another value below t_min in each
    slot = torch.arange(carries.shape[1], device=entries.device)
    used = (slot[None, :] <= ndone[:, None])[:, :, None]
    alive = (carries[:, :, 0] >= cfg.transmittance_min) | (carries_p[:, :, 0] >= cfg.transmittance_min)
    carry_err = [torch.where(used & alive if j == 0 else used,
                             (carries[:, :, j] - carries_p[:, :, j]).abs(), 0.0).amax().item()
                 for j in range(4)]
    if not max(carry_err) <= ATOL[0]:
        raise AssertionError(f"{name}: stashed carries differ by {carry_err}")

    diff = (grad - grad_p).abs()
    over = diff > GRAD_ATOL + GRAD_RTOL * grad_p.abs()
    rows = (torch.arange(cfg.tile_budget, device=e.device)[None, :]
            < torch.clamp(counts, max=cfg.tile_budget)[:, None])
    flips = over.any(-1).sum().item() / max(1, int(rows.sum()))
    col_err = diff.amax(dim=(0, 1)).tolist()
    scale = grad_p.abs().amax(dim=(0, 1)).tolist()
    print(f"[backward] {name}: ndone equal ({int(ndone.sum())} chunks), carries max err "
          + " ".join(f"{e_:.2e}" for e_ in carry_err)
          + f"; rows over the bar {flips:.2e} of {int(rows.sum())}")
    print(f"[backward] {name} max |kernel - plain| per column (max |plain|): "
          + " ".join(f"{c}={e_:.2e}({s_:.1e})" for c, e_, s_ in zip(COLUMNS, col_err, scale)))
    if not flips <= GRAD_MAX_FLIPS:
        raise AssertionError(f"{name}: gradients differ beyond the bar on {flips:.2%} of rows")
    if bool(grad[~rows].any()):
        raise AssertionError(f"{name}: rows past the count have nonzero gradients")
    fwd_err = (out_s - want.detach()).abs().amax(dim=(0, 2))
    res = {"max_abs_err": max(col_err), "flips": flips,
           "fwd_max_abs_err": max(e_ for c, e_ in enumerate(fwd_err.tolist()) if c != 5)}
    if timed:
        res["bwd_ms"] = median_ms(lambda: cuda_blend.blend_bwd(
            entries, counts, scalars, carries, ndone, cot, cfg), 30)
        res["bwd_plain_ms"] = median_ms(
            lambda: torch.autograd.grad(want, e, cot, retain_graph=True), 5)
        res["fwd_stash_ms"] = median_ms(lambda: cuda_blend.blend_fwd(
            entries, counts, scalars, cfg, stash=True), 30)
        with torch.enable_grad():
            res["fwd_stash_plain_ms"] = median_ms(lambda: cuda_blend.blend_tiles_reference(
                e, counts, scalars, cfg), 5)
        print(f"[backward] {name}: median ms per call: backward kernel {res['bwd_ms']:.4f} "
              f"plain autograd backward {res['bwd_plain_ms']:.4f}; stash forward kernel "
              f"{res['fwd_stash_ms']:.4f} plain forward under autograd "
              f"{res['fwd_stash_plain_ms']:.4f}")
    return res


def backward_phase(dev) -> dict:
    """Both kernels of a training render at the train raster config."""
    cam = camera(dev)
    cfg = train_raster_cfg()
    entries, counts, scalars = windows(random_scene(N_SURFELS, 0, dev), cfg, cam)
    results = {"train": backward_case("train", entries, counts, scalars, cfg, 1, timed=True)}
    results["over_budget"] = backward_case("over_budget", entries, counts + 300, scalars, cfg, 2)
    results["opaque"] = backward_case("opaque", *windows(opaque_stack(dev), cfg, cam), cfg, 3)
    corner = random_scene(4096, 1, dev, corner=True)
    results["empty_tiles"] = backward_case("empty_tiles", *windows(corner, cfg, cam), cfg, 4)
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
    """The serving path: flagship requests through `make_forward`."""
    cfg = Config()
    n_views = cfg.n_views
    t0 = time.perf_counter()
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    fwd = make_forward(net, with_fine=True)
    batches = [make_batch(seed, n_views, dev) for seed in range(2)]
    torch.cuda.synchronize()
    print(f"[slice] flagship Config(): {sum(p.numel() for p in net.parameters())} "
          f"parameters, set-up {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_blend.reset_launches()
    seconds, first = [], None
    for i, batch in enumerate(batches):
        before = dict(cuda_blend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in cuda_blend.LAUNCHES.items()}
        check_outputs(out, n_views)
        if launched != {"blend_fwd": 4 * n_views, "blend_fwd_stash": 0, "blend_bwd": 0}:
            raise AssertionError(f"request {i}: kernel launches {launched}, expected "
                                 f"{4 * n_views} of blend_fwd and no other")
        print(f"[slice] request {i}: {seconds[-1]:.4f} s, {launched['blend_fwd']} kernel "
              f"launches, max acc_map {out['acc_map'].max().item():.4f} "
              f"mean acc_map_fine {out['acc_map_fine'].mean().item():.4f}")
        if first is None:
            first = out["image_fine"].clone()
        del out
    launches = dict(cuda_blend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[slice] seconds per request: {' '.join(f'{s:.4f}' for s in seconds)}; "
          f"peak device memory {peak_gb:.2f} GB")

    with plain_blend():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = fwd(batches[0])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    diff = (plain["image_fine"] - first).abs().max().item()
    print(f"[slice] request 0 with the plain blend: {plain_s:.4f} s; "
          f"max |image_fine kernel - plain| = {diff:.3e}")
    if not diff <= SLICE_ATOL:
        raise AssertionError(f"slice: kernel and plain blend differ by {diff}")
    return launches


@contextlib.contextmanager
def plain_blend():
    """Swap the kernels' wrapper for the plain version (on the card's
    tensors) for a comparison run."""
    kernel = cuda_blend.blend_tiles
    cuda_blend.blend_tiles = cuda_blend.blend_tiles_reference
    try:
        yield
    finally:
        cuda_blend.blend_tiles = kernel


def reduced_config() -> Config:
    """tests/test_model.py:tiny_config (2 input views), at 128² here."""
    return Config(
        n_views=2,
        model=ModelConfig(
            encoder_dim=48, encoder_depth=2, encoder_heads=4, patch_size=16,
            n_groups=(4,), K=2, sh_degree=1, num_layers=2, num_heads=4,
            view_embed_dim=8, embedding_dim=64, vol_feat_reso=8,
            vol_embedding_reso=8, vol_embedding_out_dim=32,
            n_offset_groups=16, fine_budget=512),
        render=RenderConfig(tile=16, dup=3, tile_budget=64, tile_chunk=4,
                            eval_tile_budget=64))


def loss_and_grads(net, batch, step):
    net.zero_grad(set_to_none=True)
    out = net(batch, with_fine=True, train=True)
    loss, stats = compute_losses(batch, out, step)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}


def train_reduced_phase(dev) -> dict:
    """(a) One fine micro-step at a reduced config through the kernels and
    through the plain blend, in f32: the loss and every parameter gradient
    agree within TRAIN_GRAD_RTOL. Then 10 optimizer steps on one batch:
    the loss falls."""
    cfg = reduced_config()
    net = LaRaNet(cfg, dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(1)).train()
    batch = make_batch(7, cfg.n_views, dev, size=128)
    n_renders = 2 * 2 * cfg.n_views
    cuda_blend.reset_launches()
    loss_k, grads_k = loss_and_grads(net, batch, 2002)
    if cuda_blend.LAUNCHES != {"blend_fwd": 0, "blend_fwd_stash": n_renders,
                               "blend_bwd": n_renders}:
        raise AssertionError(f"reduced step: launches {cuda_blend.LAUNCHES}")
    with plain_blend():
        loss_p, grads_p = loss_and_grads(net, batch, 2002)
    worst = max(((torch.linalg.vector_norm(grads_k[n] - g)
                  / torch.linalg.vector_norm(g).clamp_min(1e-30)).item(), n)
                for n, g in grads_p.items())
    print(f"[train-a] loss kernels {loss_k:.7f} plain {loss_p:.7f}; worst gradient "
          f"relative L2 difference {worst[0]:.3e} ({worst[1]})")
    if not abs(loss_k - loss_p) <= 1e-5:
        raise AssertionError(f"reduced step: loss {loss_k} vs plain {loss_p}")
    if not worst[0] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"reduced step: gradient of {worst[1]} differs by {worst[0]:.3e}")

    net.zero_grad(set_to_none=True)
    state = TrainState(net, TrainConfig(lr=1e-3, warmup_iters=1, grad_accum=1),
                       max_iters=1000)
    step = make_train_step(net, state, with_fine=True, grad_accum=1)
    losses = [step(batch)["loss"].item() for _ in range(11)]
    print("[train-a] loss over 10 optimizer steps on one batch: "
          + " ".join(f"{v:.5f}" for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"reduced training: the loss does not fall: {losses}")
    return {"max_rel_grad_diff": worst[0]}


def grads_by_stage(net) -> dict:
    """Max |gradient| of each stage; raises if one is missing or not finite."""
    res = {}
    for prefix in STAGES:
        gs = [p.grad for n, p in net.named_parameters() if n.startswith(prefix)]
        if not gs or any(g is None for g in gs):
            raise AssertionError(f"{prefix}: parameters without a gradient")
        if not all(bool(torch.isfinite(g).all()) for g in gs):
            raise AssertionError(f"{prefix}: non-finite gradient")
        res[prefix] = max(g.abs().max().item() for g in gs)
        if not res[prefix] > 0.0:
            raise AssertionError(f"{prefix}: zero gradient")
    return res


def train_flagship_phase(dev) -> dict:
    """(b) The flagship Config() at B=3 (4 + 4 views at 512²), bf16 autocast,
    seeded random weights: one coarse micro-step, then four fine
    micro-steps (two AdamW updates) from micro-step 2002, where the loss
    gates are on and the learning rate is near its peak. (c) One eval step."""
    cfg = Config()
    n_views, scenes = cfg.n_views, cfg.train.batch_size
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch = make_batch(11, n_views, dev, scenes=scenes)
    per_pass = scenes * 2 * n_views                  # renders per coarse or fine pass

    def params():
        return [p.detach().clone() for p in net.parameters()]

    def micro_step(step_fn, i, want_launches):
        before = dict(cuda_blend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = step_fn(batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in cuda_blend.LAUNCHES.items()}
        want = {"blend_fwd": 0, "blend_fwd_stash": want_launches, "blend_bwd": want_launches}
        if launched != want:
            raise AssertionError(f"micro-step {i}: launches {launched}, expected {want}")
        vals = {k: v.item() for k, v in stats.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"micro-step {i}: non-finite stats {vals}")
        print(f"[train-b] micro-step {i}: {sec:.3f} s, loss {vals['loss']:.5f}, "
              f"launches {launched['blend_fwd_stash']} + {launched['blend_bwd']}, "
              f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        return sec, vals

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_blend.reset_launches()
    # coarse-only micro-step (the trainer before train.start_fine)
    state = TrainState(net, cfg.train, max_iters=30000, step=2002)
    p0 = params()
    sec_c, _ = micro_step(make_train_step(net, state, False, cfg.train.grad_accum),
                          "coarse", per_pass)
    if not all(torch.equal(a, b) for a, b in zip(p0, params())):
        raise AssertionError("coarse micro-step: parameters changed on the first micro-step")
    for prefix in STAGES[:3]:
        if not any(p.grad is not None and p.grad.abs().max().item() > 0
                   for n, p in net.named_parameters() if n.startswith(prefix)):
            raise AssertionError(f"coarse micro-step: no gradient in {prefix}")
    net.zero_grad(set_to_none=True)

    state = TrainState(net, cfg.train, max_iters=30000, step=2002)
    step = make_train_step(net, state, True, cfg.train.grad_accum)
    secs, changed = [], []
    for i in range(4):
        before = params()
        sec, vals = micro_step(step, i, 2 * per_pass)
        secs.append(sec)
        if i == 0:
            stage_g = grads_by_stage(net)
            print("[train-b] max |gradient| per stage after micro-step 0: "
                  + " ".join(f"{k}={v:.3e}" for k, v in stage_g.items()))
        changed.append(not all(torch.equal(a, b) for a, b in zip(before, params())))
    if changed != [False, True, False, True]:
        raise AssertionError(f"parameters changed after fine micro-steps {changed}, "
                             "expected only after the second of each pair")
    launches = dict(cuda_blend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[train-b] flagship B={scenes}: coarse micro-step {sec_c:.3f} s; fine micro-steps "
          + " ".join(f"{s:.3f}" for s in secs) + f" s; optimizer step (2 fine micro-steps) "
          f"{secs[2] + secs[3]:.3f} s; peak device memory {peak_gb:.2f} GB; lr {state.schedule(state.opt_step - 1):.3e}")

    # (c) the eval step at the eval budgets, on the first scene
    one = {k: v[:1] for k, v in batch.items()}
    cuda_blend.reset_launches()
    out, stats = make_eval_step(net)(one, state.opt_step)
    check_outputs(out, n_views)
    vals = {k: v.item() for k, v in stats.items()}
    if not all(np.isfinite(list(vals.values()))) or cuda_blend.LAUNCHES["blend_fwd"] != 4 * n_views:
        raise AssertionError(f"eval step: stats {vals}, launches {cuda_blend.LAUNCHES}")
    print(f"[train-c] eval step: loss {vals['loss']:.5f} psnr_fine {vals['psnr_fine']:.3f}")
    return {"launches": launches, "micro_s": secs, "coarse_s": sec_c, "peak_gb": peak_gb}


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
    # float32 everywhere it is asked for: no TF32 in matmuls or cuDNN
    # convolutions (MS-SSIM's blur), deterministic cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
        return res

    phase("build", cuda_blend.build_library)
    for line in cuda_blend.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")
    kernel = phase("forward kernel", kernel_phase, dev)
    backward = phase("backward kernel", backward_phase, dev)
    serving = phase("serving", slice_phase, dev)
    phase("train (reduced)", train_reduced_phase, dev)
    train = phase("train (flagship)", train_flagship_phase, dev)

    bwd = backward["train"]
    records = [
        {"name": "blend_fwd", "route": "cuda",
         "source": "lara_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "lara_tpu/ops/rasterizer/pallas_blend.py:398",
         "launches": serving["blend_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
         "ms": kernel["eval"]["ms"], "plain_ms": kernel["eval"]["plain_ms"]},
        {"name": "blend_fwd_stash", "route": "cuda",
         "source": "lara_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "lara_tpu/ops/rasterizer/pallas_blend.py:398",
         "launches": train["launches"]["blend_fwd_stash"],
         "max_abs_err": max(r["fwd_max_abs_err"] for r in backward.values()),
         "ms": bwd["fwd_stash_ms"], "plain_ms": bwd["fwd_stash_plain_ms"]},
        {"name": "blend_bwd", "route": "cuda",
         "source": "lara_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "lara_tpu/ops/rasterizer/pallas_blend.py:457",
         "launches": train["launches"]["blend_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in backward.values()),
         "ms": bwd["bwd_ms"], "plain_ms": bwd["bwd_plain_ms"]},
    ]
    for r in records:
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its path")
    print(f"[phase] all phases: {time.perf_counter() - start:.2f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
