#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (the script then exits non-zero);
each prints its seconds:
  1. device: require CUDA, print `nvidia-smi` name and power limit; TF32
     off in matmuls and cuDNN convolutions;
  2. build every kernel of `lara_tpu_torch/csrc/` (one nvcc per source,
     started together) and print each kernel's registers and spills (from
     the build logs kept beside the libraries), the blend kernels' shared
     memory and blocks per SM at chunk 64 and budgets 128 and 512 (the
     replay's grows with the budget), the flash kernels' dynamic shared
     memory and (with `cuobjdump`) their HGMMA instructions; fail where ptxas
     serialised a wgmma;
  3. forward kernel vs plain version (`blend_tiles_reference`) on a random
     524,288-surfel scene at 512², binned at the train (budget 128) and eval
     (budget 512) raster configs, plus opaque, empty-tile and over-budget
     cases; max error per channel and queued device ms per call of both;
  4. backward: the stash forward and `blend_bwd` at the train raster config
     (random scene, over-budget, opaque, empty tiles) with a seeded random
     cotangent, against autograd of the plain version: processed-chunk
     counts equal, stashed carries, per-column gradient error, the stash
     forward's accumulators bit for bit those of the plain forward kernel;
     and `blend_bwd_replay` on the same inputs: replayed carries, ndone and
     gradients bit for bit those of the stash path, also at budget 512 /
     chunk 64 and at budget 256 / chunk 8 (32 chunks per tile); two
     backward calls equal bit for bit; queued device ms of the kernels and
     of their plain versions;
  5. flash attention at the ViT's shapes [4, 1025, 12, 64] (serving) and
     [12, 1025, 12, 64] (train) in bf16, a ragged L=200 case with a
     kv_mask, head_dims 16, 48, 80, 96, 112 and 128 at L=257, and f32 at
     head_dim 12 (the reduced check's ViT), q, k, v as views of one fused
     projection: output and dq, dk, dv against autograd of the plain
     version and (bf16) of the blocked plain version, two backward calls
     equal bit for bit; queued device ms of the kernels, the plain version
     and `F.scaled_dot_product_attention` under each backend that runs
     (timed only: the port never calls it);
  6. serving: two flagship-width requests (B=1, 4+4 views at 512², seeded
     random weights) through `make_forward`, each checked for shapes,
     finite values, coverage and exactly 16 forward launches; one request
     with the blend swapped for the plain version; then two requests with
     `flash_attn=True` on the same weights (12 flash launches each),
     `image_fine` against the default path's;
  7. binning, on the `lara_workload` scene (524,288 surfels with trained
     statistics) at the train (K 128, V 131,072) and eval (K 512,
     V 262,144) raster configs: (a) the window kernel `tile_windows`
     against its plain version bit for bit on the real sorted keys and
     starts (and at K 13), and with every window past the keys or partly
     past them; device ms of the kernel, of an empty kernel (the floor of a
     queued launch), the plain version and one `padded[flat]` gather; (b)
     `bin_view` in bin_mode "sort" and "count" and pack_mode "fused":
     counts, validity and windows equal; (c) the blend kernel on
     the three modes' windows, accumulators bit for bit, and the blend
     forward timed at these trained statistics; (d) one serving request
     each with bin_mode "count" and pack_mode "fused" on the serving
     phase's weights (16 blend launches each), `image_fine` against the
     default request's; (e) the binning profiler
     (`lara_tpu_torch.tools.profile_binning.run`) over 8 views, whose
     window-kernel launches are the kernel's count on its path;
  7b. raster tools: (a) the kernels' path, with the stash and with the
     replay backward, against the reference backend
     (`ops/rasterizer/reference.py`: every surfel against every pixel, no
     budgets) at 128² on a 2,000-surfel scene that nothing truncates (no
     radius past the dup clamp, no tile over its budget): every output
     within 2e-4 (the depths 1e-3), the gradients of mean(image) +
     mean(distortion) within 5e-4 + 1e-3 |reference|
     (tests/test_pallas.py:125-138); (b) the
     binned renders of `lara_workload` at the train and eval budgets
     against the reference at 128² (and, in `profile_rasterizer`, 512²):
     their PSNR, not gated; (c)
     each tool of `lara_tpu_torch/tools/` that ports a JAX raster tool
     (`validate_fine_budget`, `sweep_eval_budgets`, `ab_dup`,
     `sweep_chunk`, `ab_kernels`, `profile_rasterizer`, `profile_loss`,
     `profile_input_pipeline` at 256² over 1 and 4 threads) once, at
     reduced repetitions, each printing its JSON line; the top-M renders
     at M at or above the census must equal the mask render bit for bit;
     the blend launches of (c) count on the kernels line;
  8. training, reduced config (tests/test_model.py:tiny_config at 128², f32):
     one fine micro-step through the kernels and one through the plain
     versions give the same loss and gradients, by default and with
     `flash_attn=True` and `pallas_stash_carries=False`; 10 optimizer steps
     on one batch lower the loss;
  9. training, flagship `Config()` at B=3 (4+4 views at 512², bf16
     autocast): one coarse micro-step and four fine micro-steps (two AdamW
     updates) from micro-step 2002, each with exactly its kernel launches,
     finite stats, a gradient in every stage, and parameters changed only
     on the second micro-step of a pair; then one `make_eval_step` call;
     the same again with `flash_attn=True` and `pallas_stash_carries=False`
     (no stash, the replay backward, the flash kernels), and one fine
     micro-step with `remat_policy="dots"` too; seconds and peak memory of
     each beside the default's;
  10. the trainer on `configs/synthetic256.yaml` (the flagship network at
     B=3, 4 + 4 views of synthetic scenes at 256²): a store of 32 scenes
     (12 views each) is written to a temporary directory, then
     `python -m lara_tpu_torch.train`'s `main` runs in this process for 2
     epochs of 9 micro-steps (use_rand_views, the fine stage from
     optimizer step 3, validation, checkpoints and panels each epoch) and
     again to a third epoch, resumed from the second's checkpoint. Every
     train micro-step must launch the stash forward and the backward once
     per render, the plain blend must never run, the scalars must be
     finite; prints the median seconds per coarse and per fine micro-step,
     the loader's scenes per second alone and the share of the run spent
     waiting on it, and peak device memory;
  11. evaluate: `python -m lara_tpu_torch.evaluate`'s `main` in this process,
     (a) on the trainer's last checkpoint over its store's 4 held-out scenes
     (`configs/synthetic256.yaml`, 256²) with the 120-frame orbit video and
     the TSDF mesh, and again on the seeded weights, metrics only: the
     checkpoint must score the higher mean SSIM (both PSNRs are printed);
     (b) serving at 512² with
     `flash_attn=True` (`configs/infer.yaml`, eval budgets 512 / 262,144,
     seeded weights, metrics only) over a 512² store's 2 held-out scenes.
     Every scene must launch exactly 16 + 120 + 48 blend forwards in (a),
     16 and 12 flash forwards in (b), the plain blend never, with finite
     metrics and every panel, video frame and non-empty mesh written;
     prints the mean PSNR / SSIM, seconds per scene split into forward,
     metrics, panel write, video renders and write, mesh renders and the
     TSDF, and the video path's renders per second; then extracts (a)'s
     first scene's mesh again at a 2/64 voxel (its 256² meshes hold ~2M
     triangles, ~140 s a turntable frame) and starts `python -m
     lara_tpu_torch.tools.mesh_render` on it (`--frames 4
     --size 256`: 3 elevations × 4 = 12 frames) in the background, and
     waits for it after phase 13: exit 0, the 12 PNG frames (an mp4 where
     OpenCV imports), none all background; prints its seconds per frame;
  12. data parallel, with `configs/synthetic256.yaml` on the trainer's
     store: (a) the trainer (B=3, grad_accum 2, 6 micro-steps, the fine
     stage from micro-step 4) in a process group of world size 1 over NCCL
     and again with no group: launches per micro-step equal, the losses of
     the first optimizer step bit for bit, and every gradient all-reduce
     leaving the gradient bit for bit (the backward is not bit-reproducible
     on the card, with or without a group: `grid_sampler_2d_backward` and
     the bicubic pos-embed's backward have no deterministic implementation,
     and bf16 rounds what they change); prints the all-reduce time of the
     125,335,880-parameter gradient and the median micro-steps of both runs;
     then together (b) `python -m torch.distributed.run --standalone
     --nproc_per_node=1 -m lara_tpu_torch.train` for 2 micro-steps (exit 0,
     scalars and a checkpoint), (c) two spawned ranks on the one card over
     gloo, each on its slice of a global batch of 2, grad_accum 2, 4
     micro-steps, in float32, against one process at batch 2 (each loss
     within 5e-4 relative, the first all-reduced gradient within 5e-3
     relative L2 per parameter) and against one process that forwards one
     scene at a time as the ranks do (1e-4); the ranks' parameters bit for
     bit after each optimizer step, only rank 0 writing; (d) `evaluate` on
     those ranks at batch size 2 on (a)'s checkpoint over 4 held-out scenes
     against one process at batch size 1: the same scenes, PSNR and SSIM
     within 5e-3;
  13. tensor parallel, two ranks at dp=1×tp=2 sharing the card over gloo
     (`parallel/tp.py`: the encode split over view rows, each
     volume-transformer layer over group rows, the render loop over target
     views): (a) the trainer on the data-parallel phase's setting in
     float32, a global batch of 2 at grad_accum 2, 4 fine micro-steps and a
     validation, against this process at tp=1 on the same batches (each
     loss within 5e-4 relative, the first all-reduced gradient within 5e-3
     relative L2 per parameter), the ranks' parameters bit for bit after
     each optimizer step, only rank 0 writing, each rank launching half of
     tp=1's blend kernels per step, and each step's gathers and
     reduce-scatters the count reckoned from the code; (b) the flagship at
     512², B=1, 4 + 4 views, bf16, flash attention and the replay backward,
     3 fine micro-steps per rank: launches and collectives per micro-step,
     finite stats equal on both ranks; prints each rank's peak memory,
     median micro-step and bytes gathered per micro-step (readings through
     the host, not a speed); (c) `python -m lara_tpu_torch.train`'s `main`
     at train.tp=2 on the two ranks for 2 micro-steps: rank 0 writes its
     scalars and a checkpoint;
  14. infer datasets, at the production width (`configs/infer.yaml`, 512²,
     flash attention, seeded weights): a GSO folder (3 sphere scenes × 24
     views on a sphere of cameras; RGBA PNGs written with every row filter
     in turn, z-depth PFMs, a Blender-convention transforms.json), two
     instant3d mosaics and a 16-view LLFF capture are written; each filter
     is checked to round-trip through the port's PNG decoder and the decode
     of a 512² RGBA file with adaptive filters is timed; the seeded network
     goes through a Lightning-format payload (with a class this process
     cannot import) and `python -m lara_tpu_torch.tools.convert_checkpoint`;
     `evaluate` runs GSO with depth metrics from the converted checkpoint
     and from the seeded weights (metrics equal), and instant3d with a
     24-frame video (no novel view: no PSNR); two mipnerf360 samples go
     through `make_forward` and `render_video` on the LLFF spiral. Every
     scene must launch 16 blend forwards and 12 flash forwards (GSO), 8 +
     24 and 12 (instant3d, mipnerf360), the plain blend never; prints the
     seconds per GSO scene split into sample load (PNG decode, resize and
     PFM read per call), forward, metrics, depth metrics and panel, and
     KMeans at the dataset's init;
  15. single image → 3D (mvgen) at the production width
     (`configs/infer.yaml`: 512², 4 views, all of them inputs, flash
     attention, seeded weights): an RGBA 400×300 and an RGB 512²
     conditioning PNG through `MVGenDataset` with the procedural
     zero123plus-v1.1 generator (`data/synthetic.py:sphere_mvgen_pipeline`,
     a 3×2 grid of 320² sphere renders from the model's poses on gray):
     grid slice, matte, INTER_AREA 320² → 512², the rig's cameras; then
     `evaluate` (`_evaluate`, the dataset injected) with a 24-frame video:
     both scenes scored with null means (no novel view), panels and videos
     written, 8 + 24 blend and 12 flash forwards per scene; then one
     zero123plus-v1.2 and one sv3d scene (21 frames of 576² down to 512²)
     through `collate` → `make_forward` (8 + 12 launches each); prints the
     generator's and the front end's seconds per scene, the forward and
     the video's renders and write;
  16. a JSON line describing the kernels (with each one's bound at the
     path's shapes), the `nvidia-smi` line, and as the last line
     `{"ok": true, "device": {...}}`.

Bounds: the larger of the bytes the function must move over 3.35 TB/s and
its operations over the peak for their type (989 TFLOP/s bf16 on the
tensor cores; 67 TFLOP/s f32 outside them for the blend), at the H100 SXM's
published rates. The blend's work depends on the data, so it is counted on
this run's windows: entry-pixel pairs of processed chunks
Σ_t min(n_t, ndone_t·C)·256, times the operations per pair in the kernel
sources (forward ~40 flops and one expf; the backward, from the stash or
replaying, twice that plus ~60: BLEND_OPS). The window kernel is a copy:
its bytes are the key words its windows cover, the starts and the windows
written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from lara_tpu_torch.config import (Config, ModelConfig, RenderConfig, TrainConfig,
                                   load_config, parse_cli)
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models import vit
from lara_tpu_torch.ops import _build, flash
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend, cuda_windows, rasterize
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import (_pack_tile_bounds, bin_view, slot_keys,
                                                 tile_ranges)
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.ops.renderer import (opacity_activation, rotation_activation,
                                         scaling_activation)
from lara_tpu_torch.parallel import tp
from lara_tpu_torch.tools import (ab_dup, ab_kernels, profile_binning, profile_input_pipeline,
                                  profile_loss, profile_rasterizer, sweep_chunk,
                                  sweep_eval_budgets, validate_fine_budget)
from lara_tpu_torch.tools.timing import production_config, psnr, queued_ms
from lara_tpu_torch.tools.profile_flash import sdpa_ms
from lara_tpu_torch.tools.workload import lara_workload
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
# flash attention in bf16 against the plain version from the same bf16
# inputs (f32 logits, softmax and PV): the kernel rounds P to bf16 before
# P V (and dS before its products), 2^-9 relative per element, and writes
# bf16 (another 2^-9): relative L2 error within 1e-2 and every element
# within 2^-5 of the tensor's largest magnitude; in f32 within 1e-5 of it
FLASH_BF16_REL_L2, FLASH_BF16_MAX, FLASH_F32_MAX = 1e-2, 2.0 ** -5, 1e-5
# the bf16 kernels against the blocked plain version, which rounds P and dS
# where the kernels do: what is left is f32 summation order (tensor cores
# vs PyTorch's products, ~1e-6 relative) and the bf16 roundings it flips,
# each one bf16 ulp (2^-8 relative) of one element: relative L2 within
# 2^-9 and every element within 2^-7 of the tensor's largest magnitude
FLASH_BLOCKED_REL_L2, FLASH_BLOCKED_MAX = 2.0 ** -9, 2.0 ** -7
# serving image_fine with flash vs the default attention on the same
# weights: both bf16, the default's logits are a bf16 product, the flash
# kernel's f32; the difference passes through 12 ViT layers, the volume
# transformer and the decoders, and flips near-tied surfels in and out of
# the fine stage's top-k selection, which changes a few pixels outright:
# the mean within 5e-3 and all but 0.1% of the values within 0.1
SLICE_FLASH_MEAN, SLICE_FLASH_Q999 = 5e-3, 0.1
HBM_BYTES_PER_S, BF16_TC_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# operations per processed entry-pixel in the blend kernels' sources: the
# forward's hit, decisions and sums, 41; the backward from the stash walks
# each chunk forward from its carry-in (the hit and decisions, counted as the
# forward's 41), then in reverse the hit again (41) with the derivatives and
# its share of the reduction (60): 41 + 41 + 60 = 142. The replay walks the
# tile forward once (the hit, decisions and moments, counted as the
# forward's 41, whose colour sums are the larger), then the same reverse
# walk and reduction (41 + 60): 41 + 41 + 60 = 142
BLEND_OPS = {"fwd": 41, "bwd": 142, "replay": 41 + 41 + 60}


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


def launches() -> dict:
    return {**cuda_blend.LAUNCHES, **flash.LAUNCHES, **cuda_windows.LAUNCHES}


def reset_launches():
    cuda_blend.reset_launches()
    flash.reset_launches()
    cuda_windows.reset_launches()


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes / 3.35 TB/s and
    ops / peak_ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def blend_pairs(counts, ndone, cfg) -> int:
    """Entry-pixel pairs of the processed chunks: Σ_t min(n_t, ndone_t·C)·P."""
    n = torch.clamp(counts, max=cfg.tile_budget)
    return int(torch.minimum(n, ndone * cfg.pallas_chunk).sum()) * cfg.tile ** 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_hgmma() -> None:
    """Print each flash kernel's count of HGMMA (wgmma) instructions in the
    SASS of the built libraries, where the toolkit has `cuobjdump`, and
    fail if a bf16 kernel has none."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        print("[build] no cuobjdump: HGMMA counts not read")
        return
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", _build.build_library()[lib]._name],
                              capture_output=True, text=True, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = _build.kernel_name(m.group(1))
                counts[fn] = 0
            elif fn is not None and "HGMMA" in line:
                counts[fn] += 1
        print(f"[build] {lib} HGMMA instructions per kernel: "
              + ", ".join(f"{k} {v}" for k, v in counts.items()))
        missing = [k for k, v in counts.items() if "bf16" in k and not k.startswith("rowdot")
                   and v == 0]
        if missing:
            raise AssertionError(f"bf16 flash kernels without wgmma: {missing}")


def build_phase_report() -> None:
    """Print every kernel's registers and spills from the build logs (kept
    beside the libraries, so a cached build prints them too), the blend
    kernels' shared memory and blocks per SM at the path's chunk, and the
    flash kernels' shared memory; fail if ptxas serialised a wgmma."""
    resources = _build.kernel_resources(_build.build_log)
    if not resources:
        raise AssertionError("the build logs name no kernel")
    for name, r in resources.items():
        print(f"[build] {name}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    for budget in (128, 512):
        for name, (threads, smem, regs, blocks) in blend_occupancy(resources, 64,
                                                                   budget).items():
            r = resources[name]
            print(f"[build] {name}: {threads} threads, {smem} B shared memory (dynamic and "
                  f"static) per block at budget {budget} chunk 64, {regs} registers, spill stores "
                  f"{r['spill_stores']} B loads {r['spill_loads']} B: {blocks} blocks per SM")
    for hd in (64, 128):
        print(f"[build] flash bf16 dynamic shared memory per CTA at head_dim {hd}: "
              + ", ".join(f"{k} {v} bytes" for k, v in flash.kernel_smem(hd).items()))
    serialised = _build.serialised_wgmma(_build.build_log)
    if serialised:
        raise AssertionError(f"ptxas serialised the wgmma of {serialised}")
    print("[build] no wgmma serialised (ptxas C7514 / C7515 / C7519 / C7520)")


def blend_occupancy(resources: dict, chunk: int, budget: int) -> dict:
    """{kernel: (threads, shared memory bytes, registers, blocks per SM)}
    of each blend kernel at `chunk` and `budget`: its dynamic shared memory
    as the launch asks for it plus its static shared memory, and its
    registers, from the build log."""
    smem = cuda_blend.kernel_smem(chunk, budget)
    out = {}
    for name, r in resources.items():
        lib = cuda_blend.KERNELS.get(name)
        if lib is not None:
            threads, block_smem = cuda_blend.THREADS[lib], smem[lib] + r["static_smem"]
            out[name] = (threads, block_smem, r["registers"],
                         _build.blocks_per_sm(r["registers"], block_smem, threads))
    return out


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
        # queued device time (calls behind a sleep kernel): the wrapper's
        # host cost enters neither side
        res["ms"] = queued_ms(lambda: cuda_blend.blend_tiles(entries, counts, scalars, cfg))
        res["plain_ms"] = queued_ms(
            lambda: cuda_blend.blend_tiles_reference(entries, counts, scalars, cfg), 5, 3)
        ndone = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)[2]
        pairs = blend_pairs(counts, ndone, cfg)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes(entries, counts, scalars, got), BLEND_OPS["fwd"] * pairs, F32_FLOPS)
        print(f"[kernel] {name}: queued device ms per call kernel {res['ms']:.4f} "
              f"plain {res['plain_ms']:.4f}; {pairs} processed entry-pixels, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}), kernel at "
              f"{res['bound_ms'] / res['ms']:.3f} of it")
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
    again = cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone, cot, cfg)
    torch.cuda.synchronize()
    if not torch.equal(out_s, out):
        raise AssertionError(f"{name}: the stash forward's accumulators differ from the forward's")
    if not torch.equal(grad, again):
        raise AssertionError(f"{name}: two backward calls differ")

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

    replay_case(name, entries, counts, scalars, cfg, cot, (carries, ndone, grad))
    if timed:
        pairs = blend_pairs(counts, ndone, cfg)
        res["bwd_ms"] = queued_ms(lambda: cuda_blend.blend_bwd(
            entries, counts, scalars, carries, ndone, cot, cfg))
        res["replay_ms"] = queued_ms(lambda: cuda_blend.blend_bwd_replay(
            entries, counts, scalars, cot, cfg))
        res["bwd_plain_ms"] = queued_ms(
            lambda: torch.autograd.grad(want, e, cot, retain_graph=True), 5, 3)
        res["fwd_stash_ms"] = queued_ms(lambda: cuda_blend.blend_fwd(
            entries, counts, scalars, cfg, stash=True))
        with torch.enable_grad():
            res["fwd_stash_plain_ms"] = queued_ms(lambda: cuda_blend.blend_tiles_reference(
                e, counts, scalars, cfg), 5, 3)
        res["bwd_bound"] = bound(nbytes(entries, counts, scalars, carries, ndone, cot, grad),
                                 BLEND_OPS["bwd"] * pairs, F32_FLOPS)
        res["replay_bound"] = bound(nbytes(entries, counts, scalars, cot, grad),
                                    BLEND_OPS["replay"] * pairs, F32_FLOPS)
        res["fwd_stash_bound"] = bound(nbytes(entries, counts, scalars, out_s, carries, ndone),
                                       BLEND_OPS["fwd"] * pairs, F32_FLOPS)
        print(f"[backward] {name}: queued device ms per call: backward kernel {res['bwd_ms']:.4f} "
              f"replay backward kernel {res['replay_ms']:.4f} "
              f"plain autograd backward {res['bwd_plain_ms']:.4f}; stash forward kernel "
              f"{res['fwd_stash_ms']:.4f} plain forward under autograd "
              f"{res['fwd_stash_plain_ms']:.4f}; {pairs} processed entry-pixels, bounds "
              f"(ms) backward {res['bwd_bound']}, replay {res['replay_bound']}, "
              f"stash forward {res['fwd_stash_bound']}")
    return res


def replay_case(name, entries, counts, scalars, cfg, cot, stash_path=None) -> None:
    """The replay backward rebuilds the stash path's processed-chunk counts,
    carries (slots 0..ndone, the written ones) and gradients bit for bit;
    `stash_path` is (carries, ndone, grad) of the stash forward + backward
    when the caller has them."""
    if stash_path is None:
        _, carries, ndone = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)
        grad = cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone, cot, cfg)
    else:
        carries, ndone, grad = stash_path
    grad_r, carries_r, ndone_r = cuda_blend.blend_bwd_replay(
        entries, counts, scalars, cot, cfg, return_carries=True)
    torch.cuda.synchronize()
    used = (torch.arange(carries.shape[1], device=entries.device)[None, :]
            <= ndone[:, None])[:, :, None, None]
    same = {"ndone": torch.equal(ndone_r, ndone),
            "carries": torch.equal(torch.where(used, carries_r, 0.0),
                                   torch.where(used, carries, 0.0)),
            "gradients": torch.equal(grad_r, grad)}
    print(f"[replay] {name}: budget {cfg.tile_budget} chunk {cfg.pallas_chunk} "
          f"({cfg.tile_budget // cfg.pallas_chunk} chunks, up to {int(ndone.max())} processed, "
          f"{cuda_blend.kernel_smem(cfg.pallas_chunk, cfg.tile_budget)['blend_bwd_replay']} B of "
          f"shared memory per block): replay vs stash bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"{name}: the replay backward differs from the stash path: {same}")


def backward_phase(dev) -> dict:
    """The kernels of a training render at the train raster config: the
    stash forward, the backward from the stash, and the replay backward."""
    cam = camera(dev)
    cfg = train_raster_cfg()
    entries, counts, scalars = windows(random_scene(N_SURFELS, 0, dev), cfg, cam)
    results = {"train": backward_case("train", entries, counts, scalars, cfg, 1, timed=True)}
    results["over_budget"] = backward_case("over_budget", entries, counts + 300, scalars, cfg, 2)
    results["opaque"] = backward_case("opaque", *windows(opaque_stack(dev), cfg, cam), cfg, 3)
    corner = random_scene(4096, 1, dev, corner=True)
    results["empty_tiles"] = backward_case("empty_tiles", *windows(corner, cfg, cam), cfg, 4)
    # the replay at the eval budget, and at 32 chunks per tile
    scene = random_scene(N_SURFELS, 0, dev)
    for seed, (budget, chunk, visible) in enumerate(((512, 64, 262144), (256, 8, 131072)), 5):
        cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                              visible_budget=visible, pallas_chunk=chunk)
        entries, counts, scalars = windows(scene, cfg, cam)
        gen = torch.Generator().manual_seed(seed)
        cot = torch.randn((cfg.num_tiles, cuda_blend.NUM_CHANNELS, 256), generator=gen).to(dev)
        replay_case(f"budget{budget}_chunk{chunk}", entries, counts, scalars, cfg, cot)
    return results


def flash_case(name, seed, b, l, h, hd, dtype, dev, masked=False, timed=False):
    """The flash kernels against autograd of the plain version and of the
    blocked plain version on seeded random q, k, v, taken as the ViT takes
    them (views of one fused [b, l, 3·h·hd] projection), and cotangent."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen).to(dev, dtype)
    q, k, v = (t.reshape(b, l, h, hd) for t in qkv.chunk(3, dim=-1))
    do = torch.randn((b, l, h, hd), generator=gen).to(dev, dtype)
    mask = None
    if masked:
        mask = (torch.rand((b, l), generator=gen) > 0.3).to(dev)
        mask[:, 0] = True
    qkv_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    got = [flash.flash_mha(*qkv_leaves, kv_mask=mask)]
    got += torch.autograd.grad(got[0], qkv_leaves, do)
    torch.cuda.synchronize()
    refs = [("plain", flash.flash_mha_reference)]
    if dtype == torch.bfloat16:
        refs.append(("blocked", flash.flash_mha_blocked_reference))
    errs = {}
    for ref_name, ref_fn in refs:
        ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        want = [ref_fn(*ref, kv_mask=mask)]
        want += torch.autograd.grad(want[0], ref, do)
        for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            rel = ((g - w).norm() / w.norm()).item()
            if ref_name == "plain":
                errs[what] = err
            if dtype != torch.bfloat16:
                ok = err <= FLASH_F32_MAX * max(1.0, scale)
            elif ref_name == "plain":
                ok = rel <= FLASH_BF16_REL_L2 and err <= FLASH_BF16_MAX * scale
            else:
                ok = rel <= FLASH_BLOCKED_REL_L2 and err <= FLASH_BLOCKED_MAX * scale
            print(f"[flash] {name} {what} vs {ref_name}: max |kernel - plain| {err:.3e} (max "
                  f"|plain| {scale:.3e}), relative L2 {rel:.3e}")
            if not ok:
                raise AssertionError(f"flash {name}: {what} differs from the {ref_name} version")
    res = {"max_abs_err": max(errs.values())}
    scale = hd ** -0.5
    o, lse = flash.flash_fwd(q, k, v, mask, scale)
    again = [flash.flash_bwd(q, k, v, mask, o, lse, do, scale) for _ in range(2)]
    if not all(torch.equal(x, y) for x, y in zip(*again)):
        raise AssertionError(f"flash {name}: two backward calls differ")
    if not timed:
        return res
    # queued device time (calls behind a sleep kernel), so the wrapper's
    # host cost enters neither side
    res["fwd_ms"] = queued_ms(lambda: flash.flash_fwd(q, k, v, mask, scale))
    res["bwd_ms"] = queued_ms(lambda: flash.flash_bwd(q, k, v, mask, o, lse, do, scale))
    # events around one host call, median: how the earlier WMMA kernels were timed
    call_ms = [median_ms(lambda: flash.flash_fwd(q, k, v, mask, scale), 20),
               median_ms(lambda: flash.flash_bwd(q, k, v, mask, o, lse, do, scale), 20)]
    print(f"[flash] {name}: median ms around one host call, fwd {call_ms[0]:.4f} bwd "
          f"{call_ms[1]:.4f}")
    ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        res["fwd_plain_ms"] = queued_ms(
            lambda: flash.flash_mha_reference(*ref, kv_mask=mask), 5, 3)
    want = flash.flash_mha_reference(*ref, kv_mask=mask)
    res["bwd_plain_ms"] = queued_ms(
        lambda: torch.autograd.grad(want, ref, do, retain_graph=True), 5, 3)
    sdpa = sdpa_ms(q, k, v, do)
    res["fwd_library_ms"] = min(f for f, _ in sdpa.values())
    res["bwd_library_ms"] = min(bw for _, bw in sdpa.values())
    fwd_flops = 4.0 * b * h * l * l * hd
    io = nbytes(q, k, v, o)
    res["fwd_bound"] = bound(io + nbytes(lse), fwd_flops, BF16_TC_FLOPS)
    res["bwd_bound"] = bound(io + nbytes(do, lse) + 3 * nbytes(q), 2.5 * fwd_flops,
                             BF16_TC_FLOPS)
    padded = flash.BLOCK_K * -(-l // flash.BLOCK_K)
    print(f"[flash] {name}: padded work (64-row blocks on each axis) {padded ** 2 / l ** 2:.4f}"
          f" of the real; two backward calls equal bit for bit")
    for what in ("fwd", "bwd"):
        print(f"[flash] {name} {what}: queued device ms kernel {res[what + '_ms']:.4f} plain "
              f"{res[what + '_plain_ms']:.4f} SDPA (fastest backend) "
              f"{res[what + '_library_ms']:.4f}; bound {res[what + '_bound'][0]:.4f} ms "
              f"({res[what + '_bound'][1]}), kernel at "
              f"{res[what + '_bound'][0] / res[what + '_ms']:.3f} of it")
    return res


def flash_phase(dev) -> dict:
    """The flash kernels at the ViT's shapes (12 heads of 64, 1025 tokens),
    a ragged masked case, every bf16 head_dim of the other template (and
    the short ones of the first), and the f32 kernels at head_dim 12."""
    bf16 = torch.bfloat16
    res = {"train": flash_case("train", 0, 12, 1025, 12, 64, bf16, dev, timed=True),
           "serve": flash_case("serve", 1, 4, 1025, 12, 64, bf16, dev),
           "ragged_mask": flash_case("ragged_mask", 2, 2, 200, 12, 64, bf16, dev, masked=True),
           "f32_hd12": flash_case("f32_hd12", 3, 2, 65, 4, 12, torch.float32, dev),
           "f32_hd12_mask": flash_case("f32_hd12_mask", 4, 2, 200, 3, 12, torch.float32, dev,
                                       masked=True)}
    for i, hd in enumerate((16, 48, 80, 96, 112, 128)):
        res[f"hd{hd}"] = flash_case(f"hd{hd}", 5 + i, 2, 257, 3, hd, bf16, dev,
                                    masked=bool(i % 2))
    return res


def check_outputs(out: dict, n_views: int, views: int = 0):
    """Shapes (B=1, `views` or 2·n_views views at 512²), finite values and
    some coverage of a forward's outputs."""
    for key in ("image", "depth", "acc_map", "rend_normal", "rend_dist", "depth_normal"):
        for k in (key, key + "_fine"):
            want = {"image": (3,), "depth": (1,), "rend_normal": (3,),
                    "depth_normal": (3,)}.get(key, ())
            shape = (1, views or 2 * n_views, H, W) + want
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{k}: non-finite values")
    for k in ("acc_map", "acc_map_fine"):
        if not out[k].max().item() > 0.0:
            raise AssertionError(f"{k} is zero everywhere")


def serve_requests(net, batches, want: dict, tag: str):
    """Requests through `make_forward`, each with exactly the launches in
    `want`; returns (image_fine of the first, seconds per request)."""
    n_views = net.cfg.n_views
    fwd = make_forward(net, with_fine=True)
    seconds, first = [], None
    for i, batch in enumerate(batches):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in launches().items()}
        check_outputs(out, n_views)
        if launched != want:
            raise AssertionError(f"{tag} request {i}: kernel launches {launched}, expected {want}")
        print(f"[{tag}] request {i}: {seconds[-1]:.4f} s, launches {launched}, max acc_map "
              f"{out['acc_map'].max().item():.4f} mean acc_map_fine "
              f"{out['acc_map_fine'].mean().item():.4f}")
        if first is None:
            first = out["image_fine"].clone()
        del out
    return first, seconds


def slice_phase(dev) -> dict:
    """The serving path: flagship requests through `make_forward`, with the
    default attention and then with `flash_attn=True` on the same weights."""
    cfg = Config()
    n_views = cfg.n_views
    t0 = time.perf_counter()
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batches = [make_batch(seed, n_views, dev) for seed in range(2)]
    torch.cuda.synchronize()
    print(f"[slice] flagship Config(): {sum(p.numel() for p in net.parameters())} "
          f"parameters, set-up {time.perf_counter() - t0:.2f} s")

    none = {k: 0 for k in launches()}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    first, seconds = serve_requests(net, batches, {**none, "blend_fwd": 4 * n_views}, "slice")
    counts = launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[slice] seconds per request: {' '.join(f'{s:.4f}' for s in seconds)}; "
          f"peak device memory {peak_gb:.2f} GB")

    with plain_kernels():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = make_forward(net, with_fine=True)(batches[0])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    diff = (plain["image_fine"] - first).abs().max().item()
    print(f"[slice] request 0 with the plain blend: {plain_s:.4f} s; "
          f"max |image_fine kernel - plain| = {diff:.3e}")
    if not diff <= SLICE_ATOL:
        raise AssertionError(f"slice: kernel and plain blend differ by {diff}")
    del plain

    # flash attention in the ViT, same weights
    net.cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, flash_attn=True))
    for blk in net.img_encoder.model.blocks:
        blk.attn.use_flash = True
    reset_launches()
    first_f, seconds_f = serve_requests(
        net, batches, {**none, "blend_fwd": 4 * n_views, "flash_fwd": cfg.model.encoder_depth},
        "slice-flash")
    counts_flash = launches()
    diff = (first_f - first).abs().flatten()
    q99, q999 = torch.quantile(diff, torch.tensor([0.99, 0.999], device=dev)).tolist()
    print(f"[slice-flash] seconds per request: {' '.join(f'{s:.4f}' for s in seconds_f)} "
          f"(default attention {' '.join(f'{s:.4f}' for s in seconds)}); |image_fine - the "
          f"default attention's|: mean {diff.mean().item():.3e}, 99% {q99:.3e}, 99.9% "
          f"{q999:.3e}, max {diff.max().item():.3e}")
    if not (diff.mean().item() <= SLICE_FLASH_MEAN and q999 <= SLICE_FLASH_Q999):
        raise AssertionError("slice: flash attention changes image_fine beyond the bf16 bar")
    # the default attention again, for the binning phase's requests
    net.cfg = cfg
    for blk in net.img_encoder.model.blocks:
        blk.attn.use_flash = False
    return {"launches": counts, "flash_launches": counts_flash,
            "net": net, "batches": batches, "image_fine": first}


def workload_scene(dev):
    """`lara_workload` (trained statistics) with the renderer's activations."""
    means, shs, op_raw, sc_raw, quats = lara_workload(N_SURFELS, 0, dev)
    return (means, shs, opacity_activation(op_raw), scaling_activation(sc_raw),
            rotation_activation(quats))


def sorted_slot_keys(g, cfg) -> tuple:
    """The binning's sorted slot keys [M] of projected surfels and each
    tile's first position in them [T]: the window kernel's inputs."""
    order_v = torch.argsort(torch.where(g.valid, g.depth, torch.inf),
                            stable=True)[:cfg.visible_budget]
    sorted_keys = torch.sort(slot_keys(_pack_tile_bounds(g, cfg)[order_v], cfg)).values
    return sorted_keys, tile_ranges(sorted_keys, cfg)[0]


def window_bytes(starts, m: int, k: int) -> int:
    """Bytes the window extraction must move: the key words its windows
    cover (each once: neighbouring windows overlap where a tile holds fewer
    than k entries), the starts, and the [T, k] windows written."""
    ends = torch.clamp(starts.long() + k, max=m)
    prev = torch.cat([ends.new_zeros(1), torch.cummax(ends, 0).values[:-1]])
    covered = int(torch.clamp(ends - torch.maximum(starts.long(), prev), min=0).sum())
    return 4 * (covered + starts.numel() + starts.numel() * k)


def windows_case(name, sorted_keys, starts, k) -> dict:
    """`tile_windows` against its plain version, bit for bit, on the main
    path's sorted keys and starts (at K = k, with 16-byte stores, and at
    K = 13, one word per lane), with every window at the end of the keys
    (all sentinels), and with a ragged count of windows that run partly
    past the keys; device ms of the kernel, of a kernel that does nothing
    (the floor of any queued launch), of the plain version and of the
    one-gather library call, and the bound."""
    m = sorted_keys.shape[0]
    gen = torch.Generator().manual_seed(k)
    cases = {"main path": (starts, k), "main path, K 13": (starts, 13),
             "all past the keys": (torch.full_like(starts, m), k),
             "partly past the keys": (torch.sort(
                 m - torch.randint(0, k, (1021,), generator=gen)).values.to(starts), k)}
    for case, (st, kk) in cases.items():
        got = cuda_windows.tile_windows(sorted_keys, st, kk)
        want = cuda_windows.tile_windows_reference(sorted_keys, st, kk)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"[binning] {name} windows, {case}: T {st.numel()} K {kk}, sentinel share "
              f"{(want == cuda_windows.INT32_MAX).float().mean().item():.4f}, kernel equal "
              f"to the plain version bit for bit: {same}")
        if not same:
            raise AssertionError(f"{name}: tile_windows differs from its plain version ({case})")
    padded = torch.cat([sorted_keys, sorted_keys.new_full((k,), cuda_windows.INT32_MAX)])
    flat = starts[:, None] + torch.arange(k, dtype=torch.int32, device=starts.device)
    res = {"max_abs_err": 0.0,
           "floor_ms": queued_ms(lambda: torch.cuda._sleep(0)),
           "ms": queued_ms(lambda: cuda_windows.tile_windows(sorted_keys, starts, k)),
           "plain_ms": queued_ms(
               lambda: cuda_windows.tile_windows_reference(sorted_keys, starts, k)),
           "library_ms": queued_ms(lambda: padded[flat]),
           "launch_ms": median_ms(lambda: cuda_windows.tile_windows(sorted_keys, starts, k), 30)}
    res["bound_ms"], res["bound_by"] = bound(window_bytes(starts, m, k), 0, F32_FLOPS)
    print(f"[binning] {name} windows: device ms per call (queued) kernel {res['ms']:.5f} "
          f"empty kernel (floor) {res['floor_ms']:.5f} plain {res['plain_ms']:.5f} "
          f"padded[flat] {res['library_ms']:.5f}; one call alone between events "
          f"{res['launch_ms']:.5f}; bound {res['bound_ms']:.5f} ms ({res['bound_by']}), "
          f"kernel at {res['bound_ms'] / res['ms']:.3f} of it, "
          f"{(res['ms'] - res['floor_ms']) * 1e3:.3f} us over the floor")
    return res


BIN_MODES = {"sort": {}, "count": {"bin_mode": "count"}, "fused": {"pack_mode": "fused"}}


def binning_modes_case(name, g, cfg, scalars) -> tuple:
    """(b) bin_view in the three modes gives the same windows; (c) the
    blend kernel on them gives the same accumulators. Returns the sort
    mode's entries and counts."""
    bins, ms = {}, {}
    for mode, kw in BIN_MODES.items():
        cfg_m = dataclasses.replace(cfg, **kw)
        bins[mode] = bin_view(g, cfg_m)
        ms[mode] = median_ms(lambda c=cfg_m: bin_view(g, c), 10)
    (_, bs), (_, bc), (_, bf) = bins["sort"], bins["count"], bins["fused"]
    ev = bs.entry_valid
    same = {
        "count": all(torch.equal(a, b) for a, b in (
            (bs.counts, bc.counts), (bs.entry_valid, bc.entry_valid),
            (bs.order_v, bc.order_v), (bs.win_gidx[ev], bc.win_gidx[ev]))),
        "fused": all(torch.equal(a, b) for a, b in (
            (bs.counts, bf.counts), (bs.entry_valid, bf.entry_valid),
            (bs.order_v[bs.win_gidx[ev]].int(), bf.win_gidx[ev])))}
    print(f"[binning] {name} bin_view windows equal to the sort mode's: {same}; "
          f"{int(ev.sum())} valid entries; median ms per bin_view "
          + " ".join(f"{k}={v:.3f}" for k, v in ms.items()))
    if not all(same.values()):
        raise AssertionError(f"{name}: bin_view modes give different windows: {same}")
    entries, accs = {}, {}
    for mode, (packed, b) in bins.items():
        entries[mode] = window_gather(packed, b.win_gidx, b.entry_valid, b.slot_pos).contiguous()
        accs[mode] = cuda_blend.blend_fwd(entries[mode], b.counts, scalars, cfg)
    torch.cuda.synchronize()
    same = {m: torch.equal(accs[m], accs["sort"]) for m in ("count", "fused")}
    print(f"[binning] {name} blend accumulators equal to the sort mode's bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"{name}: the blend differs between binning modes: {same}")
    return entries["sort"], bs.counts


def binning_phase(dev, serving: dict) -> dict:
    """The window kernel, the binning modes, the blend at trained
    statistics, serving with the binning modes, and the binning profiler."""
    cam = camera(dev)
    scene = workload_scene(dev)
    scalars = torch.stack([cam.tanfovx, cam.tanfovy]).float()
    res = {}
    for name, budget, visible in (("train", 128, 131072), ("eval", 512, 262144)):
        cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                              visible_budget=visible, pallas_chunk=min(64, budget))
        g, overflow = preprocess_surfels(*scene, cam, cfg, return_overflow=True)
        sorted_keys, starts = sorted_slot_keys(g, cfg)
        print(f"[binning] {name}: lara_workload {N_SURFELS} surfels, {int(g.valid.sum())} "
              f"valid, radius_overflow_frac {overflow.item():.6f} at dup {cfg.dup}; "
              f"M {sorted_keys.numel()} keys")
        res[name] = windows_case(name, sorted_keys, starts, budget)
        entries, counts = binning_modes_case(name, g, cfg, scalars)
        res[f"blend_{name}"] = compare_case(f"trained-{name}", entries, counts, scalars, cfg,
                                            timed=True)
        res[f"overflow_{name}"] = overflow.item()

    # (d) serving with the binning modes, on the serving phase's weights
    net, batches, first = serving.pop("net"), serving.pop("batches"), serving.pop("image_fine")
    base = net.cfg
    none = {k: 0 for k in launches()}
    for mode in ("count", "fused"):
        net.cfg = dataclasses.replace(base, render=dataclasses.replace(
            base.render, **BIN_MODES[mode]))
        img, _ = serve_requests(net, batches[:1], {**none, "blend_fwd": 4 * base.n_views},
                                f"binning-{mode}")
        diff = (img - first).abs().max().item()
        print(f"[binning-{mode}] max |image_fine - the sort binning's| = {diff:.3e} "
              f"(equal: {diff == 0.0})")
        if not diff <= SLICE_ATOL:
            raise AssertionError(f"serving with {mode} binning differs by {diff}")
    net.cfg = base
    del net, batches, first

    # (e) the binning profiler's whole path on the card
    reset_launches()
    res["tool"] = profile_binning.run(views=8, trials=1, device=dev)
    res["tool_launches"] = launches()
    print(f"[binning] profile_binning.run(views=8, trials=1): launches {res['tool_launches']}")
    return res


# the CUDA path against the reference backend (tests/test_pallas.py:125-138):
# values within 2e-4, the depths within 1e-3 (the blend bar of channels 4
# and 5, ATOL above: where rounding flips an entry between its ray depth
# and its center depth, the two differ and alpha does not), gradients
# within 5e-4 + 1e-3 |reference| per element
REF_SIZE, REF_GRAD_ATOL, REF_GRAD_RTOL = 128, 5e-4, 1e-3
REF_ATOL = {"image": 2e-4, "alpha": 2e-4, "normal": 2e-4, "depth_expected": 1e-3,
            "depth_median": 1e-3, "distortion": 2e-4}


def reference_case(dev) -> dict:
    """The kernels' path (stash and replay) against the reference backend at
    128² on a scene nothing truncates: every output, and the gradients of
    mean(image) + mean(distortion) to the five surfel tensors."""
    # small splats in the view at 128²: no footprint reaches the dup clamp
    # and no tile its budget of 512, so the binned path drops nothing
    cam, scene = camera(dev), random_scene(2000, 14, dev, extent=0.4)
    bg = torch.tensor([0.3, 0.5, 0.7], device=dev)

    def render(cfg):
        leaves = [p.detach().clone().requires_grad_(True) for p in scene]
        out = rasterize(*leaves, cam, bg, cfg)
        grads = torch.autograd.grad(torch.mean(out.image) + torch.mean(out.distortion), leaves)
        return out, grads

    res = {}
    for mode, stash in (("stash", True), ("replay", False)):
        cfg = RasterizeConfig(height=REF_SIZE, width=REF_SIZE, tile=16, dup=3, tile_budget=512,
                              pallas_chunk=64, stash_carries=stash)
        g, overflow = preprocess_surfels(*scene, cam, cfg, return_overflow=True)
        _, binned = bin_view(g, cfg)
        top = int(binned.counts.max())
        if overflow.item() != 0.0 or top >= cfg.tile_budget:
            raise AssertionError(f"the reference scene truncates: radius overflow "
                                 f"{overflow.item()}, a tile of {top} entries")
        got, g_got = render(cfg)
        want, g_want = render(dataclasses.replace(cfg, backend="reference"))
        err = {f: (getattr(got, f) - getattr(want, f)).abs().max().item() for f in REF_ATOL}
        grad_err = [(a - b).abs().max().item() for a, b in zip(g_got, g_want)]
        grad_ok = all(bool(((a - b).abs() <= REF_GRAD_ATOL + REF_GRAD_RTOL * b.abs()).all())
                      for a, b in zip(g_got, g_want))
        print(f"[raster tools] {mode} path against the reference at {REF_SIZE}², "
              f"{int(g.valid.sum())} valid surfels, largest tile {top} of {cfg.tile_budget}, "
              f"radius overflow 0: max |Δ| " + " ".join(f"{k} {v:.3e}" for k, v in err.items())
              + "; gradients " + " ".join(f"{v:.3e}" for v in grad_err)
              + f" (within {REF_GRAD_ATOL} + {REF_GRAD_RTOL}|ref|: {grad_ok})")
        if any(err[f] > REF_ATOL[f] for f in err) or not grad_ok:
            raise AssertionError(f"the {mode} path differs from the reference: {err}, "
                                 f"gradients {grad_err}")
        res[mode] = {"max_abs_err": max(err.values()), "grad_max_abs_err": max(grad_err)}
    return res


def truncation_case(dev) -> dict:
    """PSNR of the binned renders (train and eval budgets) of `lara_workload`
    against the reference at 128², not gated (`profile_rasterizer` reads
    the same at 512²)."""
    scene = workload_scene(dev)
    cam, bg = camera(dev), torch.ones(3, device=dev)
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        ref = rasterize(*scene, cam, bg, RasterizeConfig(height=REF_SIZE, width=REF_SIZE,
                                                         backend="reference")).image
        sync(dev)
        res = {"reference_s": time.perf_counter() - t0}
        for name, train in (("train", True), ("eval", False)):
            img = rasterize(*scene, cam, bg, production_config(REF_SIZE, train=train)).image
            res[f"psnr_{name}"] = psnr(img, ref)
    print(f"[raster tools] lara_workload at {REF_SIZE}²: the binned renders against the "
          f"reference (one render {res['reference_s']:.3f} s): PSNR train "
          f"{res['psnr_train']}, eval {res['psnr_eval']} dB")
    return res


def raster_tools_phase(dev) -> dict:
    """The reference backend against the kernels' path, then every raster
    validation and profiling tool once at reduced repetitions, their
    launches counted."""
    res = {"reference": reference_case(dev), "truncation": truncation_case(dev)}
    reset_launches()
    tools = {
        "validate_fine_budget": lambda: validate_fine_budget.run(dev),
        "sweep_eval_budgets": lambda: sweep_eval_budgets.run(dev, quick=True),
        "ab_dup": lambda: ab_dup.run(dev, quick=True),
        "sweep_chunk": lambda: sweep_chunk.run(dev, quick=True),
        "ab_kernels": lambda: ab_kernels.run(dev, quick=True),
        "profile_rasterizer": lambda: profile_rasterizer.run(dev, quick=True),
        "profile_loss": lambda: profile_loss.run(dev, quick=True),
        "profile_input_pipeline": lambda: profile_input_pipeline.run(dev, workers=(1, 4),
                                                                     size=256),
    }
    res["tools"] = {}
    for name, fn in tools.items():
        t0 = time.perf_counter()
        res["tools"][name] = fn()
        print(json.dumps(res["tools"][name]))
        print(f"[raster tools] {name}: {time.perf_counter() - t0:.2f} s")
    res["launches"] = launches()
    print(f"[raster tools] launches of the tools: "
          + json.dumps({k: v for k, v in res["launches"].items() if v}))
    fine = res["tools"]["validate_fine_budget"]
    census = fine["census_op_gt_0.005"]
    above = [m for m in fine["budgets"] if int(m) >= census]
    if not above or not all(fine["budgets"][m]["identical"] for m in above):
        raise AssertionError(f"top-M renders at M >= the census {census} differ from the "
                             f"mask render: {fine['budgets']}")
    return res


@contextlib.contextmanager
def plain_kernels():
    """Swap the kernels' wrappers (the blend's and the ViT's flash
    attention) for their plain versions, on the card's tensors, for a
    comparison run."""
    blend, attn = cuda_blend.blend_tiles, vit.flash_mha
    cuda_blend.blend_tiles = cuda_blend.blend_tiles_reference
    vit.flash_mha = flash.flash_mha_reference
    try:
        yield
    finally:
        cuda_blend.blend_tiles, vit.flash_mha = blend, attn


def with_knobs(cfg: Config, **model) -> Config:
    """cfg with flash attention and the replay backward on, and `model`'s
    other fields set."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, flash_attn=True, **model),
        render=dataclasses.replace(cfg.render, pallas_stash_carries=False))


def want_launches(cfg: Config, renders: int) -> dict:
    """Kernel launches of one training micro-step with `renders` renders:
    the blend's by the stash knob, and with flash attention one forward per
    ViT layer, once more in the remat recompute, and one backward."""
    want = {k: 0 for k in launches()}
    if cfg.render.pallas_stash_carries:
        want.update(blend_fwd_stash=renders, blend_bwd=renders)
    else:
        want.update(blend_fwd=renders, blend_bwd_replay=renders)
    if cfg.model.flash_attn:
        depth = cfg.model.encoder_depth
        want.update(flash_fwd=depth * (2 if cfg.model.remat else 1), flash_bwd=depth)
    return want


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


def train_reduced_phase(dev, knobs: bool) -> dict:
    """(a) One fine micro-step at a reduced config through the kernels and
    through the plain versions, in f32: the loss and every parameter
    gradient agree within TRAIN_GRAD_RTOL. With `knobs`, flash attention
    (the f32 kernels, head_dim 12) and the replay backward. Without, then
    10 optimizer steps on one batch: the loss falls."""
    cfg = with_knobs(reduced_config()) if knobs else reduced_config()
    tag = "train-a-knobs" if knobs else "train-a"
    net = LaRaNet(cfg, dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(1)).train()
    batch = make_batch(7, cfg.n_views, dev, size=128)
    reset_launches()
    loss_k, grads_k = loss_and_grads(net, batch, 2002)
    want = want_launches(cfg, 2 * 2 * cfg.n_views)
    if launches() != want:
        raise AssertionError(f"{tag}: launches {launches()}, expected {want}")
    with plain_kernels():
        loss_p, grads_p = loss_and_grads(net, batch, 2002)
    worst = max(((torch.linalg.vector_norm(grads_k[n] - g)
                  / torch.linalg.vector_norm(g).clamp_min(1e-30)).item(), n)
                for n, g in grads_p.items())
    print(f"[{tag}] loss kernels {loss_k:.7f} plain {loss_p:.7f}; worst gradient "
          f"relative L2 difference {worst[0]:.3e} ({worst[1]}); launches {want}")
    if not abs(loss_k - loss_p) <= 1e-5:
        raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_p}")
    if not worst[0] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"{tag}: gradient of {worst[1]} differs by {worst[0]:.3e}")
    if knobs:
        return {"max_rel_grad_diff": worst[0]}

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


def train_flagship_phase(dev, knobs: bool) -> dict:
    """(b) The flagship Config() at B=3 (4 + 4 views at 512²), bf16 autocast,
    seeded random weights: one coarse micro-step, then four fine
    micro-steps (two AdamW updates) from micro-step 2002, where the loss
    gates are on and the learning rate is near its peak. With `knobs`,
    flash attention and the replay backward, then (c) one fine micro-step
    with remat_policy "dots" as well; without, (c) one eval step."""
    cfg = with_knobs(Config()) if knobs else Config()
    tag = "train-b-knobs" if knobs else "train-b"
    n_views, scenes = cfg.n_views, cfg.train.batch_size
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch = make_batch(11, n_views, dev, scenes=scenes)
    per_pass = scenes * 2 * n_views                  # renders per coarse or fine pass

    def params():
        return [p.detach().clone() for p in net.parameters()]

    def micro_step(step_fn, i, renders):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = step_fn(batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in launches().items()}
        want = want_launches(net.cfg, renders)
        if launched != want:
            raise AssertionError(f"{tag} micro-step {i}: launches {launched}, expected {want}")
        vals = {k: v.item() for k, v in stats.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"{tag} micro-step {i}: non-finite stats {vals}")
        print(f"[{tag}] micro-step {i}: {sec:.3f} s, loss {vals['loss']:.5f}, "
              f"launches {{{', '.join(f'{k}: {v}' for k, v in launched.items() if v)}}}, "
              f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        return sec, vals

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
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
            print(f"[{tag}] max |gradient| per stage after micro-step 0: "
                  + " ".join(f"{k}={v:.3e}" for k, v in stage_g.items()))
        changed.append(not all(torch.equal(a, b) for a, b in zip(before, params())))
    if changed != [False, True, False, True]:
        raise AssertionError(f"parameters changed after fine micro-steps {changed}, "
                             "expected only after the second of each pair")
    counts = launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[{tag}] flagship B={scenes}: coarse micro-step {sec_c:.3f} s; fine micro-steps "
          + " ".join(f"{s:.3f}" for s in secs) + f" s; optimizer step (2 fine micro-steps) "
          f"{secs[2] + secs[3]:.3f} s; peak device memory {peak_gb:.2f} GB; lr {state.schedule(state.opt_step - 1):.3e}")
    res = {"launches": counts, "micro_s": secs, "coarse_s": sec_c, "peak_gb": peak_gb}

    if knobs:
        # (c) one fine micro-step with remat_policy "dots" as well
        net.cfg = with_knobs(Config(), remat_policy="dots")
        net.img_encoder.model.remat_policy = net.vol_decoder.remat_policy = "dots"
        torch.cuda.reset_peak_memory_stats(dev)
        res["dots_s"], _ = micro_step(step, "dots", 2 * per_pass)
        res["dots_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"[train-c-dots] one fine micro-step with remat_policy dots: "
              f"{res['dots_s']:.3f} s, peak device memory {res['dots_peak_gb']:.2f} GB")
        return res

    # (c) the eval step at the eval budgets, on the first scene
    one = {k: v[:1] for k, v in batch.items()}
    reset_launches()
    out, stats = make_eval_step(net)(one, state.opt_step)
    check_outputs(out, n_views)
    vals = {k: v.item() for k, v in stats.items()}
    if not all(np.isfinite(list(vals.values()))) or launches()["blend_fwd"] != 4 * n_views:
        raise AssertionError(f"eval step: stats {vals}, launches {launches()}")
    print(f"[train-c] eval step: loss {vals['loss']:.5f} psnr_fine {vals['psnr_fine']:.3f}")
    return res


TRAINER_OVERRIDES = [
    "train_dataset.n_scenes=32", "test_dataset.n_scenes=32", "train.start_fine=2",
    "train.use_rand_views=True", "train.check_val_every_n_epoch=1",
    "train.ckpt_every_n_epoch=1", "train.vis_every_n_steps=5", "train.limit_val_batches=1.0"]


@contextlib.contextmanager
def counted_steps(log: list):
    """Wrap the trainer's train and eval steps: each call appends its kind,
    its kernel launches, its seconds (synchronised) and its loss to `log`.
    log[0] collects the calls of the plain blend and the seconds spent in
    checkpoint saves and panel writes."""
    from lara_tpu_torch.train import checkpoint, loop

    make_train, make_eval, plain = loop.make_train_step, loop.make_eval_step, \
        cuda_blend.blend_tiles_reference
    save, add_image = checkpoint.save_checkpoint, loop.RunLogger.add_image
    totals = log[0]

    def counting(kind, fn):
        def run(*args):
            before, tp_before = launches(), dict(tp.COUNTS)
            t0 = time.perf_counter()
            res = fn(*args)
            stats = res if kind == "train" else res[1]
            loss = stats["loss"].item()
            log.append({"kind": kind, "loss": loss, "seconds": time.perf_counter() - t0,
                        "launches": {k: v - before[k] for k, v in launches().items()},
                        "tp": {k: v - tp_before[k] for k, v in tp.COUNTS.items()}})
            return res
        return run

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            totals[key] += time.perf_counter() - t0
            return res
        return run

    def plain_blend(*args, **kw):
        totals["plain_blend"] += 1
        return plain(*args, **kw)

    loop.make_train_step = lambda *a, **kw: counting("train", make_train(*a, **kw))
    loop.make_eval_step = lambda *a, **kw: counting("eval", make_eval(*a, **kw))
    cuda_blend.blend_tiles_reference = plain_blend
    checkpoint.save_checkpoint = timed("checkpoint_s", save)
    loop.RunLogger.add_image = timed("panel_write_s", add_image)
    try:
        yield
    finally:
        loop.make_train_step, loop.make_eval_step = make_train, make_eval
        cuda_blend.blend_tiles_reference = plain
        checkpoint.save_checkpoint, loop.RunLogger.add_image = save, add_image


def trainer_phase(dev, tmp: str) -> dict:
    """(d) `python -m lara_tpu_torch.train configs/synthetic256.yaml` through
    its `main`, in this process, on a 32-scene synthetic store at 256² in
    `tmp`: 28 train scenes, 9 micro-steps of B=3 per epoch, 2 epochs, then a
    resume to a third. The store and the run's checkpoints stay in `tmp`
    for the evaluate phase. Raises on any failure."""
    import os

    from lara_tpu_torch.data import DataLoader, get_dataset, write_synthetic_store
    from lara_tpu_torch.train import checkpoint as ckpt
    from lara_tpu_torch.train.__main__ import main as train_main

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    store = write_synthetic_store(os.path.join(tmp, "store"), n_scenes=32, n_views=12,
                                  img_size=(256, 256))
    store_s = time.perf_counter() - t0
    logdir = os.path.join(tmp, "logs")
    args = ["configs/synthetic256.yaml", f"train_dataset.data_root={store}",
            f"test_dataset.data_root={store}", f"logger.dir={logdir}", *TRAINER_OVERRIDES]
    print(f"[trainer] store of 32 scenes x 12 views at 256² written in {store_s:.2f} s")

    runs = []
    for n_epoch in (2, 3):
        log = [{"plain_blend": 0, "checkpoint_s": 0.0, "panel_write_s": 0.0}]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        with counted_steps(log):
            tr = train_main(args + [f"train.n_epoch={n_epoch}"])
        wall = time.perf_counter() - t0
        runs.append((tr, log, wall, launches(), torch.cuda.max_memory_allocated(dev)))

    (tr, log, wall, counts, peak), (tr2, log2, wall2, counts2, peak2) = runs
    cfg = tr.cfg
    per_pass = cfg.train.batch_size * 2 * cfg.n_views
    for tag, (t_, lg) in (("run 1", (tr, log)), ("resume", (tr2, log2))):
        if lg[0]["plain_blend"]:
            raise AssertionError(f"trainer {tag}: the plain blend ran {lg[0]} on the card")
        steps = [e for e in lg[1:] if e["kind"] == "train"]
        if len(steps) != len(t_.micro_log):
            raise AssertionError(f"trainer {tag}: {len(steps)} counted steps, "
                                 f"{len(t_.micro_log)} micro-steps")
        for m, e in zip(t_.micro_log, steps):
            want = want_launches(cfg, per_pass * (2 if m["with_fine"] else 1))
            if e["launches"] != want or not np.isfinite(e["loss"]):
                raise AssertionError(f"trainer {tag} micro-step {m['micro']}: launches "
                                     f"{e['launches']}, expected {want}; loss {e['loss']}")
        for e in lg[1:]:
            if e["kind"] == "eval" and not (e["launches"]["blend_fwd"] > 0
                                            and e["launches"]["blend_fwd_stash"] == 0
                                            and np.isfinite(e["loss"])):
                raise AssertionError(f"trainer {tag}: eval step {e}")
    micro = tr.micro_log
    if len(micro) != 18 or tr.state.step != 18:
        raise AssertionError(f"trainer: {len(micro)} micro-steps, step {tr.state.step}")
    kinds = {(m["with_fine"], m["n_sel"]) for m in micro}
    if {f for f, _ in kinds} != {False, True} or {n for _, n in kinds} != {2, 3, None}:
        raise AssertionError(f"trainer: (fine, views) taken {sorted(kinds, key=str)}")
    if tr.val_epochs != [0, 1] or tr.ckpt_epochs != [0, 1]:
        raise AssertionError(f"trainer: validation {tr.val_epochs}, checkpoints "
                             f"{tr.ckpt_epochs}")
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    val_psnr = {d["step"]: d["value"] for d in scalars if d["tag"] == "val/psnr_fine"}
    val_epochs = sorted(val_psnr)
    if not all(np.isfinite(d["value"]) for d in scalars) or val_epochs != [0, 1, 2] \
            or not any(d["tag"] == "train/loss" for d in scalars):
        raise AssertionError(f"trainer: scalars {scalars}")
    ckpts = sorted(os.listdir(os.path.join(logdir, "ckpts")))
    if ckpts != [os.path.basename(ckpt.checkpoint_path("", s)) for s in (9, 18, 27)]:
        raise AssertionError(f"trainer: checkpoints {ckpts}")
    panels = os.listdir(os.path.join(logdir, "panels"))
    if not any(p.startswith("train_pred_rgb_fine") for p in panels) or \
            not any(p.startswith("val_pred_rgb_fine") for p in panels):
        raise AssertionError(f"trainer: panels {sorted(panels)}")
    if [m["epoch"] for m in tr2.micro_log] != [2] * 9 or tr2.micro_log[0]["micro"] != 18 \
            or tr2.state.step != 27 or tr2.val_epochs != [2]:
        raise AssertionError(f"trainer resume: {[(m['epoch'], m['micro']) for m in tr2.micro_log]}"
                             f", step {tr2.state.step}, validation {tr2.val_epochs}")

    # the loader alone: one epoch of the run's train loader, no device work
    ds_cfg = cfg.train_dataset
    loader = DataLoader(get_dataset(ds_cfg.dataset_name)(ds_cfg), ds_cfg.batch_size,
                        shuffle=True, num_workers=ds_cfg.num_workers, seed=1)
    t0 = time.perf_counter()
    n_scenes = sum(len(b["meta"]) for b in loader)
    loader_sps = n_scenes / (time.perf_counter() - t0)

    med = {f: statistics.median(m["seconds"] for m in micro if m["with_fine"] == f)
           for f in (False, True)}
    train_launch = {k: v for k, v in counts.items() if v}
    for tag, t_, lg, w in (("run 1", tr, log, wall), ("resume", tr2, log2, wall2)):
        parts = {"train steps": sum(e["seconds"] for e in lg[1:] if e["kind"] == "train"),
                 "eval steps (validation, panels)": sum(e["seconds"] for e in lg[1:]
                                                       if e["kind"] == "eval"),
                 "panel writes": lg[0]["panel_write_s"], "checkpoints": lg[0]["checkpoint_s"],
                 "loader wait": t_.loader_wait_s}
        parts["rest of the fit"] = t_.fit_s - sum(parts.values())
        parts["set-up (config, net, datasets, state, restore)"] = w - t_.fit_s
        print(f"[trainer] {tag} wall {w:.2f} s: "
              + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    print(f"[trainer] run 1: {len(micro)} micro-steps in {wall:.2f} s (fit {tr.fit_s:.2f} s); "
          f"median s per micro-step coarse {med[False]:.4f} ({sum(not m['with_fine'] for m in micro)}) "
          f"fine {med[True]:.4f} ({sum(m['with_fine'] for m in micro)}); loader wait "
          f"{tr.loader_wait_s:.3f} s = {tr.loader_wait_s / tr.fit_s:.4f} of the fit; "
          f"peak device memory {peak / 1e9:.2f} GB; launches {train_launch}")
    print(f"[trainer] resume: 9 micro-steps in {wall2:.2f} s (fit {tr2.fit_s:.2f} s), "
          f"step 18 -> {tr2.state.step}; loader wait {tr2.loader_wait_s / tr2.fit_s:.4f} of "
          f"the fit; peak {peak2 / 1e9:.2f} GB")
    print(f"[trainer] val/psnr_fine by epoch: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(val_psnr.items())))
    print(f"[trainer] loader alone: {loader_sps:.2f} scenes/s ({ds_cfg.num_workers} worker "
          f"threads, B={ds_cfg.batch_size}, 256²)")
    print(f"[trainer] phase {time.perf_counter() - t_phase:.2f} s")
    return {"launches": counts, "resume_launches": counts2, "micro_s": med,
            "loader_scenes_per_s": loader_sps, "peak_gb": peak / 1e9, "store": store,
            "ckpts": os.path.join(logdir, "ckpts")}


EVAL_VIDEO_FRAMES = 120
MESH_RENDERS = 48                       # render_artifacts.extract_mesh: 3 elevations × 16
EVAL_SPLIT = ("sample load", "forward", "metrics", "depth metrics", "panel write",
              "video renders", "video write", "mesh renders", "TSDF integrate + extract + save")
# the GSO dataset's readers, timed inside "sample load"
SAMPLE_PARTS = ("PNG decode", "PNG resize", "PFM read")


@contextlib.contextmanager
def timed_evaluate(log: dict):
    """Wrap `lara_tpu_torch.evaluate`'s dataset, forward, metrics, panel
    writer, video and mesh, the renders of `render_artifacts`, and the GSO
    dataset's readers and KMeans: `log["s"]` collects the seconds of each
    part of EVAL_SPLIT (the forward synchronised) from the first sample
    load on, so that every scene's load and forward fall in it,
    `log["setup"]` those spent before it (the dataset's KMeans),
    `log["sub"]` / `log["calls"]` the seconds and calls of the readers in
    SAMPLE_PARTS, `log["mesh_scene"]` the arguments of the first
    `extract_mesh` call, `log["scenes"]` each scene's kernel launches (from one
    forward to the next; batch size 1), `log["plain_blend"]` the plain
    blend's runs and `log["window"]` the host clock at the first sample
    load. Yields a function that times an injected dataset's sample loads
    the same way."""
    from lara_tpu_torch import evaluate
    from lara_tpu_torch.data import gso
    from lara_tpu_torch.eval import render_artifacts

    log.update(s=dict.fromkeys(EVAL_SPLIT, 0.0), setup={}, sub=dict.fromkeys(SAMPLE_PARTS, 0.0),
               calls=dict.fromkeys(SAMPLE_PARTS, 0), scenes=[], plain_blend=0)
    saved = {name: getattr(evaluate, name) for name in
             ("make_forward", "psnr", "ssim", "depth_metrics", "_save_panel", "render_video",
              "extract_mesh", "get_dataset")}
    readers = {name: getattr(gso, name) for name in ("read_png", "resize", "read_pfm",
                                                     "kmeans_groups")}
    frames, plain = render_artifacts._render_frames, cuda_blend.blend_tiles_reference
    artifact = ["video"]
    renders_s = {"video": 0.0, "mesh": 0.0}
    marks = []

    def timed(key, fn, into="s"):
        def run(*args, **kw):
            t0 = time.perf_counter()
            if key == "sample load":
                log.setdefault("window", t0)
            res = fn(*args, **kw)
            dt = time.perf_counter() - t0
            if into == "sub":
                log["sub"][key] += dt
                log["calls"][key] += 1
            elif "window" in log:
                log["s"][key] += dt
            else:
                log["setup"][key] = log["setup"].get(key, 0.0) + dt
            return res
        return run

    def timed_class(cls):
        return type(cls.__name__, (cls,), {"__getitem__": timed("sample load",
                                                                 cls.__getitem__)})

    def get_dataset(name):
        return timed_class(saved["get_dataset"](name))

    def time_dataset(ds):
        """An injected dataset, its samples' loads timed as get_dataset's."""
        ds.__class__ = timed_class(type(ds))
        return ds

    def make_forward(*args, **kw):
        fwd = saved["make_forward"](*args, **kw)

        def run(batch):
            marks.append(launches())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fwd(batch)
            torch.cuda.synchronize()
            log["s"]["forward"] += time.perf_counter() - t0
            return out
        return run

    def artifacts(kind, fn):
        def run(*args, **kw):
            artifact[0] = kind
            if kind == "mesh":              # the first scene's surfels, for a coarser mesh
                log.setdefault("mesh_scene", args)
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            rest = "video write" if kind == "video" else "TSDF integrate + extract + save"
            log["s"][rest] += time.perf_counter() - t0 - renders_s[kind]
            renders_s[kind] = 0.0
            return res
        return run

    def render_frames(*args, **kw):
        t0 = time.perf_counter()
        res = frames(*args, **kw)                         # each frame read to the host
        dt = time.perf_counter() - t0
        renders_s[artifact[0]] += dt
        log["s"][f"{artifact[0]} renders"] += dt
        return res

    def plain_blend(*args, **kw):
        log["plain_blend"] += 1
        return plain(*args, **kw)

    evaluate.make_forward = make_forward
    evaluate.get_dataset = get_dataset
    evaluate.psnr, evaluate.ssim = timed("metrics", saved["psnr"]), timed("metrics", saved["ssim"])
    evaluate.depth_metrics = timed("depth metrics", saved["depth_metrics"])
    evaluate._save_panel = timed("panel write", saved["_save_panel"])
    evaluate.render_video = artifacts("video", saved["render_video"])
    evaluate.extract_mesh = artifacts("mesh", saved["extract_mesh"])
    for name, key in zip(("read_png", "resize", "read_pfm"), SAMPLE_PARTS):
        setattr(gso, name, timed(key, readers[name], into="sub"))
    gso.kmeans_groups = timed("KMeans", readers["kmeans_groups"])
    render_artifacts._render_frames = render_frames
    cuda_blend.blend_tiles_reference = plain_blend
    try:
        yield time_dataset
        marks.append(launches())
        log["scenes"] = [{k: b[k] - a[k] for k in b} for a, b in zip(marks, marks[1:])]
    finally:
        for name, fn in saved.items():
            setattr(evaluate, name, fn)
        for name, fn in readers.items():
            setattr(gso, name, fn)
        render_artifacts._render_frames = frames
        cuda_blend.blend_tiles_reference = plain


def run_evaluate(tag: str, args: list, want: dict, folder: str, scored: bool = True,
                 dataset=None) -> tuple:
    """`python -m lara_tpu_torch.evaluate` through its `main` in this process
    (`args` name the save and metric folders under `folder`), or, given a
    `dataset`, through `_evaluate` with that dataset on the config `main`
    would load; raises unless every scene launched exactly `want`, the
    plain blend never ran, and the metrics are finite and in their JSON
    (`scored=False`: a dataset without novel views, which has no PSNR).
    Returns (metrics, log)."""
    import os

    from lara_tpu_torch import evaluate

    log = {}
    torch.cuda.empty_cache()
    reset_launches()
    args = args + [f"infer.save_folder={folder}/{tag}", f"infer.metric_path={folder}/{tag}_metrics"]
    t0 = time.perf_counter()
    with timed_evaluate(log) as time_dataset:
        if dataset is None:
            metrics = evaluate.main(args)
        else:
            paths, overrides = parse_cli(args)
            cfg = load_config(str(evaluate.CONFIGS / "base.yaml"),
                              str(evaluate.CONFIGS / "infer.yaml"), *paths, overrides=overrides)
            metrics = evaluate._evaluate(cfg, torch.device("cuda", 0), torch.bfloat16,
                                         dataset=time_dataset(dataset))
    wall = time.perf_counter() - t0
    n = len(metrics["scenes"])
    if log["plain_blend"]:
        raise AssertionError(f"evaluate {tag}: the plain blend ran {log['plain_blend']} times")
    if len(log["scenes"]) != n or any(c != want for c in log["scenes"]):
        raise AssertionError(f"evaluate {tag}: launches per scene {log['scenes']}, "
                             f"expected {want} for each of {n} scenes")
    values = metrics["psnr"] + metrics["ssim"]
    if not n or len(values) != 2 * n * scored or not np.all(np.isfinite(values)):
        raise AssertionError(f"evaluate {tag}: metrics {metrics}")
    name = next((a.split("=", 1)[1] for a in args if a.startswith("infer_dataset.dataset_name=")),
                "gobjeverse")
    if not os.path.isfile(os.path.join(folder, f"{tag}_metrics", f"{name}.json")):
        raise AssertionError(f"evaluate {tag}: no metrics JSON")
    setup = log["window"] - t0                 # config, net, weights, dataset
    parts = {k: v / n for k, v in log["s"].items() if v}
    parts["rest (host copies)"] = (wall - setup) / n - sum(parts.values())
    quality = (f"mean PSNR {metrics['mean_psnr']:.4f} mean SSIM {metrics['mean_ssim']:.5f}"
               if scored else "no novel views")
    print(f"[evaluate-{tag}] {n} scenes in {wall:.2f} s, set-up {setup:.2f} s "
          f"({', '.join(f'{k} {v:.4f}' for k, v in log['setup'].items())}): {quality}; "
          f"launches per scene {log['scenes'][0]}; seconds per scene after the set-up "
          f"{(wall - setup) / n:.4f}: " + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    if any(log["calls"].values()):
        print(f"[evaluate-{tag}] inside sample load, every sample: " + "; ".join(
            f"{k} {log['sub'][k] / log['calls'][k]:.4f} s per call ({log['calls'][k]} calls)"
            for k in SAMPLE_PARTS if log["calls"][k]))
    return metrics, log


def check_video(folder: str, name: str, frames: int) -> None:
    """The video `<name>_video.mp4` in `folder`, or its `frames` PNG frames
    where OpenCV is absent."""
    import os

    video = os.path.join(folder, f"{name}_video")
    if not os.path.isfile(video + ".mp4") and not (os.path.isdir(video) and sorted(
            os.listdir(video)) == [f"frame_{i:04d}.png" for i in range(frames)]):
        raise AssertionError(f"the video of {name} is incomplete")


def check_artifacts(folder: str, names: list, frames: int) -> dict:
    """Each scene's panel, its video (an mp4, or `frames` PNG frames where
    OpenCV is absent) and a non-empty .obj; returns the meshes' sizes."""
    import os

    sizes = {}
    for name in names:
        base = os.path.join(folder, name)
        if not os.path.isfile(base + ".png"):
            raise AssertionError(f"evaluate: no panel {base}.png")
        check_video(folder, name, frames)
        with open(base + ".obj") as f:
            lines = f.read().splitlines()
        sizes[name] = (sum(ln.startswith("v ") for ln in lines),
                       sum(ln.startswith("f ") for ln in lines))
        if min(sizes[name]) == 0:
            raise AssertionError(f"evaluate: the mesh of {name} is empty: {sizes[name]}")
    return sizes


def evaluate_phase(dev, tmp: str, trainer: dict) -> dict:
    """(e) `python -m lara_tpu_torch.evaluate` in this process: (a) the trainer
    phase's last checkpoint on its store's 4 held-out scenes with
    `configs/synthetic256.yaml` (the flagship network at 256²), with the
    120-frame orbit video and the TSDF mesh, and the same scenes on the
    seeded weights, metrics only; (b) serving at 512² with flash attention
    (`configs/infer.yaml`, eval budgets 512 / 262,144) on the seeded weights,
    metrics only, over a 512² store's 2 held-out scenes."""
    import os

    from lara_tpu_torch.data import write_synthetic_store
    from lara_tpu_torch.eval import render_artifacts

    t_phase = time.perf_counter()
    none = {k: 0 for k in launches()}
    common = ["infer_dataset.dataset_name=synthetic", "infer_dataset.batch_size=1",
              "infer_dataset.num_workers=0"]
    a_args = ["configs/synthetic256.yaml", *common, f"infer_dataset.data_root={trainer['store']}",
              "infer_dataset.img_size=[256,256]"]
    cfg_a = load_config("configs/base.yaml", "configs/infer.yaml", "configs/synthetic256.yaml")
    cfg_b = load_config("configs/base.yaml", "configs/infer.yaml")
    # a sample holds the n_views input views and 4 novel views
    # (data/gobjverse.py:_draw); a forward renders each coarse and fine
    fwd_a, fwd_b = 2 * (cfg_a.n_views + 4), 2 * (cfg_b.n_views + 4)
    want_a = {**none, "blend_fwd": fwd_a + EVAL_VIDEO_FRAMES + MESH_RENDERS}
    res_a, log_a = run_evaluate(
        "a", a_args + [f"infer.ckpt_path={trainer['ckpts']}",
                       f"infer.video_frames={EVAL_VIDEO_FRAMES}", "infer.save_mesh=True"],
        want_a, tmp)
    meshes = check_artifacts(os.path.join(tmp, "a"), res_a["scenes"], EVAL_VIDEO_FRAMES)
    res_seed, _ = run_evaluate("a-seeded", a_args, {**none, "blend_fwd": fwd_a}, tmp)
    # the trainer's 27 steps raise SSIM well above the seeded weights' (0.65
    # against 0.48 on the H100) but not PSNR (9.90 against 10.05): the
    # seeded weights render a faint grey haze over the white background,
    # which the first steps trade for structure; both are printed
    if res_seed["scenes"] != res_a["scenes"] or not res_a["mean_ssim"] > res_seed["mean_ssim"]:
        raise AssertionError(f"evaluate: the trained checkpoint's SSIM {res_a['ssim']} is not "
                             f"above the seeded weights' {res_seed['ssim']}")

    t0 = time.perf_counter()
    store = write_synthetic_store(os.path.join(tmp, "store512"), n_scenes=11, n_views=12,
                                  img_size=(512, 512))
    store_s = time.perf_counter() - t0
    res_b, log_b = run_evaluate(
        "b", [*common, f"infer_dataset.data_root={store}", "model.flash_attn=True"],
        {**none, "blend_fwd": fwd_b, "flash_fwd": cfg_b.model.encoder_depth}, tmp)

    renders = EVAL_VIDEO_FRAMES * len(res_a["scenes"])
    print(f"[evaluate-a] PSNR per scene, checkpoint {['%.4f' % p for p in res_a['psnr']]} vs "
          f"seeded weights {['%.4f' % p for p in res_seed['psnr']]}; mean SSIM "
          f"{res_a['mean_ssim']:.5f} vs {res_seed['mean_ssim']:.5f}")
    print(f"[evaluate-a] video path {renders / log_a['s']['video renders']:.2f} renders/s "
          f"(256², every visible surfel, frames read to the host); meshes (vertices, faces) "
          f"{meshes}")
    print(f"[evaluate-b] 512² store of 11 scenes written in {store_s:.2f} s; mean PSNR "
          f"{res_b['mean_psnr']:.4f} mean SSIM {res_b['mean_ssim']:.5f}")
    print(f"[evaluate] phase {time.perf_counter() - t_phase:.2f} s")
    total = {k: sum(c[k] for c in log_a["scenes"] + log_b["scenes"]) for k in none}
    # the turntable's Python loop costs ~70 µs a triangle on the card's
    # host, and these meshes of a 27-step checkpoint hold ~2M triangles
    # (~140 s a frame): it turns a coarser TSDF mesh of (a)'s first scene
    path, gauss, cfg, tm = log_a.pop("mesh_scene")
    coarse = os.path.join(tmp, "a", "coarse.obj")
    t0 = time.perf_counter()
    render_artifacts.extract_mesh(coarse, gauss, cfg, tm, voxel_size=MESH_VOXEL)
    print(f"[evaluate-a] {os.path.basename(path)} again at voxel {MESH_VOXEL:.4f} for the "
          f"turntable: {time.perf_counter() - t0:.2f} s")
    return {"launches": total, "obj": coarse}


MESH_FRAMES, MESH_SIZE = 4, 256        # mesh_render --frames / --size: 3 elevations × 4 frames
MESH_VOXEL = 2 / 64                     # the turntable's TSDF voxel (evaluate's: 2 / 256)


def start_mesh_render(obj: str, out: str) -> dict:
    """`python -m lara_tpu_torch.tools.mesh_render OBJ --frames 4 --size 256`
    started in the background (its NumPy loop over triangles runs on one
    host core while the next phases use the card)."""
    with open(obj) as f:
        n_faces = sum(ln.startswith("f ") for ln in f)
    cmd = [sys.executable, "-m", "lara_tpu_torch.tools.mesh_render", obj, "--out", out,
           "--frames", str(MESH_FRAMES), "--size", str(MESH_SIZE)]
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "out": out, "faces": n_faces, "t0": time.perf_counter()}


def finish_mesh_render(mesh: dict, smi: str) -> None:
    """Wait for the turntable; raises unless it exits 0 and writes its 12
    frames (an mp4 where OpenCV imports, else PNG frames, each with some
    pixel off the white background)."""
    from lara_tpu_torch.data.image_io import read_png

    t_wait = time.perf_counter()
    out, err = mesh["proc"].communicate(timeout=900)
    wall = time.perf_counter() - mesh["t0"]
    if mesh["proc"].returncode != 0:
        raise AssertionError(f"mesh_render failed ({mesh['proc'].returncode}): "
                             f"{out[-2000:]} {err[-2000:]}")
    frames = 3 * MESH_FRAMES
    folder = os.path.splitext(mesh["out"])[0]
    if not os.path.isfile(mesh["out"]):
        names = sorted(os.listdir(folder))
        if names != [f"frame_{i:04d}.png" for i in range(frames)]:
            raise AssertionError(f"mesh_render wrote {names}")
        for name in names:
            if not (read_png(os.path.join(folder, name)) != 255).any():
                raise AssertionError(f"mesh_render: {name} is all background")
    per_frame = re.search(r"([0-9.]+) s per frame", out)
    print(f"[mesh] turntable of the evaluate phase's coarse .obj ({mesh['faces']} triangles): "
          f"{frames} frames of {MESH_SIZE}² ({MESH_FRAMES} per elevation × 3), "
          f"{per_frame.group(1) if per_frame else '?'} s per frame (its NumPy loop, on one host "
          f"core beside the data- and tensor-parallel phases), {wall:.2f} s in all, "
          f"{time.perf_counter() - t_wait:.2f} s of it waited for here; {smi}")


INFER_VIDEO_FRAMES = 24
LLFF_SIZE = (512, 512)                  # the served size of the LLFF capture (W, H)


def png_phase_checks(path: str) -> float:
    """A GSO render re-encoded with each row filter alone and with libpng's
    adaptive choice decodes to itself on this host; returns the median
    seconds of decoding the adaptive file (512² RGBA)."""
    from lara_tpu_torch.data.image_io import decode_png, encode_png, read_png

    img = read_png(path)
    for filters in (0, 1, 2, 3, 4, "adaptive"):
        if not np.array_equal(decode_png(encode_png(img, filters)), img):
            raise AssertionError(f"PNG filter {filters}: the decoder does not invert the encoder")
    data = encode_png(img, "adaptive")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_png(data)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def lightning_payload(path: str, sd: dict) -> list:
    """The reference's checkpoint form: `state_dict` with the network under
    `net.`, two timm keys the network never reads, and hyper-parameters of
    a class the loading process cannot import. Returns the extra keys."""
    import types

    mod = types.ModuleType("lightning_stand_in")
    mod.AttributeDict = type("AttributeDict", (dict,), {"__module__": mod.__name__})
    sys.modules[mod.__name__] = mod
    extra = {"net.img_encoder.model.head.weight": torch.zeros(1000, 768),
             "net.img_encoder.model.head.bias": torch.zeros(1000)}
    try:
        torch.save({"state_dict": {**{"net." + k: v for k, v in sd.items()}, **extra},
                    "hyper_parameters": mod.AttributeDict(lr=4e-4), "epoch": 29}, path)
    finally:
        del sys.modules[mod.__name__]
    return sorted(extra)


def infer_datasets_phase(dev, tmp: str, smi: str) -> dict:
    """(g) The evaluation datasets and the checkpoint converter at the
    production width (`configs/infer.yaml`, the flagship network, 512²,
    B=1, 4 input views, eval budgets 512 / 262,144, flash attention), on
    data written at the start: a GSO folder (3 sphere scenes × 24 views on
    a sphere of cameras, RGBA PNGs with every row filter in turn, analytic
    depth PFMs, Blender-convention transforms.json), two instant3d 2×2
    mosaics of 512² tiles, and a 16-view LLFF capture stored at 1024².
    The seeded network goes through a Lightning-format payload and
    `python -m lara_tpu_torch.tools.convert_checkpoint`; GSO is evaluated
    with depth metrics from the converted checkpoint and again from the
    seeded weights (the metrics must be equal), instant3d with a 24-frame
    video, and two mipnerf360 samples go through `make_forward` and
    `render_video` on the LLFF spiral. Launches are checked per scene."""
    import os

    from lara_tpu_torch.data import MipNeRF360Dataset
    from lara_tpu_torch.data.loader import collate, to_device
    from lara_tpu_torch.data.synthetic import (write_gso_folder, write_instant3d_folder,
                                               write_llff_folder)
    from lara_tpu_torch.eval.render_artifacts import render_video

    t_phase = time.perf_counter()
    none = {k: 0 for k in launches()}
    cfg = load_config("configs/base.yaml", "configs/infer.yaml")
    fwd_flash = {"flash_fwd": cfg.model.encoder_depth}
    t0 = time.perf_counter()
    gso_root = write_gso_folder(os.path.join(tmp, "gso"), n_scenes=3, n_views=24, size=512)
    i3d_root = write_instant3d_folder(os.path.join(tmp, "instant3d"), n_scenes=2, tile=512)
    llff_root = write_llff_folder(os.path.join(tmp, "llff"), n_views=16, size=LLFF_SIZE)
    write_s = time.perf_counter() - t0
    decode_s = png_phase_checks(os.path.join(gso_root, "object_000", "r_000.png"))
    print(f"[infer] data written in {write_s:.2f} s; PNG decode of a 512² RGBA render with "
          f"adaptive filters {decode_s:.4f} s (median of 5; aim 0.25); every filter "
          f"round-trips on this host; {smi}")

    # the converter, in its own process, on the seeded flagship weights
    t0 = time.perf_counter()
    ckpt, out = os.path.join(tmp, "epoch=29.ckpt"), os.path.join(tmp, "converted")
    extra = lightning_payload(ckpt, LaRaNet(cfg, device="cpu").state_dict())
    res = subprocess.run([sys.executable, "-m", "lara_tpu_torch.tools.convert_checkpoint",
                          ckpt, out], cwd=str(Path(__file__).resolve().parent),
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0 or f"dropped {len(extra)} keys" not in res.stdout:
        raise AssertionError(f"convert_checkpoint failed ({res.returncode}): "
                             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    print(f"[infer] converter {time.perf_counter() - t0:.2f} s: {res.stdout.strip()[-300:]}")

    gso_args = ["infer_dataset.dataset_name=GSO", f"infer_dataset.data_root={gso_root}",
                "infer_dataset.batch_size=1", "infer_dataset.num_workers=0",
                "infer.eval_depth=[0.005,0.01,0.02]", "model.flash_attn=True"]
    # a GSO sample holds the n_views inputs and 4 novel views; each is
    # rendered coarse and fine
    want_gso = {**none, "blend_fwd": 2 * (cfg.n_views + 4), **fwd_flash}
    res_ckpt, log_ckpt = run_evaluate("gso", gso_args + [f"infer.ckpt_path={out}"], want_gso,
                                      tmp)
    res_seed, _ = run_evaluate("gso-seeded", gso_args, want_gso, tmp)
    depth = np.array(res_ckpt["depth"])
    if depth.shape != (3, 4) or not np.isfinite(depth).all():
        raise AssertionError(f"GSO depth metrics {res_ckpt['depth']}")
    for key in ("scenes", "psnr", "ssim", "depth"):
        if res_ckpt[key] != res_seed[key]:
            raise AssertionError(f"GSO {key} from the converted checkpoint {res_ckpt[key]} "
                                 f"differ from the seeded weights' {res_seed[key]}")
    n = len(res_ckpt["scenes"])
    per_scene = {**{k: v / n for k, v in log_ckpt["s"].items() if v},
                 **{f"{k} per call": log_ckpt["sub"][k] / log_ckpt["calls"][k]
                    for k in SAMPLE_PARTS if log_ckpt["calls"][k]},
                 "KMeans at dataset init (all scenes)": log_ckpt["setup"].get("KMeans", 0.0)}
    print("[infer] GSO seconds per scene (converted checkpoint): " + "; ".join(
        f"{k} {v:.4f}" for k, v in per_scene.items()) + f"; mean depth {res_ckpt['mean_depth']}"
        f"; equal to the seeded weights' metrics; {smi}")

    # instant3d: 4 views, no novel view (no PSNR), a 24-frame orbit
    i3d_args = ["infer_dataset.dataset_name=instant3d", f"infer_dataset.data_root={i3d_root}",
                "infer_dataset.batch_size=1", "infer_dataset.num_workers=0", "n_views=4",
                f"infer.video_frames={INFER_VIDEO_FRAMES}", "model.flash_attn=True"]
    want_i3d = {**none, "blend_fwd": 2 * 4 + INFER_VIDEO_FRAMES, **fwd_flash}
    res_i3d, _ = run_evaluate("instant3d", i3d_args, want_i3d, tmp, scored=False)
    for name in res_i3d["scenes"]:
        check_video(os.path.join(tmp, "instant3d"), name, INFER_VIDEO_FRAMES)

    # mipnerf360: its nominal 1000 samples are not evaluate's to loop over;
    # two samples (the train split: 16 views hold out 2) through the forward
    # and the LLFF spiral
    t0 = time.perf_counter()
    mcfg = load_config("configs/base.yaml", "configs/infer.yaml", overrides=[
        "infer_dataset.dataset_name=mipnerf360", f"infer_dataset.data_root={llff_root}",
        "infer_dataset.split=train", "model.flash_attn=True"])
    ds = MipNeRF360Dataset(mcfg.infer_dataset)
    init_s = time.perf_counter() - t0
    if ds.imgs.shape[1:] != (LLFF_SIZE[1], LLFF_SIZE[0], 3):
        raise AssertionError(f"mipnerf360 images {ds.imgs.shape}")
    fwd = make_forward(LaRaNet(mcfg, device=dev), return_buffer=True)
    reset_launches()
    for i in range(2):
        batch = collate([ds[i]])
        out_i = fwd(to_device(batch, dev))
        check_outputs(out_i, mcfg.n_views, views=4)
        gauss = tuple(a[0] for a in out_i["render_pkg"]["fine"])
        render_video(os.path.join(tmp, "mipnerf", f"sample_{i}_video.mp4"), gauss, mcfg,
                     np.eye(4, dtype=np.float32), n_frames=INFER_VIDEO_FRAMES, sample=batch)
        check_video(os.path.join(tmp, "mipnerf"), f"sample_{i}", INFER_VIDEO_FRAMES)
    torch.cuda.synchronize()
    got = launches()
    want_mip = {**none, "blend_fwd": 2 * (2 * 4 + INFER_VIDEO_FRAMES),
                "flash_fwd": 2 * cfg.model.encoder_depth}
    if got != want_mip:
        raise AssertionError(f"mipnerf360 launches {got}, expected {want_mip}")
    print(f"[infer] mipnerf360: dataset init (16 views, INTER_AREA 2× down to {LLFF_SIZE}) "
          f"{init_s:.2f} s,"
          f" 2 samples with {INFER_VIDEO_FRAMES}-frame videos {time.perf_counter() - t0 - init_s:.2f}"
          f" s; launches {got}")
    print(f"[infer] phase {time.perf_counter() - t_phase:.2f} s")
    total = {k: want_gso[k] * 2 * n + want_i3d[k] * len(res_i3d["scenes"]) + want_mip[k]
             for k in none}
    return {"launches": total}


MVGEN_VIDEO_FRAMES = 24


def conditioning_pngs(folder: str) -> list:
    """Two conditioning images: an RGBA 400×300 (W×H) with a soft-edged
    disc on transparency (the pad-to-square and white-composite path) and
    an RGB 512² gradient with a disc."""
    from lara_tpu_torch.data.image_io import encode_png

    os.makedirs(folder, exist_ok=True)
    yy, xx = np.mgrid[0:300, 0:400].astype(np.float32)
    a = np.clip(90 - np.hypot(xx - 200, yy - 150), 0, 1)
    rgba = np.stack([np.full_like(a, 0.8), 0.3 + 0.4 * yy / 300, np.full_like(a, 0.2), a], -1)
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
    disc = (np.hypot(xx - 256, yy - 256) < 160)[..., None]
    rgb = np.where(disc, [0.1, 0.4, 0.9], np.stack([xx / 512, yy / 512, 0.5 + 0 * xx], -1))
    paths = []
    for name, img in (("a_rgba.png", rgba), ("b_rgb.png", rgb)):
        paths.append(os.path.join(folder, name))
        with open(paths[-1], "wb") as f:
            f.write(encode_png((img * 255).round().astype(np.uint8)))
    return paths


def timed_pipeline(pipe, seconds: list):
    """`pipe`, each call's seconds appended to `seconds`."""
    def run(image):
        t0 = time.perf_counter()
        out = pipe(image)
        seconds.append(time.perf_counter() - t0)
        return out
    return run


def mvgen_phase(dev, tmp: str, smi: str) -> dict:
    """(h) Single image → 3D at the production width (`configs/infer.yaml`,
    512², 4 views, all inputs, flash attention, seeded weights): two
    conditioning PNGs (RGBA 400×300, RGB 512²) through `MVGenDataset` with
    the procedural zero123plus-v1.1 generator (`sphere_mvgen_pipeline`:
    a 3×2 grid of 320² sphere renders from the model's poses on gray),
    i.e. slice, matte, INTER_AREA 320² → 512², the rig's cameras, then
    `evaluate` (`_evaluate` with the dataset injected) with a 24-frame
    video; then one scene each of zero123plus-v1.2 and sv3d (21 frames of
    576², INTER_AREA down to 512²) through `collate` → `make_forward`.
    Launches are checked per scene; prints the generator's seconds per
    scene apart from the front end's (slice + matte + resize + batch)."""
    from lara_tpu_torch.data.loader import collate, to_device
    from lara_tpu_torch.data.mvgen import MVGenDataset
    from lara_tpu_torch.data.synthetic import sphere_mvgen_pipeline

    t_phase = time.perf_counter()
    none = {k: 0 for k in launches()}
    cond = conditioning_pngs(os.path.join(tmp, "mvgen_cond"))
    args = ["infer_dataset.dataset_name=mvgen",
            f"infer_dataset.data_root={os.path.dirname(cond[0])}", "infer_dataset.batch_size=1", "infer_dataset.num_workers=0",
            f"infer.video_frames={MVGEN_VIDEO_FRAMES}", "model.flash_attn=True"]
    cfg = load_config("configs/base.yaml", "configs/infer.yaml", overrides=args)
    if cfg.n_views != 4:
        raise AssertionError(f"configs/infer.yaml serves {cfg.n_views} views, not 4")
    # make_forward renders the sample's 4 views coarse and fine; the video
    # renders each frame once; the ViT runs its 12 blocks once
    want = {**none, "blend_fwd": 2 * 4 + MVGEN_VIDEO_FRAMES,
            "flash_fwd": cfg.model.encoder_depth}
    gen_s, load_s = [], []
    ds = MVGenDataset(cfg.infer_dataset, pipeline=timed_pipeline(
        sphere_mvgen_pipeline("zero123plus-v1.1"), gen_s))
    if ds.image_paths != cond:
        raise AssertionError(f"MVGenDataset found {ds.image_paths}, not {cond}")
    res, log = run_evaluate("mvgen", args, want, tmp, scored=False, dataset=ds)
    folder = os.path.join(tmp, "mvgen")
    if res["scenes"] != ["0", "1"] or any(res[k] is not None for k in res if
                                          k.startswith("mean_")):
        raise AssertionError(f"mvgen metrics {res}")
    for name in res["scenes"]:
        if not os.path.isfile(os.path.join(folder, f"{name}.png")):
            raise AssertionError(f"mvgen: no panel {name}.png")
        check_video(folder, name, MVGEN_VIDEO_FRAMES)
    with open(os.path.join(tmp, "mvgen_metrics", "mvgen.json")) as f:
        if set(json.load(f)) != set(res):
            raise AssertionError("mvgen: the metrics JSON's keys")
    n = len(res["scenes"])
    front = log["s"]["sample load"] / n - sum(gen_s) / n
    print(f"[mvgen] zero123plus-v1.1, 2 scenes at 512² (4 input views, no novel view, "
          f"{MVGEN_VIDEO_FRAMES}-frame videos): seconds per scene: generator (6 sphere "
          f"renders of 320², host) {sum(gen_s) / n:.4f}; front end (pad, slice, matte, "
          f"INTER_AREA 320² → 512², batch) {front:.4f}; forward {log['s']['forward'] / n:.4f};"
          f" video renders {log['s']['video renders'] / n:.4f}; video write "
          f"{log['s']['video write'] / n:.4f}; panel write {log['s']['panel write'] / n:.4f}; "
          f"launches per scene {log['scenes'][0]}; {smi}")

    # the other two rigs, one scene each, through make_forward
    net = LaRaNet(cfg, device=dev)
    fwd = make_forward(net, with_fine=True)
    other = {}
    for backend in ("zero123plus-v1.2", "sv3d"):
        seconds = []
        ds = MVGenDataset(cfg.infer_dataset, image_paths=cond[1:], backend=backend,
                          pipeline=timed_pipeline(sphere_mvgen_pipeline(backend), seconds))
        t0 = time.perf_counter()
        batch = collate([ds[0]])
        load = time.perf_counter() - t0
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(to_device(batch, dev))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        got = launches()
        check_outputs(out, cfg.n_views, views=4)
        if got != {**none, "blend_fwd": 8, "flash_fwd": cfg.model.encoder_depth}:
            raise AssertionError(f"mvgen {backend}: launches {got}")
        other[backend] = got
        print(f"[mvgen] {backend}: generator {seconds[0]:.4f} s, front end "
              f"{load - seconds[0]:.4f} s, forward {fwd_s:.4f} s, launches {got}, mean "
              f"acc_map_fine {out['acc_map_fine'].mean().item():.4f}")
        del out
    print(f"[mvgen] phase {time.perf_counter() - t_phase:.2f} s")
    total = {k: want[k] * n + sum(o[k] for o in other.values()) for k in none}
    return {"launches": total}


# one loader thread: the samples' random views and backgrounds are then
# drawn in one order, and every run and rank loads the same samples
DP_OVERRIDES = ["train_dataset.n_scenes=32", "test_dataset.n_scenes=32", "train.n_epoch=1",
                "train_dataset.num_workers=1", "train.use_rand_views=True",
                "train.vis_every_n_steps=0", "train.warmup_iters=2",
                "train.limit_val_batches=0.25"]
# (a) B=3 at grad_accum 2: 6 of the 9 batches of the 28 training scenes, the
# fine stage from optimizer step 2 (micro-steps 4 and 5)
DP_A = ["train.grad_accum=2", "train.limit_train_batches=0.67", "train.start_fine=1"]
# (c) a global batch of 2, 1 per rank, at grad_accum 2: 4 of 14 batches, the
# fine stage from optimizer step 1 (micro-steps 2 and 3); validation shards too
DP_C = ["train.batch_size=2", "train_dataset.batch_size=2", "test_dataset.batch_size=2",
        "train.grad_accum=2", "train.limit_train_batches=0.29", "train.start_fine=0"]
# (b) the CLI: 2 micro-steps of B=3 at grad_accum 1
DP_B = ["train.limit_train_batches=0.23"]
DP_CONFIG, DP_IMG = "configs/synthetic256.yaml", 256
DP_LOSS_RTOL = 5e-4            # tests/test_train.py:110
# (c)'s first all-reduced gradient, in float32, against one process that
# forwards one scene at a time as the ranks do (the f32 sums of the means
# and of the all-reduce in another order); against one process at batch 2
# it is held at TRAIN_GRAD_RTOL: a scene's forward rounds otherwise in a
# batch of 2, and the blend's order of near-coincident surfels follows
DP_SPLIT_RTOL = 1e-4
DP_EVAL_ATOL = 5e-3            # tests/test_eval.py:270


def float32_everywhere() -> None:
    """No TF32 in matmuls or cuDNN convolutions (MS-SSIM's blur),
    deterministic cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def params_digest(net) -> str:
    """A SHA-256 of the network's parameters."""
    h = hashlib.sha256()
    for prm in net.parameters():
        h.update(prm.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_config(store: str, logdir: str, *overrides) -> Config:
    return load_config("configs/base.yaml", DP_CONFIG, overrides=[
        f"train_dataset.data_root={store}", f"test_dataset.data_root={store}",
        f"logger.dir={logdir}", *DP_OVERRIDES, *overrides])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def dp_probes(rec: dict, dev, digests: bool):
    """Record in `rec` what the data-parallel checks read: the seconds of
    each gradient all-reduce, synchronised ("all_reduce_s"), and whether it
    left every gradient as it was ("reduce_identity"); the all-reduced
    gradient of the first optimizer step before the clip, on the host
    ("grads"); with `digests`, a SHA-256 of the parameters after each
    optimizer step ("digests"); the checkpoint files written and loggers
    made in this process ("writes", "loggers"); the parameters' names
    ("names")."""
    from lara_tpu_torch.train import checkpoint, loop
    from lara_tpu_torch.train import state as state_mod

    reduce_, clip, apply = (state_mod.all_reduce_grads_, state_mod.clip_by_global_norm_,
                            TrainState.apply_gradients)
    write, logger_init = checkpoint._write, loop.RunLogger.__init__
    rec.update(all_reduce_s=[], reduce_identity=[], grads=None, digests=[], writes=0, loggers=0)

    def timed_reduce(params):
        before = [prm.grad.clone() for prm in params]
        sync(dev)
        t0 = time.perf_counter()
        reduce_(params)
        sync(dev)
        rec["all_reduce_s"].append(time.perf_counter() - t0)
        rec["reduce_identity"].append(all(torch.equal(b, prm.grad)
                                          for b, prm in zip(before, params)))

    def first_grads(grads, max_norm):
        if rec["grads"] is None:
            rec["grads"] = [g.detach().cpu() for g in grads]
        return clip(grads, max_norm)

    def apply_gradients(self):
        rec.setdefault("names", [n for n, _ in self.net.named_parameters()])
        updated, info = apply(self)
        if updated and digests:
            rec["digests"].append(params_digest(self.net))
        return updated, info

    def counted(key, fn):
        def run(*a, **kw):
            rec[key] += 1
            return fn(*a, **kw)
        return run

    state_mod.all_reduce_grads_, state_mod.clip_by_global_norm_ = timed_reduce, first_grads
    TrainState.apply_gradients = apply_gradients
    checkpoint._write = counted("writes", write)
    loop.RunLogger.__init__ = counted("loggers", logger_init)
    try:
        yield
    finally:
        state_mod.all_reduce_grads_, state_mod.clip_by_global_norm_ = reduce_, clip
        TrainState.apply_gradients = apply
        checkpoint._write, loop.RunLogger.__init__ = write, logger_init


@contextlib.contextmanager
def per_scene_forward():
    """LaRaNet's forward one scene at a time, its outputs concatenated: one
    process then computes each scene as a rank with one scene does, and the
    loss of the whole batch from it."""
    forward = LaRaNet.forward

    def split(self, batch, **kw):
        n = len(next(iter(batch.values())))
        outs = [forward(self, {k: v[i:i + 1] for k, v in batch.items()}, **kw) for i in range(n)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    LaRaNet.forward = split
    try:
        yield
    finally:
        LaRaNet.forward = forward


def dp_train(dev, cfg: Config, digests: bool = False, f32: bool = False) -> dict:
    """A `Trainer` fit of `cfg` on `dev` (one rank of the group there is, or
    one process) under `counted_steps` and `dp_probes`, with `f32` the
    network in float32 (no bf16 autocast); returns the trainer, each train
    micro-step's loss, each step's launches, the launches of the fit and the
    probes' records."""
    import functools

    from lara_tpu_torch.train import loop

    log = [{"plain_blend": 0, "checkpoint_s": 0.0, "panel_write_s": 0.0}]
    rec: dict = {}
    reset_launches()
    with counted_steps(log), dp_probes(rec, dev, digests):
        if f32:
            loop.LaRaNet = functools.partial(LaRaNet, dtype=torch.float32)
        try:
            tr = loop.Trainer(cfg, device=dev)
        finally:
            loop.LaRaNet = LaRaNet
        tr.fit()
    if log[0]["plain_blend"] and dev.type == "cuda":
        raise AssertionError(f"data parallel: the plain blend ran {log[0]['plain_blend']} times")
    return {"trainer": tr, "losses": [e["loss"] for e in log[1:] if e["kind"] == "train"],
            "steps": [(e["kind"], e["launches"]) for e in log[1:]], "launches": launches(),
            "tp_steps": [(e["kind"], e["tp"]) for e in log[1:]], **rec}


def dp_evaluate(dev, store: str, ckpts: str, folder: str, batch_size: int) -> tuple:
    """`evaluate.main` on the checkpoint over the store's held-out scenes,
    metrics only; returns (metrics, launches)."""
    from lara_tpu_torch.evaluate import main as evaluate_main

    reset_launches()
    metrics = evaluate_main([
        DP_CONFIG, "infer_dataset.dataset_name=synthetic", f"infer_dataset.data_root={store}",
        f"infer_dataset.img_size=[{DP_IMG},{DP_IMG}]", f"infer_dataset.batch_size={batch_size}",
        "infer_dataset.num_workers=0", f"infer.ckpt_path={ckpts}", "infer.video_frames=0",
        "infer.save_mesh=False", f"infer.save_folder={folder}", f"infer.metric_path={folder}_m",
        f"--device={dev}"])
    return metrics, launches()


def dp_rank(rank: int, tmp: str, store: str, ckpts: str, device: str) -> None:
    """One of the two ranks of (c) and (d), spawned: its own gloo group on
    `device` (both ranks on one card), the trainer on its slice of the
    global batch of 2, then `evaluate` at batch size 2. Saves its results
    (rank 0 also its first all-reduced gradient) under `tmp`."""
    import datetime
    import os

    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    float32_everywhere()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'gloo')}",
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        res = dp_train(dev, dp_config(store, os.path.join(tmp, "dp2"), *DP_C),
                       digests=True, f32=True)
        tr = res.pop("trainer")
        res["n_sel"] = [m["n_sel"] for m in tr.micro_log]
        res["micro_s"] = [m["seconds"] for m in tr.micro_log]
        del tr
        res["metrics"], res["eval_launches"] = dp_evaluate(
            dev, store, ckpts, os.path.join(tmp, "eval2"), 2)
        grads = res.pop("grads")
        if rank == 0:
            torch.save(grads, os.path.join(tmp, "dp2_grads.pt"))
        torch.save(res, os.path.join(tmp, f"dp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rel_l2(got, want) -> float:
    return (torch.linalg.vector_norm(got - want)
            / max(torch.linalg.vector_norm(want).item(), 1e-30)).item()


def dp_phase(dev, tmp: str, store: str) -> dict:
    """(f) data parallelism on the one card, with `DP_CONFIG` on the trainer
    phase's store: (a) the trainer in a process group of world size 1 over
    NCCL and again with no group, bit for bit; then together (b) `python -m
    torch.distributed.run --standalone --nproc_per_node=1 -m
    lara_tpu_torch.train`, (c) two spawned ranks on `dev` over gloo, each
    on its slice of a global batch of 2, against this process at the same
    global batch, and (d) `evaluate` on those ranks at batch size 2 against
    this process at batch size 1, on (a)'s checkpoint. Raises on any
    failure; returns the launches of (a), (c) and (d)."""
    import os

    import torch.distributed as dist

    t_phase = time.perf_counter()
    # (a) world size 1, then no group
    runs = {}
    for tag in ("group", "none"):
        torch.cuda.empty_cache()
        if tag == "group":
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method=f"file://{os.path.join(tmp, 'world1')}",
                                    rank=0, world_size=1)
        try:
            run = dp_train(dev, dp_config(store, os.path.join(tmp, f"w1_{tag}"), *DP_A))
        finally:
            if tag == "group":
                dist.destroy_process_group()
        tr = run.pop("trainer")
        run["params"] = {n: p.detach().cpu() for n, p in tr.net.named_parameters()}
        run["micro"] = [(m["with_fine"], m["seconds"]) for m in tr.micro_log]
        runs[tag] = run
        del tr
    g, n = runs["group"], runs["none"]
    k = dp_config(store, tmp, *DP_A).train.grad_accum
    if len(g["losses"]) != 6 or g["steps"] != n["steps"] or g["losses"][:k] != n["losses"][:k] \
            or len(g["reduce_identity"]) != 3 or not all(g["reduce_identity"]):
        raise AssertionError(f"data parallel (a): losses {g['losses']} with the group, "
                             f"{n['losses']} without; launches equal: {g['steps'] == n['steps']}"
                             f"; the all-reduce left the gradient as it was: "
                             f"{g['reduce_identity']}")
    n_params = sum(v.numel() for v in g["params"].values())
    later = max(abs(a - b) / abs(b) for a, b in zip(g["losses"][k:], n["losses"][k:]))
    differ = [key for key, v in g["params"].items() if not torch.equal(v, n["params"][key])]
    worst = max(((g["params"][key] - n["params"][key]).abs().max().item() for key in differ),
                default=0.0)
    med = {tag: {f: statistics.median(s for w, s in r["micro"] if w == f)
                 for f in (False, True)} for tag, r in runs.items()}
    print(f"[dp-a] world size 1 over {'NCCL' if dev.type == 'cuda' else 'gloo'}: 6 micro-steps, "
          f"launches per step equal, the first optimizer step's {k} losses bit for bit those "
          f"without a group, and each gradient all-reduce left the gradient bit for bit; "
          f"after the first update (the backward is not bit-reproducible on the card, with or "
          f"without a group) the largest loss difference {later:.3e} (relative) and "
          f"{len(differ)} of {len(g['params'])} parameter tensors differ, by at most "
          f"{worst:.3e}; gradient all-reduce of the {n_params:,} parameters per optimizer "
          f"step (s) {' '.join(f'{x:.5f}' for x in g['all_reduce_s'])}; median s per "
          f"micro-step coarse / fine with the group {med['group'][False]:.4f} / "
          f"{med['group'][True]:.4f}, without {med['none'][False]:.4f} / "
          f"{med['none'][True]:.4f}")
    ckpts = os.path.join(tmp, "w1_group", "ckpts")
    del runs, n

    # (b), (c) and (d) at once: the CLI under torchrun, the two ranks, and
    # this process's references
    t0 = time.perf_counter()
    cli_dir = os.path.join(tmp, "cli")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "lara_tpu_torch.train", DP_CONFIG, f"train_dataset.data_root={store}",
         f"test_dataset.data_root={store}", f"logger.dir={cli_dir}", *DP_OVERRIDES, *DP_B,
         f"--device={dev.type}"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = torch.multiprocessing.spawn(dp_rank, args=(tmp, store, ckpts, str(dev)),
                                        nprocs=2, join=False)
    try:
        torch.cuda.empty_cache()
        one = dp_train(dev, dp_config(store, os.path.join(tmp, "dp1"), *DP_C), f32=True)
        del one["trainer"]
        with per_scene_forward():
            split = dp_train(dev, dp_config(store, os.path.join(tmp, "dp1s"), *DP_C), f32=True)
        del split["trainer"]
        want_eval, _ = dp_evaluate(dev, store, ckpts, os.path.join(tmp, "eval1"), 1)
        while not ranks.join(timeout=1):
            if time.perf_counter() - t0 > 600:
                raise TimeoutError("data parallel (c): the ranks did not finish in 600 s")
        cli_out, _ = cli.communicate(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    together_s = time.perf_counter() - t0

    # (b)
    from lara_tpu_torch.train.checkpoint import latest_step

    step = latest_step(os.path.join(cli_dir, "ckpts"))
    scalars = os.path.join(cli_dir, "scalars.jsonl")
    if cli.returncode != 0 or step != 2 or not os.path.getsize(scalars):
        raise AssertionError(f"data parallel (b): torchrun exited {cli.returncode}, "
                             f"checkpoint step {step}:\n{cli_out[-3000:]}")
    print(f"[dp-b] torchrun --nproc_per_node=1 -m lara_tpu_torch.train: exit 0, "
          f"2 micro-steps, scalars.jsonl and the checkpoint of step {step}")

    # (c)
    r0, r1 = (torch.load(os.path.join(tmp, f"dp_rank{r}.pt"), weights_only=False)
              for r in (0, 1))
    grads = torch.load(os.path.join(tmp, "dp2_grads.pt"), weights_only=True)
    names = one["names"]
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(r0["losses"], one["losses"]))
    grad_err = {k: rel_l2(a, b) for k, a, b in zip(names, grads, split["grads"])}
    batch_err = {k: rel_l2(a, b) for k, a, b in zip(names, grads, one["grads"])}
    worst, worst_b = max(grad_err, key=grad_err.get), max(batch_err, key=batch_err.get)
    problems = []
    if len(r0["losses"]) != 4 or r0["losses"] != r1["losses"] or loss_err > DP_LOSS_RTOL:
        problems.append(f"losses {r0['losses']} / {r1['losses']} against {one['losses']}")
    if grad_err[worst] > DP_SPLIT_RTOL or batch_err[worst_b] > TRAIN_GRAD_RTOL:
        problems.append(f"gradient of {worst}: relative L2 {grad_err[worst]:.3e} against one "
                        f"process forwarding one scene at a time; of {worst_b}: "
                        f"{batch_err[worst_b]:.3e} against one process at batch 2")
    if len(r0["digests"]) != 2 or r0["digests"] != r1["digests"]:
        problems.append(f"parameter digests {r0['digests']} / {r1['digests']}")
    if (r0["writes"], r0["loggers"], r1["writes"], r1["loggers"]) != (1, 1, 0, 0):
        problems.append(f"files: rank 0 {r0['writes']} checkpoint(s), {r0['loggers']} "
                        f"logger(s); rank 1 {r1['writes']}, {r1['loggers']}")
    if r0["n_sel"] != r1["n_sel"]:
        problems.append(f"views {r0['n_sel']} / {r1['n_sel']}")
    if dev.type == "cuda" and not all(r["launches"]["blend_fwd_stash"] and
                                      r["launches"]["blend_bwd"] for r in (r0, r1)):
        problems.append(f"launches {r0['launches']} / {r1['launches']}")
    # (d)
    m0, m1 = r0["metrics"], r1["metrics"]
    eval_err = max(np.max(np.abs(np.subtract(m0[k], want_eval[k]))) for k in ("psnr", "ssim"))
    if m0 != m1 or m0["scenes"] != want_eval["scenes"] or len(m0["scenes"]) != 4 \
            or eval_err > DP_EVAL_ATOL:
        problems.append(f"evaluate: {m0['scenes']} psnr {m0['psnr']} ssim {m0['ssim']} against "
                        f"{want_eval['scenes']} {want_eval['psnr']} {want_eval['ssim']}")
    if problems:
        raise AssertionError("data parallel (c)/(d): " + "; ".join(problems))
    print(f"[dp-c] 2 ranks on one card over gloo, global batch 2 at grad_accum 2: 4 micro-steps, "
          f"largest loss difference {loss_err:.3e} (relative) against one process at batch 2; "
          f"first optimizer step's gradient against one process forwarding one scene at a "
          f"time: largest relative L2 {grad_err[worst]:.3e} ({worst}), median over the "
          f"parameters {statistics.median(grad_err.values()):.3e}; against one process at "
          f"batch 2: {batch_err[worst_b]:.3e} ({worst_b}), median "
          f"{statistics.median(batch_err.values()):.3e}; parameters equal bit for bit after "
          f"both optimizer steps, rank 0 alone wrote; views {r0['n_sel']}; gloo all-reduce "
          f"(s) {' '.join(f'{x:.3f}' for x in r0['all_reduce_s'])} (a correctness check, "
          f"not a speed)")
    print(f"[dp-d] evaluate on 2 ranks at batch size 2 against 1 process at batch size 1: "
          f"scenes {m0['scenes']}, largest PSNR / SSIM difference {eval_err:.3e}")
    print(f"[dp] (b)-(d) together {together_s:.2f} s; phase {time.perf_counter() - t_phase:.2f} s")
    total = {k: g["launches"][k] + sum(r["launches"][k] + r["eval_launches"][k]
                                       for r in (r0, r1)) for k in g["launches"]}
    return {"launches": total, "all_reduce_s": g["all_reduce_s"], "micro_s": med}


# Tensor parallelism at dp=1×tp=2, two ranks sharing the card over gloo.
# (a) a global batch of 2 at grad_accum 2, every micro-step fine, in f32
TP_A = ["train.batch_size=2", "train_dataset.batch_size=2", "test_dataset.batch_size=2",
        "train.grad_accum=2", "train.limit_train_batches=0.29", "train.start_fine=-1"]
# (b) the flagship at 512², B=1, flash + replay, bf16: fine micro-steps
TP_B_STEPS = 3
# its first micro-step's loss against the same step in one process at
# tp=1: bf16 autocast rounds each split matmul's rows apart (2^-8 relative
# per rounding), and the loss averages those roundings
TP_B_LOSS_RTOL = 1e-2
# (c) the CLI: 2 micro-steps of B=1
TP_C = ["train.batch_size=1", "train_dataset.batch_size=1", "test_dataset.batch_size=1",
        "train.limit_train_batches=0.08", "train.tp=2"]


def tp_reckoning(cfg: Config, fine: bool, grad: bool = True) -> dict:
    """The tp collectives of one micro-step at tp=2, reckoned from the code
    (PERF.md §6): forward gathers of the encode, of each
    volume-transformer layer and of each render stage; with gradients the
    reduce-scatter of each, and each layer's gather again in the remat
    recomputation. (An eval step runs no remat.)"""
    forward = 1 + cfg.model.num_layers + 1 + int(fine)
    if not grad:
        return {"gather": forward, "reduce": 0}
    return {"gather": forward + (cfg.model.num_layers if cfg.model.remat else 0),
            "reduce": forward}


def tp_flagship_steps(dev, steps: int = TP_B_STEPS) -> dict:
    """(b) on this rank (tp enabled by the caller; off for the reference):
    the flagship `Config()` with flash attention and the replay backward,
    bf16, one 512² scene of 4 + 4 views, `steps` fine micro-steps from
    micro-step 2002; each one's seconds (synchronised), the seconds of its
    tp collectives (each synchronised before and after), launches,
    collective counts and stats; peak memory; the parameters' digest after
    the optimizer step."""
    cfg = with_knobs(Config())
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch = make_batch(13, cfg.n_views, dev, scenes=1)
    state = TrainState(net, cfg.train, max_iters=30000, step=2002)
    step = make_train_step(net, state, True, cfg.train.grad_accum)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rec = {"micro_s": [], "launches": [], "tp": [], "stats": [], "collective_s": []}
    for _ in range(steps):
        before, tp_before = launches(), dict(tp.COUNTS)
        sync(dev)
        t0 = time.perf_counter()
        with tp.timed_collectives(dev):
            stats = step(batch)
        sync(dev)
        rec["micro_s"].append(time.perf_counter() - t0)
        rec["launches"].append({k: v - before[k] for k, v in launches().items()})
        rec["tp"].append({k: v - tp_before[k] for k, v in tp.COUNTS.items()})
        rec["collective_s"].append(rec["tp"][-1]["gather_s"] + rec["tp"][-1]["reduce_s"])
        rec["stats"].append({k: v.item() for k, v in stats.items()})
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    rec["digest"] = params_digest(net)
    rec["total"] = launches()
    rec["renders"] = 2 * batch["tar_rgb"].shape[1] // 2       # two stages, half the views
    return rec


def tp_rank(rank: int, tmp: str, store: str, device: str) -> None:
    """One of the two ranks of the tensor-parallel phase, spawned: its own
    gloo group on `device` (both ranks on one card), then (a) the trainer
    at train.tp=2 in f32 on the global batch of 2, (b) `tp_flagship_steps`,
    (c) `python -m lara_tpu_torch.train`'s `main` at train.tp=2. Saves its
    results (rank 0 also (a)'s first all-reduced gradient) under `tmp`."""
    import datetime
    import os

    import torch.distributed as dist

    from lara_tpu_torch.train.__main__ import main as train_main

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    float32_everywhere()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'tp_gloo')}",
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        t0 = time.perf_counter()
        a = dp_train(dev, dp_config(store, os.path.join(tmp, "tp2"), *TP_A, "train.tp=2"),
                     digests=True, f32=True)
        tr = a.pop("trainer")
        a["n_sel"] = [m["n_sel"] for m in tr.micro_log]
        a["broadcasts"] = [(m["tp"]["broadcast"], m["tp"]["broadcast_bytes"])
                           for m in tr.micro_log]
        layout = tr.layout
        del tr
        grads = a.pop("grads")
        if rank == 0:
            torch.save(grads, os.path.join(tmp, "tp2_grads.pt"))
        del grads
        res = {"a": a, "a_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tp.enabled_for(layout):
            res["b"] = tp_flagship_steps(dev)
        res["b_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec: dict = {}
        reset_launches()
        with dp_probes(rec, dev, False):
            train_main([DP_CONFIG, f"train_dataset.data_root={store}",
                        f"test_dataset.data_root={store}",
                        f"logger.dir={os.path.join(tmp, 'tp_cli')}", *DP_OVERRIDES, *TP_C],
                       device=str(dev))
        res["c"] = {"writes": rec["writes"], "loggers": rec["loggers"], "launches": launches(),
                    "all_reduces": len(rec["all_reduce_s"])}
        res["c_s"] = time.perf_counter() - t0
        torch.save(res, os.path.join(tmp, f"tp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_phase(dev, tmp: str, store: str) -> dict:
    """(g) tensor parallelism on the one card, two spawned ranks at dp=1×tp=2
    over gloo (`tp_rank`), while this process runs the references at
    tp=1 of (a) and of (b)'s first micro-step: (a) `DP_CONFIG` on the trainer phase's store in f32, a global
    batch of 2, grad_accum 2, 4 fine micro-steps and a validation: each
    loss within 5e-4 relative of the reference, the first all-reduced
    gradient within 5e-3 relative L2 per parameter, the ranks' parameters
    bit for bit after each optimizer step, the same batch broadcast to
    both ranks every micro-step, rank 0 alone writing, each rank
    launching half of the reference's blend kernels per step, and each
    step's tp collectives the reckoning; (b) the flagship at 512² with
    flash and the replay backward in bf16: launches and collectives per
    micro-step, finite and equal stats, equal parameters, the first
    micro-step's loss within TP_B_LOSS_RTOL of tp=1's; prints peak
    memory, the median micro-step and the bytes gathered; (c) the CLI at
    train.tp=2: rank 0 writes its scalars and the checkpoint of step 2.
    Raises on any failure; returns the ranks' launches."""
    import os

    from lara_tpu_torch.train.checkpoint import latest_step

    t_phase = time.perf_counter()
    ranks = torch.multiprocessing.spawn(tp_rank, args=(tmp, store, str(dev)), nprocs=2,
                                        join=False)
    try:
        torch.cuda.empty_cache()
        ref = dp_train(dev, dp_config(store, os.path.join(tmp, "tp1"), *TP_A), f32=True)
        del ref["trainer"]
        torch.cuda.empty_cache()
        ref_b = tp_flagship_steps(dev, steps=1)
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_phase
        while not ranks.join(timeout=1):
            if time.perf_counter() - t_phase > 600:
                raise TimeoutError("tensor parallel: the ranks did not finish in 600 s")
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
    r0, r1 = (torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False)
              for r in (0, 1))
    grads = torch.load(os.path.join(tmp, "tp2_grads.pt"), weights_only=True)

    # (a)
    a0, a1 = r0["a"], r1["a"]
    cfg_a = dp_config(store, tmp, *TP_A)
    names = ref["names"]
    problems = []
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(a0["losses"], ref["losses"]))
    grad_err = {k: rel_l2(a, b) for k, a, b in zip(names, grads, ref["grads"])}
    worst = max(grad_err, key=grad_err.get)
    if len(a0["losses"]) != 4 or a0["losses"] != a1["losses"] or loss_err > DP_LOSS_RTOL:
        problems.append(f"losses {a0['losses']} / {a1['losses']} against {ref['losses']}")
    if grad_err[worst] > TRAIN_GRAD_RTOL:
        problems.append(f"gradient of {worst}: relative L2 {grad_err[worst]:.3e}")
    if len(a0["digests"]) != 2 or a0["digests"] != a1["digests"]:
        problems.append(f"parameter digests {a0['digests']} / {a1['digests']}")
    if (a0["writes"], a0["loggers"], a1["writes"], a1["loggers"]) != (1, 1, 0, 0):
        problems.append(f"files: rank 0 {a0['writes']} checkpoint(s), {a0['loggers']} "
                        f"logger(s); rank 1 {a1['writes']}, {a1['loggers']}")
    if a0["n_sel"] != a1["n_sel"] or len(a0["all_reduce_s"]) != 2:
        problems.append(f"views {a0['n_sel']} / {a1['n_sel']}; gradient all-reduces "
                        f"{len(a0['all_reduce_s'])}")
    if a0["broadcasts"] != a1["broadcasts"] or not all(n for n, _ in a0["broadcasts"]):
        problems.append(f"batch broadcasts {a0['broadcasts']} / {a1['broadcasts']}")
    halves = ("blend_fwd_stash", "blend_bwd", "blend_fwd")
    cuda = dev.type == "cuda"
    if a0["steps"] != a1["steps"] or [k for k, _ in a0["steps"]] != [k for k, _ in ref["steps"]] \
            or any(2 * got[k] != want[k] for (_, got), (_, want) in zip(a0["steps"], ref["steps"])
                   for k in halves) \
            or cuda and not all(got["blend_fwd_stash"] for kind, got in a0["steps"]
                                if kind == "train"):
        problems.append(f"launches per step {a0['steps']} / {a1['steps']}, at tp=1 "
                        f"{ref['steps']}")
    for r in (a0, a1):
        for kind, got in r["tp_steps"]:
            want = tp_reckoning(cfg_a, True, kind == "train")
            if {k: got[k] for k in want} != want:
                problems.append(f"{kind} step collectives {got}, reckoned {want}")
    # (b)
    b0, b1 = r0["b"], r1["b"]
    cfg_b = with_knobs(Config())
    want_b = want_launches(cfg_b, b0["renders"]) if cuda else b0["launches"][0]
    want_tp = tp_reckoning(cfg_b, True)
    for b in (b0, b1):
        for i, (got, tpc, st) in enumerate(zip(b["launches"], b["tp"], b["stats"])):
            if got != want_b or {k: tpc[k] for k in want_tp} != want_tp \
                    or not all(np.isfinite(list(st.values()))):
                problems.append(f"(b) micro-step {i}: launches {got} (want {want_b}), "
                                f"collectives {tpc} (want {want_tp}), stats {st}")
    if b0["stats"] != b1["stats"] or b0["digest"] != b1["digest"]:
        problems.append(f"(b) ranks differ: losses {[s['loss'] for s in b0['stats']]} / "
                        f"{[s['loss'] for s in b1['stats']]}")
    want_loss = ref_b["stats"][0]["loss"]
    b_err = abs(b0["stats"][0]["loss"] - want_loss) / max(1.0, abs(want_loss))
    if not b_err <= TP_B_LOSS_RTOL:
        problems.append(f"(b) first micro-step's loss {b0['stats'][0]['loss']} against "
                        f"{want_loss} at tp=1: relative {b_err:.3e}")
    # (c)
    cli_dir = os.path.join(tmp, "tp_cli")
    scalars = os.path.join(cli_dir, "scalars.jsonl")
    c0, c1 = r0["c"], r1["c"]
    if latest_step(os.path.join(cli_dir, "ckpts")) != 2 or not os.path.exists(scalars) \
            or not os.path.getsize(scalars) or (c0["writes"], c0["loggers"]) != (1, 1) \
            or (c1["writes"], c1["loggers"]) != (0, 0) \
            or cuda and not all(c["launches"]["blend_fwd_stash"] for c in (c0, c1)):
        problems.append(f"(c) checkpoint step {latest_step(os.path.join(cli_dir, 'ckpts'))}, "
                        f"writes {c0} / {c1}")
    if problems:
        raise AssertionError("tensor parallel: " + "; ".join(problems))

    train_steps = [s for kind, s in a0["tp_steps"] if kind == "train"]
    print(f"[tp-a] dp=1×tp=2, 2 ranks on one card over gloo, f32, global batch 2 at grad_accum "
          f"2: 4 fine micro-steps and {len(a0['tp_steps']) - 4} eval step(s); largest loss "
          f"difference {loss_err:.3e} (relative) against one process at tp=1; first optimizer "
          f"step's gradient: largest relative L2 {grad_err[worst]:.3e} ({worst}), median "
          f"{statistics.median(grad_err.values()):.3e}; parameters equal bit for bit after both "
          f"optimizer steps, rank 0 alone wrote; views {a0['n_sel']}; launches per step "
          f"(rank, tp=1) " + " ".join(
              f"{kind}:{got['blend_fwd_stash'] or got['blend_fwd']}/"
              f"{want['blend_fwd_stash'] or want['blend_fwd']}"
              for (kind, got), (_, want) in zip(a0["steps"], ref["steps"]))
          + f"; tp collectives per fine micro-step {train_steps[0]['gather']} gathers + "
          f"{train_steps[0]['reduce']} reduce-scatters (reckoned {tp_reckoning(cfg_a, True)}), "
          f"{train_steps[0]['gather_bytes'] / 1e6:.1f} + {train_steps[0]['reduce_bytes'] / 1e6:.1f}"
          f" MB; batch broadcasts per micro-step {a0['broadcasts'][0][0]} "
          f"({a0['broadcasts'][0][1] / 1e6:.1f} MB); gradient all-reduces "
          f"{len(a0['all_reduce_s'])} (s "
          f"{' '.join(f'{x:.3f}' for x in a0['all_reduce_s'])}); rank seconds {r0['a_s']:.2f}, "
          f"reference {ref_s:.2f}")
    for r, b in ((0, b0), (1, b1)):
        print(f"[tp-b] rank {r}: flagship 512², B=1, 4 + 4 views, bf16, flash + replay, tp=2: "
              f"micro-steps (s) {' '.join(f'{x:.3f}' for x in b['micro_s'])}, median "
              f"{statistics.median(b['micro_s']):.3f}, of it in the tp collectives (s) "
              f"{' '.join(f'{x:.3f}' for x in b['collective_s'])}; peak {b['peak_gb']:.2f} GB; gathered "
              f"{b['tp'][-1]['gather_bytes'] / 1e6:.1f} MB and reduce-scattered "
              f"{b['tp'][-1]['reduce_bytes'] / 1e6:.1f} MB per micro-step in "
              f"{b['tp'][-1]['gather']} + {b['tp'][-1]['reduce']} collectives; launches per "
              f"micro-step {json.dumps({k: v for k, v in b['launches'][0].items() if v})}; "
              f"losses {' '.join(format(st['loss'], '.5f') for st in b['stats'])}, the first "
              f"against one process at tp=1 {want_loss:.5f} (relative {b_err:.3e}) (readings "
              f"through gloo on one card, not a speed)")
    print(f"[tp-c] python -m lara_tpu_torch.train at train.tp=2 on 2 gloo ranks: 2 micro-steps, "
          f"rank 0 wrote scalars.jsonl and the checkpoint of step 2, rank 1 nothing; launches "
          f"rank 0 {json.dumps({k: v for k, v in c0['launches'].items() if v})}")
    print(f"[tp] ranks (a) {r0['a_s']:.2f} s, (b) {r0['b_s']:.2f} s, (c) {r0['c_s']:.2f} s; "
          f"phase {time.perf_counter() - t_phase:.2f} s")
    total = {k: sum(r["a"]["launches"][k] + r["b"]["total"][k] + r["c"]["launches"][k]
                    for r in (r0, r1)) for k in launches()}
    return {"launches": total}


def kernel_records(kernel, backward, flash_res, serving, binning, train, train_knobs,
                   evaluation, infer, mvgen, dp, tp_res, raster) -> list:
    """The kernels line: each kernel's launches on its paths (the blend
    forward's on the serving, evaluate, infer-dataset, mvgen, data- and
    tensor-parallel paths,
    the stash forward's and backward's on the flagship, data- and
    tensor-parallel training paths, the replay backward's and the flash
    kernels' on the flash training, evaluate and tensor-parallel paths;
    the four blend kernels' also on the raster tools' paths),
    its largest error against the plain
    version, its time beside the plain version's, the library call's (flash)
    and its bound, at the path's shapes."""
    bwd, fl, win = backward["train"], flash_res["train"], binning["train"]
    src, pallas = "lara_tpu_torch/csrc/", "lara_tpu/ops/rasterizer/pallas_blend.py"

    def rec(name, source, replaces, n, err, ms, plain_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    return [
        rec("blend_fwd", "blend_fwd.cu", pallas + ":398",
            serving["launches"]["blend_fwd"] + evaluation["launches"]["blend_fwd"]
            + infer["launches"]["blend_fwd"] + mvgen["launches"]["blend_fwd"]
            + dp["launches"]["blend_fwd"]
            + tp_res["launches"]["blend_fwd"] + raster["launches"]["blend_fwd"],
            max(r["max_abs_err"] for r in kernel.values()), kernel["eval"]["ms"],
            kernel["eval"]["plain_ms"], (kernel["eval"]["bound_ms"], kernel["eval"]["bound_by"])),
        rec("blend_fwd_stash", "blend_fwd.cu", pallas + ":398",
            train["launches"]["blend_fwd_stash"] + dp["launches"]["blend_fwd_stash"]
            + tp_res["launches"]["blend_fwd_stash"] + raster["launches"]["blend_fwd_stash"],
            max(r["fwd_max_abs_err"] for r in backward.values()), bwd["fwd_stash_ms"],
            bwd["fwd_stash_plain_ms"], bwd["fwd_stash_bound"]),
        rec("blend_bwd", "blend_bwd.cu", pallas + ":457",
            train["launches"]["blend_bwd"] + dp["launches"]["blend_bwd"]
            + tp_res["launches"]["blend_bwd"] + raster["launches"]["blend_bwd"],
            max(r["max_abs_err"] for r in backward.values()), bwd["bwd_ms"],
            bwd["bwd_plain_ms"], bwd["bwd_bound"]),
        rec("blend_bwd_replay", "blend_bwd.cu", pallas + ":432",
            train_knobs["launches"]["blend_bwd_replay"] + tp_res["launches"]["blend_bwd_replay"]
            + raster["launches"]["blend_bwd_replay"],
            max(r["max_abs_err"] for r in backward.values()), bwd["replay_ms"],
            bwd["bwd_plain_ms"], bwd["replay_bound"]),
        rec("flash_fwd", "flash_fwd.cu", "lara_tpu/ops/flash.py:78",
            train_knobs["launches"]["flash_fwd"] + evaluation["launches"]["flash_fwd"]
            + infer["launches"]["flash_fwd"] + mvgen["launches"]["flash_fwd"]
            + tp_res["launches"]["flash_fwd"],
            max(r["max_abs_err"] for r in flash_res.values()), fl["fwd_ms"],
            fl["fwd_plain_ms"], fl["fwd_bound"], fl["fwd_library_ms"]),
        rec("flash_bwd", "flash_bwd.cu", "lara_tpu/ops/flash.py:78",
            train_knobs["launches"]["flash_bwd"] + tp_res["launches"]["flash_bwd"],
            max(r["max_abs_err"] for r in flash_res.values()),
            fl["bwd_ms"], fl["bwd_plain_ms"], fl["bwd_bound"], fl["bwd_library_ms"]),
        rec("tile_windows", "tile_windows.cu", "tools/profile_binning.py:204",
            binning["tool_launches"]["tile_windows"],
            max(binning[c]["max_abs_err"] for c in ("train", "eval")), win["ms"],
            win["plain_ms"], (win["bound_ms"], win["bound_by"]), win["library_ms"]),
    ]


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
    float32_everywhere()

    start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
        return res

    phase("build", _build.build_library)
    build_phase_report()
    check_hgmma()
    kernel = phase("forward kernel", kernel_phase, dev)
    backward = phase("backward kernels (stash and replay)", backward_phase, dev)
    flash_res = phase("flash attention", flash_phase, dev)
    serving = phase("serving (default, then flash attention)", slice_phase, dev)
    binning = phase("binning (window kernel, bin modes, profiler)", binning_phase, dev, serving)
    torch.cuda.empty_cache()
    raster = phase("raster tools (reference backend, fine budget, sweeps, profilers)",
                   raster_tools_phase, dev)
    torch.cuda.empty_cache()
    phase("train (reduced)", train_reduced_phase, dev, False)
    phase("train (reduced, flash + replay)", train_reduced_phase, dev, True)
    train = phase("train (flagship)", train_flagship_phase, dev, False)
    torch.cuda.empty_cache()
    train_knobs = phase("train (flagship, flash + replay)", train_flagship_phase, dev, True)
    print(f"[train] fine micro-step s default {' '.join(f'{x:.3f}' for x in train['micro_s'])}"
          f" peak {train['peak_gb']:.2f} GB; flash + replay "
          f"{' '.join(f'{x:.3f}' for x in train_knobs['micro_s'])} peak "
          f"{train_knobs['peak_gb']:.2f} GB; + dots {train_knobs['dots_s']:.3f} s peak "
          f"{train_knobs['dots_peak_gb']:.2f} GB")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lara_trainer_") as tmp:
        trainer = phase("trainer (configs/synthetic256.yaml)", trainer_phase, dev, tmp)
        print("[trainer] launches on the trainer path: " + json.dumps(
            {"run": {k: trainer["launches"][k]
                     for k in ("blend_fwd_stash", "blend_bwd", "blend_fwd")},
             "resume": {k: trainer["resume_launches"][k]
                        for k in ("blend_fwd_stash", "blend_bwd", "blend_fwd")}}))
        torch.cuda.empty_cache()
        evaluation = phase("evaluate (checkpoint at 256², then serving at 512²)",
                           evaluate_phase, dev, tmp, trainer)
        mesh = start_mesh_render(evaluation["obj"], os.path.join(tmp, "turntable.mp4"))
        try:
            torch.cuda.empty_cache()
            dp = phase("data parallel (world size 1, torchrun, 2 ranks, evaluate)", dp_phase,
                       dev, tmp, trainer["store"])
            torch.cuda.empty_cache()
            tp_res = phase("tensor parallel (dp=1×tp=2: f32 against tp=1, flagship 512², CLI)",
                           tp_phase, dev, tmp, trainer["store"])
            phase("mesh turntable (started after the evaluate phase)", finish_mesh_render,
                  mesh, smi)
        finally:
            if mesh["proc"].poll() is None:
                mesh["proc"].kill()
                mesh["proc"].wait()
    print("[evaluate] launches on the evaluate paths: "
          + json.dumps({k: v for k, v in evaluation["launches"].items() if v}))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lara_infer_") as tmp:
        infer = phase("infer datasets (GSO, converter, instant3d, mipnerf360)",
                      infer_datasets_phase, dev, tmp, smi)
        torch.cuda.empty_cache()
        mvgen = phase("single image → 3D (mvgen: zero123plus-v1.1 through evaluate, v1.2, "
                      "sv3d)", mvgen_phase, dev, tmp, smi)
    print("[infer] launches on the infer-dataset paths: "
          + json.dumps({k: v for k, v in infer["launches"].items() if v}))

    print("[mvgen] launches on the mvgen paths: "
          + json.dumps({k: v for k, v in mvgen["launches"].items() if v}))
    print("[dp] launches on the data-parallel paths: "
          + json.dumps({k: v for k, v in dp["launches"].items() if v}))
    print("[tp] launches on the tensor-parallel paths: "
          + json.dumps({k: v for k, v in tp_res["launches"].items() if v}))
    records = kernel_records(kernel, backward, flash_res, serving, binning, train, train_knobs,
                             evaluation, infer, mvgen, dp, tp_res, raster)
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
