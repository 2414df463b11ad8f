"""Orbit video rendering and TSDF mesh extraction from a surfel set, the
counterpart of `lara_tpu/eval/render_artifacts.py` (evaluation.py:118-155 +
tools/meshExtractor.py).

The canonical orbit (120 frames by default) becomes an mp4 where OpenCV
imports, and a directory of PNG frames elsewhere (the JAX package falls
back to a GIF through imageio; the GPU machine has neither). 48 orbit
depth / colour renders (3 elevations × 16) are fused into a TSDF, meshed
by marching tetrahedra and cleaned to the largest clusters. Every render
runs through `ops/renderer.py:render_view` on the device of the surfels,
so on the card through the blend forward kernel.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from lara_tpu_torch.config import Config
from lara_tpu_torch.eval.tsdf import TSDFVolume, keep_largest_clusters, save_obj
from lara_tpu_torch.eval.video_path import PathCamera, uni_mesh_path, uni_video_path
from lara_tpu_torch.eval.vis import write_png
from lara_tpu_torch.models.lara import make_cameras
from lara_tpu_torch.ops.rasterizer import RasterizeConfig
from lara_tpu_torch.ops.rasterizer.api import resolve_backend
from lara_tpu_torch.ops.renderer import render_view


def _render_frames(cams: List[PathCamera], gauss, cfg: Config,
                   img_size: Tuple[int, int]) -> List[Dict[str, np.ndarray]]:
    """Render each path camera from `gauss` = (centers, shs, opacity,
    scaling, rotation) tensors of one scene, at the eval tile budget with
    every visible surfel kept (as the JAX package's path renders); returns
    each frame's maps as NumPy arrays."""
    centers = gauss[0]
    dev = centers.device
    W, H = img_size
    r = cfg.render
    rcfg = RasterizeConfig(
        height=H, width=W, tile=r.tile, dup=r.dup, tile_budget=r.eval_tile_budget,
        sh_degree=cfg.model.sh_degree, pallas_chunk=min(r.pallas_chunk, r.eval_tile_budget),
        backend=resolve_backend(r.backend))
    bg = torch.ones(3, device=dev)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    frames = []
    with torch.inference_mode():
        for c in cams:
            cam = make_cameras(torch.as_tensor(c.c2w, device=dev), scalar(c.fovx),
                               scalar(c.fovy), scalar(c.znear), scalar(c.zfar))
            f = render_view(cam, None, *gauss, bg, rcfg)
            frames.append({k: v.cpu().numpy() for k, v in f.items()})
    return frames


def render_video(path: str, gauss, cfg: Config, transform_mats,
                 n_frames: int = 120, fps: int = 30, sample=None) -> str:
    """Render the orbit and write it to `path` (mp4) where cv2 imports and
    opens a writer, else as `<path without extension>/frame_%04d.png`.
    Returns what was written. `sample` (optional): the scene's batch dict,
    needed for mipnerf360, whose LLFF spiral is built from the sample's
    poses (tar_c2w) and depth bounds (near_far)."""
    img_size = tuple(cfg.infer_dataset.img_size)
    c2ws = near_fars = sample_fov = None
    if sample is not None:
        c2ws = np.asarray(sample["tar_c2w"]).reshape(-1, 4, 4)
        near_fars = np.asarray(sample["near_far"])
        sample_fov = (float(np.ravel(sample["fovx"])[0]),
                      float(np.ravel(sample["fovy"])[0]))
    name = cfg.infer_dataset.dataset_name
    cams = uni_video_path(n_frames, name, img_size, transform_mats,
                          fov=sample_fov if name in ("mipnerf360", "mipnerf") else None,
                          c2ws=c2ws, near_fars=near_fars)
    frames = _render_frames(cams, gauss, cfg, img_size)
    return write_video(path, [(np.clip(f["image"], 0, 1) * 255).astype(np.uint8)
                              for f in frames], fps)


def write_video(path: str, rgb: List[np.ndarray], fps: int) -> str:
    """uint8 RGB frames → the mp4 `path` where cv2 imports and opens a
    writer, else `<path without extension>/frame_%04d.png`. Returns what
    was written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = rgb[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if writer.isOpened():
            for fr in rgb:
                writer.write(fr[..., ::-1])
            writer.release()
            return path
    folder = os.path.splitext(path)[0]
    os.makedirs(folder, exist_ok=True)
    for i, fr in enumerate(rgb):
        write_png(os.path.join(folder, f"frame_{i:04d}.png"), fr)
    return folder


def extract_mesh(path: str, gauss, cfg: Config, transform_mats,
                 n_views: int = 16, voxel_size: float = 2 / 256,
                 sdf_trunc: float = 0.08, alpha_thres: float = 0.08,
                 depth_trunc: float = 10.0) -> str:
    """48 orbit renders (3 elevations × 16) → TSDF → cleaned mesh .obj
    (tools/meshExtractor.py:51-135 defaults)."""
    img_size = tuple(cfg.infer_dataset.img_size)
    cams = uni_mesh_path(n_views, cfg.infer_dataset.dataset_name, img_size, transform_mats)
    frames = _render_frames(cams, gauss, cfg, img_size)

    vol = TSDFVolume(np.array([[-0.55, -0.55, -0.55], [0.55, 0.55, 0.55]]),
                     voxel_size=voxel_size, sdf_trunc=sdf_trunc)
    for cam, f in zip(cams, frames):
        depth = f["depth"][..., 0].copy()
        depth[f["acc_map"] < alpha_thres] = 0.0
        vol.integrate(depth.astype(np.float32),
                      np.clip(f["image"], 0, 1).astype(np.float32),
                      cam.ixt, np.linalg.inv(cam.c2w), depth_trunc=depth_trunc)

    v, c, t = vol.extract_mesh()
    v, c, t = keep_largest_clusters(v, c, t, keep=10)
    save_obj(path, v, t, c)
    return path
