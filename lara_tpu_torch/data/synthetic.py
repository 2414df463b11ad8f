"""Synthetic scenes: analytic shaded spheres in the gobjaverse schema, the
counterpart of `lara_tpu/data/synthetic.py`, written as an `.npy` scene
store (`data/gobjverse.py:NpyStore`) so that no HDF5 library is needed.

`write_synthetic_store` draws from `np.random.default_rng(seed)` in the
order `lara_tpu/data/synthetic.py:write_synthetic_h5` does, so one seed
gives the same scenes, bit for bit, in either format."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.gobjverse import GObjaverseDataset
from lara_tpu_torch.utils.camera import build_rays_np, fov_to_ixt


def _orbit_c2w(radius, azim, elev):
    eye = np.array([
        radius * np.cos(elev) * np.sin(azim),
        radius * np.sin(elev),
        -radius * np.cos(elev) * np.cos(azim),
    ], np.float32)
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, 1.0, 0.0], np.float32), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def render_spheres(c2w, ixt, H, W, spheres):
    """Analytic lambertian render of spheres [(center, radius, albedo)].
    Returns rgba [H, W, 4] u8 and normal [H, W, 3] u8."""
    rays = build_rays_np(c2w[None], ixt[None], H, W, 1.0)[0]
    o, d = rays[..., :3], rays[..., 3:]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    light = np.array([0.5, 0.8, -0.3])
    light = light / np.linalg.norm(light)

    best_t = np.full((H, W), np.inf, np.float32)
    rgb = np.zeros((H, W, 3), np.float32)
    nrm = np.zeros((H, W, 3), np.float32)
    for center, radius, albedo in spheres:
        oc = o - center
        b = np.sum(oc * d, -1)
        c = np.sum(oc * oc, -1) - radius * radius
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 0) & (t < best_t)
        p = o + t[..., None] * d
        n = (p - center) / radius
        shade = np.clip(n @ light, 0, 1) * 0.8 + 0.2
        col = np.asarray(albedo)[None, None] * shade[..., None]
        rgb = np.where(hit[..., None], col, rgb)
        nrm = np.where(hit[..., None], n, nrm)
        best_t = np.where(hit, t, best_t)

    alpha = (np.isfinite(best_t)).astype(np.float32)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return (np.clip(rgba, 0, 1) * 255).astype(np.uint8), \
        ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)


def write_synthetic_store(path: str, n_scenes: int = 4, n_views: int = 12,
                          img_size=(64, 64), radius: float = 1.8, seed: int = 0) -> str:
    """Write `n_scenes` sphere scenes into the new directory `path`: per
    scene `scene_{s:04d}/` with image_i.npy [H,W,4] u8, normal_i.npy [H,W,3]
    u8, c2w_i.npy [4,4] f32, fov_i.npy [2] f32 and contiguous azimuth
    clusters in groups/groups_{n}_{i}.npy (u8) for n in 2..6, standing in for
    the KMeans view groups of tools/prepare_dataset_objaverse.py:133-152.
    Every random draw is made first, in write_synthetic_h5's order; the
    scenes are then rendered by a thread each (NumPy releases the GIL in its
    array work). The store is written beside `path` and renamed into place
    when whole."""
    rng = np.random.default_rng(seed)
    W, H = img_size
    fov = np.array([0.69, 0.69], np.float32)  # ~40°, gobjaverse-like
    ixt = fov_to_ixt(fov, np.array([W, H]))
    scenes = []
    for _ in range(n_scenes):
        n_sph = rng.integers(2, 5)
        spheres = [
            (rng.uniform(-0.25, 0.25, 3).astype(np.float32),
             float(rng.uniform(0.1, 0.3)),
             rng.uniform(0.2, 1.0, 3).astype(np.float32))
            for _ in range(n_sph)
        ]
        scenes.append((spheres, rng.uniform(-0.3, 0.5, n_views)))
    azims = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    path = os.path.normpath(path)
    tmp = f"{path}.tmp{os.getpid()}"

    def write_scene(s: int) -> None:
        spheres, elevs = scenes[s]
        scene = os.path.join(tmp, f"scene_{s:04d}")
        os.makedirs(os.path.join(scene, "groups"))
        for i in range(n_views):
            c2w = _orbit_c2w(radius, azims[i], elevs[i])
            rgba, normal = render_spheres(c2w, ixt, H, W, spheres)
            for name, arr in ((f"image_{i}", rgba), (f"normal_{i}", normal),
                              (f"c2w_{i}", c2w), (f"fov_{i}", fov)):
                np.save(os.path.join(scene, name + ".npy"), arr)
        for n in range(2, 7):
            for i, cl in enumerate(np.array_split(np.arange(n_views), n)):
                np.save(os.path.join(scene, "groups", f"groups_{n}_{i}.npy"),
                        cl.astype(np.uint8))

    with ThreadPoolExecutor(max_workers=min(n_scenes, os.cpu_count() or 1) or 1) as pool:
        for fut in [pool.submit(write_scene, s) for s in range(n_scenes)]:
            fut.result()
    os.rename(tmp, path)
    return path


class SyntheticDataset(GObjaverseDataset):
    """gobjaverse-schema dataset over a synthetic scene store, written on
    first use (at most 256 scenes, at least 4) when `data_root` is missing."""

    def __init__(self, cfg: DatasetConfig, rng=None):
        if not os.path.exists(cfg.data_root):
            os.makedirs(os.path.dirname(cfg.data_root) or ".", exist_ok=True)
            write_synthetic_store(cfg.data_root, n_scenes=max(4, min(cfg.n_scenes, 256)),
                                  img_size=tuple(cfg.img_size))
        super().__init__(cfg, rng=rng)
