"""Synthetic scenes: analytic shaded spheres in the gobjaverse schema, the
counterpart of `lara_tpu/data/synthetic.py`, written as an `.npy` scene
store (`data/gobjverse.py:NpyStore`) so that no HDF5 library is needed.

`write_synthetic_store` draws from `np.random.default_rng(seed)` in the
order `lara_tpu/data/synthetic.py:write_synthetic_h5` does, so one seed
gives the same scenes, bit for bit, in either format. The writers of the
evaluation layouts (GSO, instant3d, LLFF) and the stand-in generators of
the mvgen front end (`fake_zero123plus_pipeline`, `sphere_mvgen_pipeline`)
follow."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.gobjverse import GObjaverseDataset
from lara_tpu_torch.data.gso import B2C
from lara_tpu_torch.data.image_io import encode_png, write_pfm
from lara_tpu_torch.data.mvgen import RIGS, SV3D_AZIMUTHS, fxfycxcy_to_pixel_ixt, \
    generate_input_camera
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


def render_spheres(c2w, ixt, H, W, spheres, with_depth: bool = False):
    """Analytic lambertian render of spheres [(center, radius, albedo)].
    Returns rgba [H, W, 4] u8 and normal [H, W, 3] u8, and with `with_depth`
    the z-depth [H, W] f32 of the hits (0 elsewhere)."""
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
    out = ((np.clip(rgba, 0, 1) * 255).astype(np.uint8),
           ((nrm * 0.5 + 0.5) * 255).astype(np.uint8))
    if with_depth:
        z = np.where(alpha > 0, best_t * (d @ np.asarray(c2w[:3, 2], np.float32)), 0.0)
        out += (z.astype(np.float32),)
    return out


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

    _in_threads(write_scene, [(s,) for s in range(n_scenes)])
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


# ------------------------------------------------- the evaluation datasets


EVAL_FOV = 0.8              # field of view (radians) of every evaluation-layout writer
EVAL_RADIUS = 1.5           # camera distance of the GSO and instant3d scenes
LLFF_STORED = 2             # images_4/ holds twice the served size


def _sphere_cameras(n: int, radius: float, rng: np.random.Generator) -> list:
    """`n` OpenCV c2w looking at the origin from a Fibonacci sphere of
    directions (the upper 80 %), radius and direction jittered."""
    k = np.arange(n) + 0.5
    elev = np.arcsin(1.0 - 1.6 * k / n)
    azim = np.pi * (1 + 5 ** 0.5) * k
    elev = elev + rng.normal(scale=0.03, size=n)
    r = radius * (1 + rng.normal(scale=0.02, size=n))
    return [_orbit_c2w(r[i], azim[i], np.clip(elev[i], -1.4, 1.4)) for i in range(n)]


def _sphere_scene(rng: np.random.Generator, extent: float = 0.25) -> list:
    return [(rng.uniform(-extent, extent, 3).astype(np.float32), float(rng.uniform(0.1, 0.3)),
             rng.uniform(0.2, 1.0, 3).astype(np.float32)) for _ in range(rng.integers(2, 5))]


def _in_threads(fn, items) -> None:
    """fn(*item) for every item, a thread each up to the core count (NumPy
    and zlib release the GIL in their array work); every result is read,
    so a failure raises here."""
    with ThreadPoolExecutor(max_workers=max(1, min(len(items), os.cpu_count() or 1))) as pool:
        for fut in [pool.submit(fn, *it) for it in items]:
            fut.result()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_gso_folder(root: str, n_scenes: int = 3, n_views: int = 24, size: int = 512,
                     depth_size: int | None = None, seed: int = 0) -> str:
    """Sphere scenes in the GSO layout of `data/gso.py`: per scene
    `object_{s:03d}/` with `transforms.json` (Blender-convention
    `transform_matrix`, `intrinsic_matrix` of the size² renders),
    `r_{i:03d}.png` RGBA written with every row filter in turn
    (`image_io.encode_png(..., "cycle")`) and the analytic z-depth
    `depth/r_{i:03d}.pfm` at depth_size² (default size²), cameras spread
    over a sphere of radius `EVAL_RADIUS`."""
    rng = np.random.default_rng(seed)
    depth_size = depth_size or size
    fov = np.array([EVAL_FOV, EVAL_FOV], np.float32)
    ixt = fov_to_ixt(fov, np.array([size, size]))
    dixt = fov_to_ixt(fov, np.array([depth_size] * 2))
    scenes = [(_sphere_scene(rng), _sphere_cameras(n_views, EVAL_RADIUS, rng))
              for _ in range(n_scenes)]
    jobs = []
    for s, (spheres, cams) in enumerate(scenes):
        scene = os.path.join(root, f"object_{s:03d}")
        os.makedirs(os.path.join(scene, "depth"), exist_ok=True)
        frames = [{"transform_matrix": (c2w @ B2C).tolist(), "intrinsic_matrix": ixt.tolist()}
                  for c2w in cams]
        with open(os.path.join(scene, "transforms.json"), "w") as f:
            json.dump({"frames": frames}, f)
        jobs += [(scene, i, c2w, spheres) for i, c2w in enumerate(cams)]

    def view(scene, i, c2w, spheres):
        rgba, _, depth = render_spheres(c2w, ixt, size, size, spheres, with_depth=True)
        _write(os.path.join(scene, f"r_{i:03d}.png"), encode_png(rgba, "cycle"))
        if depth_size != size:
            depth = render_spheres(c2w, dixt, depth_size, depth_size, spheres,
                                   with_depth=True)[2]
        write_pfm(os.path.join(scene, "depth", f"r_{i:03d}.pfm"), depth)

    _in_threads(view, jobs)
    return root


def write_instant3d_folder(root: str, n_scenes: int = 2, tile: int = 512, seed: int = 0) -> str:
    """Sphere scenes in the Instant3D layout of `data/instant3d.py`: one
    2×2 mosaic `scene_{s:02d}.png` (RGBA, tile² views) per scene and the
    rig's `opencv_cameras.json` (4 views 90° apart at 20° elevation; w2c
    translations at 1.7 × `EVAL_RADIUS`, the dataset divides them by 1.7)."""
    rng = np.random.default_rng(seed)
    ixt = fov_to_ixt(np.array([EVAL_FOV, EVAL_FOV], np.float32), np.array([tile, tile]))
    cams = [_orbit_c2w(EVAL_RADIUS, a, np.deg2rad(20.0)) for a in np.arange(4) * np.pi / 2]
    os.makedirs(root, exist_ok=True)
    frames = []
    for c2w in cams:
        rig = c2w.copy()
        rig[:3, 3] *= 1.7
        frames.append({"w2c": np.linalg.inv(rig).tolist(), "fx": float(ixt[0, 0]),
                       "fy": float(ixt[1, 1]), "cx": float(ixt[0, 2]), "cy": float(ixt[1, 2])})
    with open(os.path.join(root, "opencv_cameras.json"), "w") as f:
        json.dump({"frames": frames}, f)

    def scene(s, spheres):
        views = [render_spheres(c2w, ixt, tile, tile, spheres)[0] for c2w in cams]
        mosaic = np.concatenate([np.concatenate(views[:2], 1), np.concatenate(views[2:], 1)], 0)
        _write(os.path.join(root, f"scene_{s:02d}.png"), encode_png(mosaic))

    _in_threads(scene, [(s, _sphere_scene(rng)) for s in range(n_scenes)])
    return root


def write_llff_folder(root: str, n_views: int = 16, size=(512, 512), seed: int = 0) -> str:
    """A forward-facing sphere capture in the LLFF layout of
    `data/mipnerf.py`: `poses_bounds.npy` ([N, 17]: "down-right-back" c2w
    with the full-size [H, W, focal] column, near/far) for a capture of
    4 × `size` (W, H), and `images_4/img_{i:03d}.png` RGB at `LLFF_STORED`
    × `size`, so the dataset serves `size` after an INTER_AREA resize."""
    rng = np.random.default_rng(seed)
    W, H = size
    spheres = [(np.array([x, y, z], np.float32), float(r), rng.uniform(0.2, 1.0, 3)
                .astype(np.float32)) for x, y, z, r in
               zip(rng.uniform(-0.6, 0.6, 6), rng.uniform(-0.4, 0.4, 6),
                   rng.uniform(2.5, 4.5, 6), rng.uniform(0.2, 0.5, 6))]
    stored = LLFF_STORED
    focal = 0.5 * 4 * W / np.tan(0.5 * EVAL_FOV)           # at the capture's full size
    f = focal * stored / 4
    ixt = np.array([[f, 0, stored * W / 2], [0, f, stored * H / 2], [0, 0, 1]], np.float32)
    rows, jobs = [], []
    for i in range(n_views):
        c2w = np.eye(4, dtype=np.float32)              # OpenCV: looking down +z
        theta = 2 * np.pi * i / n_views
        c2w[:3, 3] = [0.3 * np.cos(theta), 0.2 * np.sin(theta), 0.1 * np.sin(2 * theta)]
        x, y, z, t = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3]
        pose = np.stack([y, x, -z, t, [4 * H, 4 * W, focal]], 1)
        rows.append(np.concatenate([pose.ravel(), [1.5, 6.0]]))
        jobs.append((i, c2w))
    folder = os.path.join(root, "images_4")
    os.makedirs(folder, exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))

    def view(i, c2w):
        rgba = render_spheres(c2w, ixt, stored * H, stored * W, spheres)[0]
        _write(os.path.join(folder, f"img_{i:03d}.png"), encode_png(rgba[..., :3]))

    _in_threads(view, jobs)
    return root


# ------------------------------------- stand-in generators for mvgen


def fake_zero123plus_pipeline(image: np.ndarray) -> np.ndarray:
    """The procedural zero123plus stand-in of the JAX package's tests
    (tests/test_datasets.py:112), same contract and values: a 3×2 grid
    [288, 192, 3] in [0, 1] of 96² tiles, each a saturated disc on the
    model's gray background whose position and hue follow the tile index
    and whose radius follows the conditioning image's mean."""
    h = w = 96
    mean = float(np.mean(image))
    tiles = []
    for v in range(6):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cx = w / 2 + 10 * np.cos(v * np.pi / 3)
        cy = h / 2 + 10 * np.sin(v * np.pi / 3)
        r = np.hypot(xx - cx, yy - cy)
        inside = (r < 16 + 12 * mean).astype(np.float32)[..., None]
        color = np.array([0.95 if (v + 1) & (1 << c) else 0.05
                          for c in range(3)], np.float32)
        tiles.append(inside * color + (1 - inside) * 0.5)
    rows = [np.concatenate(tiles[i * 2:(i + 1) * 2], axis=1) for i in range(3)]
    return np.concatenate(rows, axis=0).astype(np.float32)


# saturated albedos: far from the gray and white backgrounds at any shade
_PALETTE = np.array([[0.9, 0.15, 0.1], [0.1, 0.8, 0.2], [0.15, 0.3, 0.9],
                     [0.9, 0.75, 0.1], [0.75, 0.1, 0.85], [0.1, 0.75, 0.8]], np.float32)


def sphere_mvgen_pipeline(backend: str, size: int | None = None):
    """A generator backend that renders one sphere scene from the backend's
    own camera poses, so that its views agree across viewpoints: for
    zero123plus a 3×2 grid of `size`² tiles (default 320) on gray 0.5 at
    the model's six poses (the rig's elevations alternating, yaw 225 + 30,
    90, ..., 330; tiles 0, 2, 4, 5 are `RIGS[backend]`'s poses), for sv3d
    21 frames of `size`² (default 576) on white at elevation 20, yaw 225 +
    `SV3D_AZIMUTHS`. Radius 2.7 and the rig's fov throughout. The scene (a
    central sphere of radius 0.35 and three smaller ones 0.4 from the
    origin, within 0.6 of it: in view of every rig, and within ±0.35 of
    the canonical volume after `build_mvgen_batch`'s 1/1.7) is drawn from
    seed 0; the central sphere's colour
    follows the conditioning image's mean."""
    radius, poses, fov = RIGS[backend]
    if backend.startswith("zero123plus"):
        size = size or 320
        hi, lo = poses[0][0], poses[3][0]
        poses = [(hi if v % 2 == 0 else lo, 225 + 30 + 60 * v) for v in range(6)]
        bg = 0.5
    else:
        size = size or 576
        poses = [(20, 225 + a) for a in SV3D_AZIMUTHS]
        bg = 1.0
    c2ws, fxfycxcy = generate_input_camera(radius, poses, fov=fov)
    ixt = fxfycxcy_to_pixel_ixt(fxfycxcy, size, size)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(3, 3))
    centers = 0.4 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    others = [(c.astype(np.float32), float(rng.uniform(0.12, 0.2)),
               _PALETTE[rng.integers(len(_PALETTE))]) for c in centers]

    def run(image: np.ndarray) -> np.ndarray:
        hue = int(float(np.mean(image)) * 6 * 255) % len(_PALETTE)
        spheres = [(np.zeros(3, np.float32), 0.35, _PALETTE[hue])] + others
        views = [None] * len(c2ws)

        def view(i):
            rgba = render_spheres(c2ws[i], ixt, size, size, spheres)[0].astype(np.float32) / 255
            views[i] = rgba[..., :3] * rgba[..., 3:] + bg * (1 - rgba[..., 3:])

        _in_threads(view, [(i,) for i in range(len(c2ws))])
        if backend.startswith("zero123plus"):
            return np.concatenate([np.concatenate(views[i:i + 2], 1) for i in (0, 2, 4)], 0)
        return np.stack(views)

    return run
