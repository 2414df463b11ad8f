"""Google Scanned Objects evaluation dataset, the counterpart of
`lara_tpu/data/gso.py` (dataLoader/google_scanned_objects.py of the
reference).

On disk, one folder per scene:
  <scene>/transforms.json          frames[i].transform_matrix (Blender c2w)
                                   and frames[i].intrinsic_matrix (3×3, for
                                   the 512² renders)
  <scene>/r_{i:03d}.png            RGBA renders, 512²
  <scene>/depth/r_{i:03d}.pfm      z-depth of the same views
Poses go to OpenCV by the Blender-to-camera flip; views are grouped by
KMeans over the camera positions at init (`data/kmeans.py`, sklearn's
labels); near/far are fixed to (0.5, 2.5).

The files are read with the port's own PNG reader and resize
(`data/image_io.py`, bit for bit those of imageio and OpenCV). As in the
JAX package, `tar_dep` keeps the PFM's size, so depth metrics need the
served size to be the file's (512² for GSO's renders).
"""

from __future__ import annotations

import json
import os

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.decode import build_rays_batch, composite_rgba
from lara_tpu_torch.data.image_io import read_pfm, read_png, resize
from lara_tpu_torch.data.kmeans import kmeans_groups
from lara_tpu_torch.utils.camera import canonicalize_cameras_np, intrinsic_to_fov

B2C = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)


class GSODataset:
    def __init__(self, cfg: DatasetConfig, rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.img_downscale = self.img_size / 512
        self.n_group = cfg.n_group
        self.rng = rng or np.random.default_rng(0)
        self.data_root = cfg.data_root

        self.scenes_name = np.array(sorted(
            e.name for e in os.scandir(self.data_root) if e.is_dir()))
        self.scene_infos = {s: self._build_meta(s) for s in self.scenes_name}

    def _build_meta(self, scene: str) -> dict:
        with open(os.path.join(self.data_root, scene, "transforms.json")) as f:
            info = json.load(f)
        out = {"ixts": [], "c2ws": [], "w2cs": [], "fovx": [], "fovy": [],
               "img_paths": [], "depth_paths": []}
        for idx, frame in enumerate(info["frames"]):
            c2w = np.array(frame["transform_matrix"], np.float32) @ B2C
            ixt = np.array(frame["intrinsic_matrix"], np.float32)
            fx, fy = intrinsic_to_fov(ixt)
            out["ixts"].append(ixt)
            out["c2ws"].append(c2w)
            out["w2cs"].append(np.linalg.inv(c2w))
            out["fovx"].append(fx)
            out["fovy"].append(fy)
            out["img_paths"].append(os.path.join(self.data_root, scene, f"r_{idx:03d}.png"))
            out["depth_paths"].append(
                os.path.join(self.data_root, scene, f"depth/r_{idx:03d}.pfm"))
        pos = np.stack([c2w[:3, 3] for c2w in out["c2ws"]])
        out["groups"] = kmeans_groups(pos, self.n_group)
        out["groups_4"] = kmeans_groups(pos, 4)
        return out

    def __len__(self):
        return len(self.scenes_name)

    def _read_image(self, info: dict, idx: int, bg: np.ndarray):
        img = read_png(info["img_paths"][idx])
        H, W = int(self.img_size[1]), int(self.img_size[0])
        if self.img_downscale[0] != 1 or self.img_downscale[1] != 1:
            img = resize(img, (W, H))
        rgb, mask = composite_rgba(img, bg)
        depth, _ = read_pfm(info["depth_paths"][idx])
        if depth.ndim == 3:
            depth = depth[..., 0]
        return rgb, mask, depth.astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        scene_name = str(self.scenes_name[index])
        info = self.scene_infos[scene_name]
        n = self.n_group
        if self.split == "train":
            views = [int(self.rng.choice(info["groups"][i])) for i in self.rng.permutation(n)]
            views += [int(self.rng.choice(info["groups"][i])) for i in self.rng.permutation(n)]
        else:
            views = [int(info["groups"][i][0]) for i in range(n)]
            views += [int(info["groups_4"][i][-1]) for i in range(4)]

        bg = np.ones(3, np.float32)
        imgs, deps, msks, ixts = [], [], [], []
        for idx in views:
            img, msk, dep = self._read_image(info, idx, bg)
            imgs.append(img)
            msks.append(msk)
            deps.append(dep)
            ixt = info["ixts"][idx].copy()
            ixt[:2] = ixt[:2] * self.img_downscale.reshape(2, 1)
            ixts.append(ixt)

        tar_ixts = np.stack(ixts)
        tar_c2ws, tar_w2cs, transform_mats = canonicalize_cameras_np(
            np.stack([info["c2ws"][i] for i in views]),
            np.stack([info["w2cs"][i] for i in views]))
        H, W = int(self.img_size[1]), int(self.img_size[0])
        return {
            "fovx": np.float32(info["fovx"][views[0]]),
            "fovy": np.float32(info["fovy"][views[0]]),
            "tar_c2w": tar_c2ws,
            "tar_w2c": tar_w2cs,
            "tar_ixt": tar_ixts,
            "tar_rgb": np.stack(imgs),
            "tar_dep": np.stack(deps),
            "tar_msk": np.stack(msks),
            "bg_color": np.tile(bg[None], (len(views), 1)),
            "transform_mats": transform_mats,
            "near_far": np.array([0.5, 2.5], np.float32),
            "meta": {"scene": scene_name, "tar_view": views, "tar_h": H, "tar_w": W},
            "tar_rays": build_rays_batch(tar_c2ws, tar_ixts, H, W, 1.0),
            "tar_rays_down": build_rays_batch(tar_c2ws, tar_ixts, H, W, 1.0 / 16),
        }
