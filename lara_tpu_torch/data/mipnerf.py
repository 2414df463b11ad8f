"""MipNeRF-360 / LLFF real-capture dataset, the counterpart of
`lara_tpu/data/mipnerf.py` (dataLoader/mipnerf.py of the reference, marked
experimental there).

On disk, one scene folder:
  poses_bounds.npy   LLFF [N, 17]: a 3×5 pose (c2w with an [H, W, focal]
                     column, "down-right-back" axes) and near/far per view
  images_4/*         the views at a quarter of H × W (PNG; sorted names)
Poses become "right-up-back", are centred on their average pose and moved
to OpenCV axes, scaled so the nearest bound sits at 1/0.75, and their
translations halved (mipnerf.py:151-173). Every 8th view is held out (the
test split); each image is INTER_AREA-resized to W/4 × H/4 where it is not
that size already (`data/image_io.py:resize`, as cv2.resize). The epoch
length is a nominal 1000 and each sample is 4 random views from the `rng`
with full masks (mipnerf.py:229-266).
"""

from __future__ import annotations

import os

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.decode import build_rays_batch
from lara_tpu_torch.data.image_io import INTER_AREA, read_png, resize
from lara_tpu_torch.utils.camera import intrinsic_to_fov

_BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def _normalize(v):
    return v / np.linalg.norm(v)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Average c2w of LLFF poses [N, 3, 4] (centre, viewing direction, up)."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    y_ = poses[:, :3, 1].sum(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """Poses [N, 3, 4] re-centred on their average, in OpenCV axes; returns
    (poses [N, 3, 4], the average as 4×4)."""
    avg = average_pose(poses)
    avg_h = np.eye(4)
    avg_h[:3] = avg
    last = np.broadcast_to(np.array([0, 0, 0, 1.0]), (len(poses), 1, 4))
    poses_h = np.concatenate([poses, last], 1)
    centered = (np.linalg.inv(avg_h) @ poses_h) @ _BLENDER2OPENCV
    return centered[:, :3], avg_h


class MipNeRF360Dataset:
    def __init__(self, cfg: DatasetConfig, rng: np.random.Generator | None = None,
                 hold_every: int = 8, downsample: float = 4.0):
        self.cfg = cfg
        self.split = cfg.split
        self.rng = rng or np.random.default_rng(0)

        pb = np.load(os.path.join(cfg.data_root, "poses_bounds.npy"))
        folder = os.path.join(cfg.data_root, "images_4")
        self.image_paths = sorted(os.path.join(folder, e.name) for e in os.scandir(folder))
        poses = pb[:, :15].reshape(-1, 3, 5)
        self.near_fars = pb[:, -2:].copy()
        hwf = poses[:, :, -1]
        H, W, _ = poses[0, :, -1]
        self.img_wh = np.array([int(W / downsample), int(H / downsample)])

        # down-right-back → right-up-back
        poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        poses, _ = center_poses(poses)
        scale = self.near_fars.min() * 0.75
        self.near_fars /= scale
        poses[..., 3] /= scale

        i_test = np.arange(0, len(poses), hold_every)
        idx = (i_test if self.split != "train"
               else np.array(sorted(set(range(len(poses))) - set(i_test))))

        c2ws, w2cs, ixts, imgs, fovxs, fovys = [], [], [], [], [], []
        for i in idx:
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3] = poses[i].astype(np.float32)
            c2w[:3, 3] /= 2.0
            img = self._read(self.image_paths[i])
            if img.shape[1] != self.img_wh[0] or img.shape[0] != self.img_wh[1]:
                img = resize(img, tuple(self.img_wh), INTER_AREA)
            hh, ww, f = hwf[i]
            fx = f * self.img_wh[0] / ww
            fy = f * self.img_wh[1] / hh
            ixt = np.array([[fx, 0, self.img_wh[0] / 2],
                            [0, fy, self.img_wh[1] / 2], [0, 0, 1]], np.float32)
            fovx, fovy = intrinsic_to_fov(ixt, self.img_wh[0], self.img_wh[1])
            c2ws.append(c2w)
            w2cs.append(np.linalg.inv(c2w))
            ixts.append(ixt)
            imgs.append(img.astype(np.float32) / 255.0)
            fovxs.append(fovx)
            fovys.append(fovy)

        self.c2ws = np.stack(c2ws)
        self.w2cs = np.stack(w2cs)
        self.ixts = np.stack(ixts)
        self.imgs = np.stack(imgs)
        self.fovx = np.array(fovxs, np.float32)
        self.fovy = np.array(fovys, np.float32)

    @staticmethod
    def _read(path: str) -> np.ndarray:
        if not path.lower().endswith(".png"):
            raise ValueError(f"{path}: the port reads PNG images only (convert the "
                             "capture's images_4/ to PNG)")
        return read_png(path)[..., :3]

    def __len__(self):
        return 1000  # epoch length is nominal (mipnerf.py:229)

    def __getitem__(self, index: int) -> dict:
        view_id = self.rng.permutation(len(self.c2ws))[:4]
        W, H = self.img_wh
        ret = {
            "fovx": np.float32(self.fovx[view_id[0]]),
            "fovy": np.float32(self.fovy[view_id[0]]),
            "tar_c2w": self.c2ws[view_id],
            "tar_w2c": self.w2cs[view_id],
            "tar_ixt": self.ixts[view_id],
            "tar_rgb": self.imgs[view_id],
            "tar_msk": np.ones((len(view_id), H, W), np.uint8),
            "bg_color": np.ones((len(view_id), 3), np.float32),
            "near_far": np.array([self.near_fars.min(), self.near_fars.max()], np.float32),
            "transform_mats": np.eye(4, dtype=np.float32)[None],
            "meta": {"scene": os.path.basename(self.cfg.data_root),
                     "tar_h": int(H), "tar_w": int(W)},
        }
        ret["tar_rays"] = build_rays_batch(ret["tar_c2w"], ret["tar_ixt"], H, W, 1.0)
        ret["tar_rays_down"] = build_rays_batch(ret["tar_c2w"], ret["tar_ixt"], H, W, 1.0 / 16)
        return ret
