"""Instant3D-style 4-camera-rig dataset, the counterpart of
`lara_tpu/data/instant3d.py` (dataLoader/instant3d.py of the reference).

On disk, one folder:
  opencv_cameras.json   frames[0..3]: w2c (4×4), fx, fy, cx, cy of the rig,
                        for one mosaic tile
  <name>.png            one scene each: a 2×2 mosaic of the 4 views (RGB,
                        or RGBA composited over white)
The rig's translations are divided by 1.7 (instant3d.py:31-53); each tile
is resized to the served size in float32 (`data/image_io.py:resize`, as
cv2.resize) and the intrinsics rescaled with it; near/far = r ± 0.8 for the
first camera's distance r. A sample holds the 4 views alone (the standard
[N, H, W, 3] contract; the reference's [H, 4W, 3] mosaic is not served).
"""

from __future__ import annotations

import json
import os

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.decode import build_rays_batch, composite_rgba
from lara_tpu_torch.data.image_io import read_png, resize
from lara_tpu_torch.utils.camera import canonicalize_cameras_np, intrinsic_to_fov


class Instant3DDataset:
    def __init__(self, cfg: DatasetConfig, rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.img_size = np.array(cfg.img_size)
        self.data_root = cfg.data_root
        self.scenes_name = sorted(e.name for e in os.scandir(self.data_root)
                                  if e.is_file() and e.name.endswith(".png"))
        self._build_camera()

    def _build_camera(self):
        with open(os.path.join(self.data_root, "opencv_cameras.json")) as f:
            info = json.load(f)
        c2ws, w2cs, ixts = [], [], []
        for frame in info["frames"][:4]:
            c2w = np.linalg.inv(np.array(frame["w2c"], np.float32))
            c2w[:3, 3] /= 1.7
            c2ws.append(c2w)
            w2cs.append(np.linalg.inv(c2w))
            ixt = np.eye(3, dtype=np.float32)
            ixt[0, 0], ixt[1, 1] = frame["fx"], frame["fy"]
            ixt[0, 2], ixt[1, 2] = frame["cx"], frame["cy"]
            ixts.append(ixt)
        self.c2ws = np.stack(c2ws)
        self.w2cs = np.stack(w2cs)
        self.ixts = np.stack(ixts)

    def __len__(self):
        return len(self.scenes_name)

    def __getitem__(self, index: int) -> dict:
        name = self.scenes_name[index]
        mosaic = read_png(os.path.join(self.data_root, name))
        if mosaic.shape[-1] == 4:
            mosaic = composite_rgba(mosaic, np.ones(3, np.float32))[0]
        else:
            mosaic = mosaic.astype(np.float32) / 255.0
        h2, w2 = mosaic.shape[0] // 2, mosaic.shape[1] // 2
        views = np.stack([mosaic[:h2, :w2], mosaic[:h2, w2:],
                          mosaic[h2:, :w2], mosaic[h2:, w2:]])

        H, W = int(self.img_size[1]), int(self.img_size[0])
        if views.shape[1] != H or views.shape[2] != W:
            views = np.stack([resize(v, (W, H)) for v in views])

        scale = np.array([W, H]) / np.array([w2, h2])
        ixts = self.ixts.copy()
        ixts[:, 0] *= scale[0]
        ixts[:, 1] *= scale[1]

        c2ws, w2cs, transform_mats = canonicalize_cameras_np(self.c2ws.copy(),
                                                             self.w2cs.copy())
        r = np.linalg.norm(self.c2ws[0, :3, 3])
        fovx, fovy = intrinsic_to_fov(ixts[0], w=W, h=H)
        return {
            "tar_rgb": views,
            "tar_c2w": c2ws, "tar_w2c": w2cs, "tar_ixt": ixts,
            "bg_color": np.ones((4, 3), np.float32),
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "fovx": np.float32(fovx), "fovy": np.float32(fovy),
            "transform_mats": transform_mats,
            "meta": {"scene": name.split(".")[0], "tar_h": H, "tar_w": W},
            "tar_rays": build_rays_batch(c2ws, ixts, H, W, 1.0),
            "tar_rays_down": build_rays_batch(c2ws, ixts, H, W, 1.0 / 16),
        }
