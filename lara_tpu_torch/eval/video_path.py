"""Orbit camera paths for video rendering and mesh extraction, a copy of
`lara_tpu/eval/video_path.py` (tools/gen_video_path.py of the reference).

The gobjaverse/GSO orbit starts from a fixed canonical pose (line 24-25),
rotates about the canonical z axis in N steps, and is mapped into the scene
frame by the sample's first-view transform; the instant3d/mvgen variant
uses its own rig (lines 55-66). `uni_mesh_path` runs 3 elevations × N views
(line 122)."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from lara_tpu_torch.data.mipnerf import average_pose
from lara_tpu_torch.utils.camera import fov_to_ixt


def _rot(axis: str, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    if axis == "x":
        m[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
    elif axis == "y":
        m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    else:
        m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return m


class PathCamera:
    """Plain host-side camera for generated paths (tools/camera.py MiniCam
    equivalent: c2w + fov + near/far + extent)."""

    def __init__(self, c2w, width, height, fovy, fovx, znear, zfar):
        self.c2w = np.asarray(c2w, np.float32)
        self.width, self.height = int(width), int(height)
        self.fovx, self.fovy = float(fovx), float(fovy)
        self.znear, self.zfar = float(znear), float(zfar)

    @property
    def ixt(self) -> np.ndarray:
        return fov_to_ixt(np.array([self.fovx, self.fovy]),
                          np.array([self.width, self.height]))


def generate_gobjverse_frames(N, img_size, transform_mats=None, elevation=0.0,
                              fov=None) -> List[PathCamera]:
    width, height = img_size
    znear, zfar = 0.5, 2.5
    fovx = fovy = 0.75  # the reference overrides the sample fov (line 16)

    elev = _rot("y", elevation / 180.0 * math.pi)
    tm = np.eye(4, dtype=np.float32) if transform_mats is None else \
        np.asarray(transform_mats, np.float32).reshape(4, 4)

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[0, 1.0, 0.0],
                            [0.4515947, 0.0, -0.8922232],
                            [-0.8922232, 0, -0.4515947]], np.float32).T
    c2w[:3, 3] = [1.70006549, 0.0, 0.8604804]
    c2w = elev @ c2w

    frames = [PathCamera(tm @ c2w, width, height, fovy, fovx, znear, zfar)]
    step = _rot("z", 2 * math.pi / N)
    for _ in range(N - 1):
        c2w = step @ c2w
        frames.append(PathCamera(tm @ c2w, width, height, fovy, fovx, znear, zfar))
    return frames


def generate_instant3d_frames(N, img_size, transform_mats=None, elevation=0.0,
                              fov=None) -> List[PathCamera]:
    width, height = img_size
    znear, zfar = 1.0, 3.0
    fovx, fovy = (0.7, 0.7) if fov is None else (float(fov[0]), float(fov[1]))

    elev = _rot("x", elevation / 180.0 * math.pi)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[-7.0710677e-01, 2.4184476e-01, -6.6446304e-01],
                            [7.0710677e-01, 2.4184476e-01, -6.6446304e-01],
                            [-5.2163419e-17, -9.3969262e-01, -3.4202015e-01]])
    c2w[:3, 3] = [1.328926, 1.328926, 6.8404031e-01]
    c2w = elev @ c2w

    if transform_mats is None:
        tm = np.array([[-7.0710677e-01, 7.0710677e-01, 7.8504622e-17, 0],
                       [2.4184476e-01, 2.4184476e-01, -9.3969262e-01, 0],
                       [-6.6446304e-01, -6.6446304e-01, -3.4202015e-01, 0],
                       [0, 0, 0, 1]], np.float32)
    else:
        tm = np.asarray(transform_mats, np.float32).reshape(4, 4)

    frames = [PathCamera(tm @ c2w, width, height, fovy, fovx, znear, zfar)]
    step = _rot("z", 2 * math.pi / N)
    for _ in range(N - 1):
        c2w = step @ c2w
        frames.append(PathCamera(tm @ c2w, width, height, fovy, fovx, znear, zfar))
    return frames


def _look_at(z_dir, y_hint, pos) -> np.ndarray:
    """Right-handed OpenCV c2w (forward = +z toward the target, det +1)
    from a viewing direction / y-axis hint / position. The reference's LLFF
    `viewmatrix` (dataLoader/mipnerf.py:80-88) emits the right-up-back
    convention with a flipped x column; our renderer consumes the OpenCV
    convention the datasets serve, so the same trajectory is expressed in
    that frame instead."""
    z = z_dir / np.linalg.norm(z_dir)
    x = np.cross(y_hint, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3] = np.stack([x, y, z, pos], 1)
    return m


def generate_mipnerf_frames(N, img_size, c2ws, near_fars, fov=None,
                            rads_scale: float = 1.0, n_rots: int = 2,
                            z_rate: float = 0.5) -> List[PathCamera]:
    """LLFF spiral around the average pose (dataLoader/mipnerf.py:90-118):
    focus depth from a dt=0.75 harmonic blend of the scene depth bounds,
    spiral radii from the 90th percentile of |camera translations|, n_rots
    turns with a z oscillation at z_rate. `c2ws` [V,4,4] and `near_fars`
    [V,2] (or [2]) come from the dataset's centered/rescaled poses."""
    width, height = img_size
    c2ws = np.asarray(c2ws, np.float64)
    nf = np.asarray(near_fars, np.float64).reshape(-1, 2)
    fovx, fovy = (0.7, 0.7) if fov is None else (float(fov[0]), float(fov[1]))

    avg = np.eye(4)
    avg[:3] = average_pose(c2ws[:, :3])
    up = c2ws[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)

    close, far = nf.min() * 0.9, nf.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close + dt / far)
    rads = np.percentile(np.abs(c2ws[:, :3, 3]), 90, axis=0) * rads_scale
    rads = np.concatenate([rads, [1.0]])

    # focus point sits `focal` ahead of the average camera (+z = forward in
    # the OpenCV frames the dataset serves)
    focus_pt = avg[:3, :4] @ np.array([0, 0, focal, 1.0])
    frames = []
    for theta in np.linspace(0.0, 2.0 * math.pi * n_rots, N + 1)[:-1]:
        offs = np.array([np.cos(theta), -np.sin(theta),
                         -np.sin(theta * z_rate), 1.0]) * rads
        pos = avg[:3, :4] @ offs
        c2w = _look_at(focus_pt - pos, up, pos)
        frames.append(PathCamera(c2w, width, height, fovy, fovx,
                                 float(nf.min()), float(nf.max())))
    return frames


def uni_video_path(N, dataset_name, img_size, transform_mats=None, fov=None,
                   c2ws=None, near_fars=None):
    if dataset_name in ("gobjeverse", "gobjaverse", "GSO", "synthetic"):
        return generate_gobjverse_frames(N, img_size, transform_mats, fov=fov)
    if dataset_name in ("instant3d", "mvgen"):
        return generate_instant3d_frames(N, img_size, transform_mats, fov=fov)
    if dataset_name in ("mipnerf360", "mipnerf"):
        if c2ws is None or near_fars is None:
            raise ValueError("mipnerf360 video path needs the sample's "
                             "c2ws + near_fars (LLFF spiral)")
        return generate_mipnerf_frames(N, img_size, c2ws, near_fars, fov=fov)
    raise ValueError(f"no video path generator for {dataset_name!r}")


def uni_mesh_path(N, dataset_name, img_size, transform_mats=None, fov=None):
    frames = []
    for elevation in (0.0, -30.0, 30.0):
        if dataset_name in ("gobjeverse", "gobjaverse", "GSO", "synthetic"):
            frames.extend(generate_gobjverse_frames(N, img_size, transform_mats,
                                                    elevation, fov=fov))
        else:
            frames.extend(generate_instant3d_frames(N, img_size, transform_mats,
                                                    elevation, fov=fov))
    return frames
