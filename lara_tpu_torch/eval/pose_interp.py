"""Camera pose interpolation for smooth video paths, a copy of
`lara_tpu/eval/pose_interp.py` with the quaternion conversions in torch.

Counterpart of the nerfstudio-derived utilities in tools/camera_utils.py
(the reference only uses `get_interpolated_poses_many`, via
tools/gen_video_path.py:93 for the 'unposed' dataset family): SLERP between
consecutive camera rotations + linear translation/intrinsics interpolation,
optionally greedily ordering poses by proximity first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lara_tpu_torch.utils.quat import quat_to_rotmat, rotmat_to_quat


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation of two unit quaternions (w,x,y,z)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)


def interpolate_poses(pose_a: np.ndarray, pose_b: np.ndarray, steps: int) -> np.ndarray:
    """[3,4]/[4,4] pose pair → `steps` interpolated [3,4] poses (excl. end)."""
    def as_f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    qa = rotmat_to_quat(as_f32(pose_a[:3, :3])).numpy()
    qb = rotmat_to_quat(as_f32(pose_b[:3, :3])).numpy()
    ta, tb = pose_a[:3, 3], pose_b[:3, 3]
    out = []
    for i in range(steps):
        t = i / steps
        q = slerp(qa, qb, t)
        r = quat_to_rotmat(as_f32(q)).numpy()
        pose = np.concatenate([r, ((1 - t) * ta + t * tb)[:, None]], axis=1)
        out.append(pose.astype(np.float32))
    return np.stack(out)


def order_poses_greedy(poses: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbor ordering by camera position (the reference's
    order_poses=True behavior)."""
    n = len(poses)
    remaining = list(range(1, n))
    order = [0]
    while remaining:
        cur = poses[order[-1], :3, 3]
        dists = [np.linalg.norm(poses[j, :3, 3] - cur) for j in remaining]
        order.append(remaining.pop(int(np.argmin(dists))))
    return np.array(order)


def get_interpolated_poses_many(
    poses: np.ndarray,          # [N, 3/4, 4]
    ixts: np.ndarray,           # [N, 3, 3]
    steps_per_transition: int = 10,
    order_poses: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Interpolate along the (optionally reordered) pose sequence.
    Returns (poses [M, 3, 4], ixts [M, 3, 3])."""
    poses = np.asarray(poses, np.float32)
    ixts = np.asarray(ixts, np.float32)
    if order_poses:
        order = order_poses_greedy(poses)
        poses, ixts = poses[order], ixts[order]
    traj, ks = [], []
    for a, b in zip(range(len(poses) - 1), range(1, len(poses))):
        traj.append(interpolate_poses(poses[a], poses[b], steps_per_transition))
        for i in range(steps_per_transition):
            t = i / steps_per_transition
            ks.append((1 - t) * ixts[a] + t * ixts[b])
    return np.concatenate(traj), np.stack(ks)
