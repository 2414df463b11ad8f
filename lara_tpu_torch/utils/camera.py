"""Camera and ray utilities (torch + NumPy), the counterpart of
`lara_tpu/utils/camera.py`.

Conventions: OpenCV pinhole (+z forward, x right, y down), pixel centers at
(u+0.5, v+0.5), c2w/w2c are 4x4 row-major matrices acting on column vectors.
The SH view direction uses the reference quirk `campos = -c2w[:3, 3]`
(lightning/utils.py:48), applied by `models/lara.py:make_cameras`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view's rasterizer camera; every field is a tensor on the render
    device, so nothing is read back to the host per render."""

    w2c: torch.Tensor      # [4, 4] world -> camera
    campos: torch.Tensor   # [3] position used for SH view dirs
    tanfovx: torch.Tensor  # [] tan(fovx / 2)
    tanfovy: torch.Tensor  # [] tan(fovy / 2)
    near: torch.Tensor     # []
    far: torch.Tensor      # []


def invert_rigid(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid 4x4 transforms [..., 4, 4]."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    rt = r.transpose(-1, -2)
    top = torch.cat([rt, -(rt @ t[..., None])], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(*m.shape[:-2], 1, 4)
    return torch.cat([top, bottom], -2)


def fov_to_ixt(fov, reso):
    """fov [2] (radians), reso [2] (W,H) -> 3x3 intrinsics.
    Mirrors dataLoader/gobjverse.py:10-15 (principal point at reso/2)."""
    fov = np.asarray(fov, np.float32)
    reso = np.asarray(reso, np.float32)
    ixt = np.eye(3, dtype=np.float32)
    ixt[0, 2], ixt[1, 2] = reso[0] / 2, reso[1] / 2
    focal = 0.5 * reso / np.tan(0.5 * fov)
    ixt[0, 0], ixt[1, 1] = focal[0], focal[1]
    return ixt


def build_rays_np(c2ws, ixts, H, W, scale: float = 1.0):
    """Per-pixel rays [V,H*scale,W*scale,6] (origin+unnormalized dir);
    matches dataLoader/utils.py:21-34 (pixel centers +0.5, dir_world =
    K^-1 [u,v,1] rotated by c2w). Does NOT mutate `ixts`."""
    H2, W2 = int(H * scale), int(W * scale)
    ixts = np.array(ixts, np.float32).copy()
    ixts[:, :2] *= scale
    rays_o = c2ws[:, :3, 3][:, None, None]  # [V,1,1,3]
    X, Y = np.meshgrid(np.arange(W2), np.arange(H2))
    uv1 = np.concatenate(
        (X[..., None] + 0.5, Y[..., None] + 0.5, np.ones_like(X[..., None])), axis=-1
    ).astype(np.float32)  # [H,W,3]
    i2w = np.linalg.inv(ixts).transpose(0, 2, 1) @ c2ws[:, :3, :3].transpose(0, 2, 1)
    dirs = np.einsum("hwc,vck->vhwk", uv1, i2w)
    rays_o = np.broadcast_to(rays_o, dirs.shape)
    return np.concatenate((rays_o, dirs), axis=-1).astype(np.float32)


def ray_to_plucker(rays: torch.Tensor) -> torch.Tensor:
    """Rays [...,6] (o,d) -> Pluecker coords [...,6] (unit dir, moment o x d).
    Mirrors lightning/network.py:414-423."""
    origin, direction = rays[..., :3], rays[..., 3:6]
    n = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = direction / torch.clamp(n, min=1e-12)
    moment = torch.linalg.cross(origin, direction, dim=-1)
    return torch.cat((direction, moment), dim=-1)


def depth_to_normal(rays: torch.Tensor, depth: torch.Tensor):
    """Finite-difference normals from a ray-parameterized depth map.

    rays [H,W,6], depth [H,W] -> (normal [H,W,3] zero at the borders,
    points [H,W,3]); mirrors lightning/renderer_2dgs.py:74-89."""
    points = rays[..., :3] + depth[..., None] * rays[..., 3:6]
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    normal = torch.zeros_like(points)
    normal[1:-1, 1:-1, :] = n
    return normal, points
