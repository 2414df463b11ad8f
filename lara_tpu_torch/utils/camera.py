"""Camera and ray utilities (torch + NumPy), the counterpart of
`lara_tpu/utils/camera.py`.

Conventions: OpenCV pinhole (+z forward, x right, y down), pixel centers at
(u+0.5, v+0.5), c2w/w2c are 4x4 row-major matrices acting on column vectors.
The SH view direction uses the reference quirk `campos = -c2w[:3, 3]`
(lightning/utils.py:48), applied by `make_camera` and
`models/lara.py:make_cameras`.
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


def invert_ixt(ixt: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of pinhole intrinsics [..., 3, 3] (fx, fy, cx, cy);
    exact in f32, unlike a general LU inverse."""
    fx, fy = ixt[..., 0, 0], ixt[..., 1, 1]
    cx, cy = ixt[..., 0, 2], ixt[..., 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, zeros, -cx / fx], -1),
                        torch.stack([zeros, 1.0 / fy, -cy / fy], -1),
                        torch.stack([zeros, zeros, ones], -1)], -2)


def make_camera(c2w, fovx, fovy, near, far, campos_quirk: bool = True,
                device=None) -> Camera:
    """A rasterizer Camera from a NeRF/OpenCV c2w pose [4, 4].

    campos_quirk=True reproduces lightning/utils.py:48 (campos = -c2w[:3,3]);
    False gives the geometrically correct center c2w[:3,3]."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)

    def scalar(x):
        return torch.as_tensor(x, dtype=torch.float32, device=c2w.device)

    return Camera(w2c=invert_rigid(c2w),
                  campos=-c2w[:3, 3] if campos_quirk else c2w[:3, 3],
                  tanfovx=torch.tan(scalar(fovx) * 0.5),
                  tanfovy=torch.tan(scalar(fovy) * 0.5),
                  near=scalar(near), far=scalar(far))


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


def intrinsic_to_fov(K, w=None, h=None):
    """3x3 intrinsics -> (fovx, fovy); dataLoader/utils.py:74-86."""
    fx, fy = K[0, 0], K[1, 1]
    w = K[0, 2] * 2 if w is None else w
    h = K[1, 2] * 2 if h is None else h
    return 2 * np.arctan2(w, 2 * fx), 2 * np.arctan2(h, 2 * fy)


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


def build_rays(c2ws: torch.Tensor, ixts: torch.Tensor, H: int, W: int,
               scale: float = 1.0) -> torch.Tensor:
    """Torch version of build_rays_np (same output, differentiable):
    c2ws [V, 4, 4], ixts [V, 3, 3] → rays [V, H·scale, W·scale, 6]."""
    H2, W2 = int(H * scale), int(W * scale)
    ixts = ixts.float().clone()
    ixts[:, :2] *= scale
    Y, X = torch.meshgrid(torch.arange(H2, dtype=torch.float32, device=c2ws.device),
                          torch.arange(W2, dtype=torch.float32, device=c2ws.device),
                          indexing="ij")
    uv1 = torch.stack((X + 0.5, Y + 0.5, torch.ones_like(X)), dim=-1)
    i2w = invert_ixt(ixts).transpose(-1, -2) @ c2ws[:, :3, :3].transpose(-1, -2)
    dirs = torch.einsum("hwc,vck->vhwk", uv1, i2w)
    rays_o = c2ws[:, None, None, :3, 3].expand(dirs.shape)
    return torch.cat((rays_o, dirs), dim=-1)


def project_points(points: torch.Tensor, w2cs: torch.Tensor, ixts: torch.Tensor):
    """Project world points [..., 3] into views (w2cs [V,4,4], ixts [V,3,3])
    → (xy [V, P, 2] pixel coordinates, z [V, P, 1] camera depth);
    lightning/network.py:182-187 (`projection`)."""
    pts = points.reshape(1, -1, 3)
    cam = pts @ w2cs[:, :3, :3].transpose(-1, -2) + w2cs[:, None, :3, 3]
    img = cam @ ixts.transpose(-1, -2)
    return img[..., :2] / img[..., 2:3], img[..., 2:3]


def canonicalize_cameras_np(tar_c2ws, tar_w2cs):
    """Align all poses so the first camera sits at distance r on -z looking
    at the origin (dataLoader/gobjverse.py:59-66). Returns new (c2ws, w2cs,
    transform_mats [1,4,4])."""
    r = np.linalg.norm(tar_c2ws[0, :3, 3])
    ref_c2w = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_w2c = np.eye(4, dtype=np.float32).reshape(1, 4, 4)
    ref_c2w[:, 2, 3], ref_w2c[:, 2, 3] = -r, r
    transform_mats = ref_c2w @ tar_w2cs[:1]
    new_w2cs = tar_w2cs.copy() @ tar_c2ws[:1] @ ref_w2c
    new_c2ws = transform_mats @ tar_c2ws.copy()
    return (new_c2ws.astype(np.float32), new_w2cs.astype(np.float32),
            transform_mats.astype(np.float32))


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
