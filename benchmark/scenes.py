"""Seeded scenes in the reference schema (gobjaverse's batch keys), made on
the device: each scene is 2·n_views posed views on an orbit of radius
`radius` around the object at the origin, the first n_views the inputs and
the rest the novel views, with smooth random colours around a colour of its
own, and the rays the network and the normal loss read. Every seed makes
the same sizes; only the colours and the orbits' turns differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def orbit_c2ws(n: int, turn: float, radius: float) -> np.ndarray:
    """n OpenCV cameras on a circle at height 0.2·radius looking at the
    origin, the first at angle 0.3 + turn."""
    c2ws = []
    for i in range(n):
        ang = i * (2 * np.pi / n) + 0.3 + turn
        eye = np.array([radius * np.sin(ang), 0.2 * radius, -radius * np.cos(ang)], np.float64)
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        c2ws.append(c2w)
    return np.stack(c2ws).astype(np.float32)


def intrinsics(fov: float, size: int) -> torch.Tensor:
    f = 0.5 * size / math.tan(0.5 * fov)
    return torch.tensor([[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]])


def rays(c2ws: torch.Tensor, ixt: torch.Tensor, size: int, scale: float) -> torch.Tensor:
    """[..., V, size·scale, size·scale, 6]: origin and unnormalised
    direction K⁻¹(u + ½, v + ½, 1) turned into the world, per pixel."""
    s = int(size * scale)
    fx, cx = ixt[0, 0] * scale, ixt[0, 2] * scale
    ax = torch.arange(s, dtype=torch.float32, device=c2ws.device) + 0.5
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    cam = torch.stack([(xx - cx) / fx, (yy - cx) / fx, torch.ones_like(xx)], -1)
    dirs = torch.einsum("hwc,...kc->...hwk", cam, c2ws[..., :3, :3])
    orig = c2ws[..., None, None, :3, 3].expand(dirs.shape)
    return torch.cat([orig, dirs], -1)


def make_pool(n_scenes: int, n_views: int, size: int, fov: float, radius: float,
              seed: int, device) -> dict:
    """`n_scenes` scenes of 2·n_views views at size², stacked [S, ...]."""
    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 17) % (1 << 63))
    n = 2 * n_views
    turns = torch.rand(n_scenes, generator=gen, device=device) * (2 * math.pi)
    c2ws = torch.from_numpy(np.stack([orbit_c2ws(n, float(t), radius)
                                      for t in turns.tolist()])).to(device)
    ixt = intrinsics(fov, size).to(device)
    base = torch.rand(n_scenes, 1, 1, 1, 3, generator=gen, device=device) * 0.8 + 0.1
    noise = torch.rand(n_scenes * n, 3, 16, 16, generator=gen, device=device)
    noise = F.interpolate(noise, size=(size, size), mode="bilinear", align_corners=False)
    noise = noise.permute(0, 2, 3, 1).reshape(n_scenes, n, size, size, 3)
    rgb = torch.clamp(base + 0.6 * (noise - 0.5), 0.0, 1.0)
    fovs = torch.full((n_scenes,), fov, device=device)
    return {
        "tar_rgb": rgb,
        "tar_c2w": c2ws,
        "tar_w2c": torch.linalg.inv(c2ws),
        "tar_ixt": ixt.expand(n_scenes, n, 3, 3).contiguous(),
        "tar_rays": rays(c2ws, ixt, size, 1.0),
        "tar_rays_down": rays(c2ws, ixt, size, 1.0 / 16),
        "near_far": torch.tensor([radius - 0.8, radius + 0.8], device=device).expand(n_scenes, 2),
        "fovx": fovs,
        "fovy": fovs.clone(),
        "bg_color": torch.ones(n_scenes, n, 3, device=device),
    }


def take(pool: dict, start: int, count: int) -> dict:
    """Scenes start .. start+count-1 of the pool (views, no copy)."""
    return {k: v[start:start + count] for k, v in pool.items()}
