"""Per-view sample decoding in NumPy, the counterpart of the NumPy paths of
`lara_tpu/data/native.py` (the JAX package may run the same arithmetic in
its optional C helpers; the port has none on its data path)."""

from __future__ import annotations

import numpy as np

from lara_tpu_torch.utils.camera import build_rays_np


def composite_rgba(rgba: np.ndarray, bg: np.ndarray):
    """rgba u8 [H,W,4], bg f32 [3] → (rgb f32 [H,W,3] composited over bg,
    mask u8 [H,W], 1 where alpha > 0)."""
    img = rgba.astype(np.float32) / 255.0
    rgb = (img[..., :3] * img[..., 3:]
           + bg.astype(np.float32) * (1 - img[..., 3:])).astype(np.float32)
    return rgb, (rgba[..., 3] > 0).astype(np.uint8)


def decode_normal(nrm_u8: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """u8 [H,W,3] → f32 [H,W,3] in [-1,1], rotated by rot^T (row vectors)."""
    n = nrm_u8.astype(np.float32) / 255.0 * 2.0 - 1.0
    return (n @ rot.T).astype(np.float32)


def build_rays_batch(c2ws: np.ndarray, ixts: np.ndarray, H: int, W: int,
                     scale: float = 1.0) -> np.ndarray:
    """[V] views of per-pixel rays [V, H·s, W·s, 6] (origin, unnormalised
    direction; pixel centres at +0.5)."""
    return build_rays_np(c2ws, ixts, H, W, scale)
