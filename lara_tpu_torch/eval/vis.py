"""Visualisation panels for training and evaluation logs, the counterpart
of `lara_tpu/eval/vis.py` (lightning/vis.py, tools/img_utils.py:159-176), in
NumPy alone, written by the port's PNG encoder (`data/image_io.py`): the
GPU machine has no cv2."""

from __future__ import annotations

from typing import Dict

import numpy as np

from lara_tpu_torch.data.image_io import encode_png


def jet(x8: np.ndarray) -> np.ndarray:
    """u8 levels → RGB in [0, 1] of the jet colormap: the piecewise-linear
    ramps through the eighths that OpenCV's COLORMAP_JET samples (its 8-bit
    table differs from this by at most one level)."""
    x = np.asarray(x8, np.float32) / 255.0
    rgb = [np.clip(1.5 - np.abs(4.0 * x - k), 0.0, 1.0) for k in (3.0, 2.0, 1.0)]
    return np.round(np.stack(rgb, -1) * 255.0) / 255.0


def visualize_depth(depth: np.ndarray, minmax=None) -> np.ndarray:
    """Colourise a depth map with the jet colormap on the valid (> 0)
    pixels; invalid pixels take the colour of level 0."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    valid = x > 0
    if minmax is None:
        mi = float(x[valid].min()) if valid.any() else 0.0
        ma = float(x.max()) if x.size else 1.0
    else:
        mi, ma = minmax
    x = np.where(valid, (x - mi) / max(ma - mi, 1e-8), 0.0)
    x8 = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    return jet(x8).astype(np.float32)


def _cat_views(a: np.ndarray) -> np.ndarray:
    """[N, H, W, C] → [H, N·W, C] (views side by side, as
    lightning/network.py:527)."""
    return np.concatenate(list(a), axis=1)


def vis_images(output: Dict, batch: Dict) -> Dict[str, np.ndarray]:
    """The standard panels of every scene in the batch: name → [B, H, W', 3]
    float arrays (lightning/vis.py:7-57). `output` and `batch` hold NumPy
    arrays (or anything np.asarray reads)."""
    gt = np.asarray(batch["tar_rgb"], np.float32)

    def grab(key):
        return np.asarray(output[key], np.float32) if key in output else None

    panels: Dict[str, list] = {}
    for i in range(gt.shape[0]):
        rows = {"gt_rgb": _cat_views(gt[i])}
        for prex in ("", "_fine"):
            img = grab(f"image{prex}")
            if img is None:
                continue
            rows[f"pred_rgb{prex}"] = _cat_views(img[i])
            dep = grab(f"depth{prex}")
            if dep is not None:
                rows[f"depth{prex}"] = visualize_depth(_cat_views(dep[i])[..., 0])
            for nk in (f"rend_normal{prex}", f"depth_normal{prex}"):
                nrm = grab(nk)
                if nrm is not None:
                    rows[nk] = (_cat_views(nrm[i]) + 1.0) / 2.0
        for k, v in rows.items():
            panels.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in panels.items()}


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an [H, W, 3] (or [H, W]) image as an 8-bit PNG with filter 0:
    float images are read as [0, 1] and clipped, u8 images as they are."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.round(np.clip(np.nan_to_num(a.astype(np.float32)), 0.0, 1.0) * 255.0)
        a = a.astype(np.uint8)
    return encode_png(a, 0)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
