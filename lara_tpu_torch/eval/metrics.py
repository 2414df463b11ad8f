"""Evaluation metrics, the counterpart of `lara_tpu/eval/metrics.py`
(evaluation.py:75-111): PSNR on the novel-view crop, single-scale SSIM
(pytorch_msssim.ssim), and the depth absolute error and acc@τ within the
object mask (tools/depth.py)."""

from __future__ import annotations

import numpy as np
import torch

from lara_tpu_torch.ops.msssim import ssim as ssim_torch


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR in float64 of images in [0, 1]; +inf on identical images."""
    mse = float(np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(-10.0 * np.log(mse) / np.log(10.0))


def ssim(pred, gt, device=None) -> float:
    """Single-scale SSIM of pred / gt [H, W, 3] in [0, 1], computed on
    `device` (that of `pred` when it is a tensor, else the CPU)."""
    if device is None:
        device = pred.device if isinstance(pred, torch.Tensor) else "cpu"

    def nchw(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)[None].permute(0, 3, 1, 2)

    return float(ssim_torch(nchw(pred), nchw(gt)))


def abs_error(depth_pred, depth_gt, mask) -> np.ndarray:
    """|pred - gt| on the pixels of `mask` (tools/depth.py:3-7)."""
    mask = np.asarray(mask, bool)
    return np.abs(np.asarray(depth_pred)[mask] - np.asarray(depth_gt)[mask])


def acc_threshold(depth_pred, depth_gt, mask, threshold: float) -> np.ndarray:
    """1 where an in-mask pixel's |err| < threshold, else 0
    (tools/depth.py:9-14)."""
    return (abs_error(depth_pred, depth_gt, mask) < threshold).astype(np.float32)
