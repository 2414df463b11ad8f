"""SSIM / MS-SSIM in PyTorch, the counterpart of `lara_tpu/ops/msssim.py`
(pytorch_msssim's defaults as the reference uses them, lightning/loss.py:15):
11×11 Gaussian window with σ 1.5, separable with *valid* padding, K1 0.01,
K2 0.03, up to 5 scales weighted [0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
2× average pooling between scales, ReLU on the intermediate cs values,
and max(v, 1e-6)**w.

Precision: float32 throughout (the reference computes it in an autocast-off
island, lightning/loss.py:44). The blur is a depthwise convolution (one
1-D pass per axis); on a CUDA device cuDNN may run a float32 convolution in
TF32 unless `torch.backends.cudnn.allow_tf32` is False, so a caller that
wants float32 sets that flag (`chip_smoke.py` does). The JAX package's
banded matmuls are a TPU workaround (its `_blur`) and are not ported.

Under data parallelism `ms_ssim` is the global batch's: each scale's means
of `cs` and `ssim_map` are `parallel/mesh.py:global_mean`s, so every rank
holds the MS-SSIM of the whole batch (a product of powers of means, which
per-rank values averaged would not give). Without a process group they are
`torch.mean`. `ssim` (evaluation's per-scene metric) stays local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lara_tpu_torch.parallel.mesh import global_mean

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-padding Gaussian filter over the trailing two axes of
    x [N, C, H, W]: a depthwise [k, 1] then [1, k] convolution."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_components(x, y, win, data_range=1.0, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _blur(x * x, win) - mu_xx
    sigma_y = _blur(y * y, win) - mu_yy
    sigma_xy = _blur(x * y, win) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map, cs


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5) -> torch.Tensor:
    """Mean single-scale SSIM. x, y: [N, C, H, W] in [0, data_range]."""
    x, y = x.float(), y.float()
    win = _gaussian_kernel(win_size, win_sigma, x.device)
    return torch.mean(_ssim_components(x, y, win, data_range)[0])


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5,
            weights=_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Mean multi-scale SSIM over the global batch. x, y: [N, C, H, W]
    (this rank's slice); H, W must stay > win_size across all scales
    (≥ 176 px for the default 5 scales)."""
    x, y = x.float(), y.float()
    win = _gaussian_kernel(win_size, win_sigma, x.device)
    vals = []
    for i in range(len(weights)):
        ssim_map, cs = _ssim_components(x, y, win, data_range)
        if i < len(weights) - 1:
            vals.append(torch.relu(global_mean(cs)))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
        else:
            vals.append(torch.relu(global_mean(ssim_map)))
    vals = torch.stack(vals)
    w = torch.tensor(weights, dtype=torch.float32, device=vals.device)
    # d(v^w)/dv → inf at v=0; clamp (only bites on pathological inputs)
    return torch.prod(torch.clamp(vals, min=1e-6) ** w)
