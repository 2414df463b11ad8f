"""LPIPS perceptual metric in PyTorch, the counterpart of
`lara_tpu/eval/lpips.py` (the `lpips` package of evaluation.py:48-49).

A frozen VGG16 (or AlexNet) feature stack → per-layer channel
unit-normalisation → squared difference → learned 1×1 `lin` weights →
spatial mean → sum over layers. The weights are read from the `.npz` that
`tools/convert_lpips.py` writes: `{net}_w{i}` (HWIO, made OIHW here),
`{net}_b{i}` and `lin{i}`. `load_lpips()` searches the JAX package's
default paths and raises `FileNotFoundError` when none exists.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# the five VGG16 feature stages; LPIPS taps the ReLU before each pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision AlexNet features: (out_ch, kernel, stride, pad); LPIPS taps
# the ReLU after each conv
_ALEX_CFG = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M",
             (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_DEFAULT_PATHS = {
    "vgg": ("weights/lpips_vgg.npz",
            os.path.expanduser("~/.cache/lara_tpu/lpips_vgg.npz")),
    "alex": ("weights/lpips_alex.npz",
             os.path.expanduser("~/.cache/lara_tpu/lpips_alex.npz")),
}


def _vgg_features(params: List, x: torch.Tensor) -> List[torch.Tensor]:
    """x [N, 3, H, W] normalised → relu1_2, relu2_2, relu3_3, relu4_3,
    relu5_3."""
    feats, pi = [], 0
    for v in _VGG_CFG:
        if v == "M":
            feats.append(x)
            x = F.max_pool2d(x, 2, 2)
        else:
            w, b = params[pi]
            pi += 1
            x = F.relu(F.conv2d(x, w, b, padding=1))
    return feats


def _alex_features(params: List, x: torch.Tensor) -> List[torch.Tensor]:
    """The ReLU after each of AlexNet's five convolutions."""
    feats, pi = [], 0
    for v in _ALEX_CFG:
        if v == "M":
            x = F.max_pool2d(x, 3, 2)
        else:
            _, _, s, pad = v
            w, b = params[pi]
            pi += 1
            x = F.relu(F.conv2d(x, w, b, stride=s, padding=pad))
            feats.append(x)
    return feats


def lpips_distance(conv_params, lin_weights, x: torch.Tensor, y: torch.Tensor,
                   net: str = "vgg") -> torch.Tensor:
    """x, y [H, W, 3] in [0, 1] → scalar LPIPS distance."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)[None, :, None, None]

    def prep(img):
        img = img.permute(2, 0, 1)[None] * 2.0 - 1.0     # lpips expects [-1, 1]
        return (img - shift) / scale

    extract = _vgg_features if net == "vgg" else _alex_features
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for f1, f2, w in zip(extract(conv_params, prep(x)), extract(conv_params, prep(y)),
                         lin_weights):
        n1 = f1 * torch.rsqrt(torch.sum(f1 * f1, 1, keepdim=True) + 1e-10)
        n2 = f2 * torch.rsqrt(torch.sum(f2 * f2, 1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((n1 - n2) ** 2 * w[None, :, None, None], 1))
    return total


def load_lpips(path: Optional[str] = None, net: str = "vgg", device="cpu") -> Callable:
    """fn(pred [H, W, 3], gt [H, W, 3]) → float for net in {vgg, alex}, with
    its weights on `device`."""
    candidates = [path] if path else list(_DEFAULT_PATHS[net])
    found = next((p for p in candidates if p and os.path.exists(p)), None)
    if found is None:
        raise FileNotFoundError(
            f"LPIPS-{net} weights not found (searched {candidates}); convert them "
            "offline with tools/convert_lpips.py")
    data = np.load(found)
    cfg = _VGG_CFG if net == "vgg" else _ALEX_CFG
    n_conv = sum(1 for v in cfg if v != "M")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    conv_params = [(t(data[f"{net}_w{i}"].transpose(3, 2, 0, 1)), t(data[f"{net}_b{i}"]))
                   for i in range(n_conv)]
    lin_weights = [t(data[f"lin{i}"]) for i in range(5)]

    @torch.inference_mode()
    def fn(x, y) -> float:
        return float(lpips_distance(conv_params, lin_weights,
                                    torch.as_tensor(x, dtype=torch.float32, device=device),
                                    torch.as_tensor(y, dtype=torch.float32, device=device),
                                    net))

    return fn
