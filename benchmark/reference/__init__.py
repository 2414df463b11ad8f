"""The benchmark's plain reference of LaRa: the network, the rasterizer at
the binned budgets, the losses and the first AdamW update, written again in
plain PyTorch from the model's description (lightning/network.py,
renderer_2dgs.py, loss.py of autonomousvision/LaRa) and run in float32 with
TF32 off. It imports nothing of the program under test and takes nothing
the program made: the benchmark hands both sides the same weights and
inputs, and the reference works out every surfel, render, loss and update
again.

This package also holds the check, made in every run, that no module of
the JAX package or of JAX itself is loaded (`forbidden_modules`).
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lara_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first dot
    compared whole, is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def set_float32() -> None:
    """Float32 products everywhere: no TF32 in cuBLAS or cuDNN."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
