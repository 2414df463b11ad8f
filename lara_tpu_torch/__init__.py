"""LaRa in PyTorch for an NVIDIA H100: the counterpart of `lara_tpu`.

Mirrors the JAX package's layout module by module (`lara_tpu/models/lara.py`
↔ `lara_tpu_torch/models/lara.py`, ...). The network and the rasterizer's
preprocess and binning are plain PyTorch; the per-tile blend is the
hand-written CUDA kernel `csrc/blend_fwd.cu`. This package imports neither
JAX nor `lara_tpu`.
"""

__version__ = "0.1.0"
