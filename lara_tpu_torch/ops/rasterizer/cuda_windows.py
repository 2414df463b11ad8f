"""Tile-window extraction: the hand-written CUDA kernel and its plain
PyTorch version, the counterpart of the Pallas `win_pallas` /
`win_kernel` of `tools/profile_binning.py`.

`tile_windows(sorted_keys, starts, k)` returns the [T, K] int32 windows
out[t, j] = padded[starts[t] + j], where `padded` is the sorted slot keys
[M] followed by K sentinels INT32_MAX (0 <= starts[t] <= M):
  - CPU tensors run `tile_windows_reference`;
  - CUDA tensors launch `csrc/tile_windows.cu`, which builds no padded
    copy, or raise: nothing falls back.

The wrapper counts its launches in `LAUNCHES`; the library is built by
`lara_tpu_torch/ops/_build.py`.
"""

from __future__ import annotations

import torch

from lara_tpu_torch.ops import _build

INT32_MAX = 2 ** 31 - 1
LAUNCHES = {"tile_windows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_inputs(sorted_keys, starts, k: int) -> None:
    for name, x in (("sorted_keys", sorted_keys), ("starts", starts)):
        if x.dim() != 1 or x.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32, got {x.dtype} {tuple(x.shape)}")
    if starts.device != sorted_keys.device:
        raise ValueError(f"starts is on {starts.device}, sorted_keys on {sorted_keys.device}")
    if k <= 0:
        raise ValueError(f"the window length must be positive, got {k}")


def tile_windows(sorted_keys: torch.Tensor, starts: torch.Tensor, k: int) -> torch.Tensor:
    """[T, k] int32 windows of the sorted keys [M] at the tile starts [T]
    (each in 0..M); positions at or past M hold INT32_MAX."""
    _check_inputs(sorted_keys, starts, k)
    dev = sorted_keys.device
    if dev.type == "cpu":
        return tile_windows_reference(sorted_keys, starts, k)
    if dev.type != "cuda":
        raise ValueError(f"tile_windows runs on cuda or cpu tensors, not {dev}")
    keys, starts = sorted_keys.contiguous(), starts.contiguous()
    out = torch.empty((starts.shape[0], k), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.build_library()["tile_windows"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lara_tile_windows(keys.data_ptr(), keys.shape[0], starts.data_ptr(),
                                    starts.shape[0], k, out.data_ptr(), stream)
    _build.raise_on(err, "tile_windows")
    LAUNCHES["tile_windows"] += 1
    return out


def tile_windows_reference(sorted_keys: torch.Tensor, starts: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Plain version: pad the keys [..., M] with k sentinels and gather the
    flat [..., T, k] positions, as the JAX tool's `win_flatgather` does."""
    padded = torch.cat([sorted_keys, sorted_keys.new_full(
        (*sorted_keys.shape[:-1], k), INT32_MAX)], dim=-1)
    flat = starts[..., None] + torch.arange(k, dtype=torch.int32, device=starts.device)
    return torch.gather(padded, -1, flat.flatten(-2).long()).reshape(flat.shape)
