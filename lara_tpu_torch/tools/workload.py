"""A surfel scene with the statistics of a trained LaRa scene, the port's
copy of `bench.py:lara_workload`.

Trained scenes have polarized opacities (surface surfels near-opaque, the
rest transparent) with the opaque ones on an object surface, and scales
around exp(scaling_shift) ≈ voxel/6. The values come from a
`torch.Generator` seeded with `seed`: torch's random stream, so the same
seed gives other numbers than the JAX function, with the same statistics.
"""

from __future__ import annotations

import math

import torch

SHELL_RADIUS, SHELL_JITTER = 0.28, 0.01
OCCUPIED_SHARE = 0.15
SHELL_OPACITY_RAW = 3.0
DUST_OPACITY_RAW = (-9.0, -5.0)


def lara_workload(n: int = 64 ** 3 * 2, seed: int = 0, device="cuda"):
    """(means [n, 3], shs [n, 4, 3], opacity_raw [n], scale_raw [n, 2],
    quats [n, 4]) f32 on `device`, before the renderer's activations:
    15 % of the surfels on a shell of radius 0.28 (0.01 jitter) with raw
    opacity 3.0, the rest uniform dust in ±0.5 with raw opacity uniform in
    [-9, -5]; raw log-scales log(0.5·(2/64)/3) + 0.3·N(0, 1), SH
    coefficients (degree 1) 0.3·N(0, 1) and quaternions N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    r3 = normal(n, 3)
    shell = SHELL_RADIUS * r3 / torch.linalg.vector_norm(r3, dim=-1, keepdim=True)
    shell = shell + SHELL_JITTER * normal(n, 3)
    dust = uniform(-0.5, 0.5, n, 3)
    occupied = torch.rand((n,), generator=gen) < OCCUPIED_SHARE
    means = torch.where(occupied[:, None], shell, dust)
    shs = 0.3 * normal(n, 4, 3)
    op_raw = torch.where(occupied, SHELL_OPACITY_RAW, uniform(*DUST_OPACITY_RAW, n))
    sc_raw = math.log(0.5 * (2.0 / 64) / 3.0) + 0.3 * normal(n, 2)
    quats = normal(n, 4)
    return tuple(a.to(device) for a in (means, shs, op_raw, sc_raw, quats))
