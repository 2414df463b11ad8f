"""The blend's work as the benchmark counts it from a call's inputs
(`trace.entry_pixels`: the reference's walk) against the program's plain
blend's own walk (Σ_t min(n_t, ndone_t·C)·P from its stash) on a small
scene, at a budget where tiles saturate and one where they do not."""

import pytest
import torch

from benchmark import trace
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig


def _inputs(cfg, seed, opacity):
    gen = torch.Generator().manual_seed(seed)
    t, k = cfg.num_tiles, cfg.tile_budget
    e = torch.zeros(t, k, 13)
    e[..., 0:2] = (torch.rand(t, k, 2, generator=gen) - 0.5) * 0.8
    e[..., 2] = 2.0 + torch.sort(torch.rand(t, k, generator=gen), dim=1).values
    ax = torch.randn(t, k, 6, generator=gen)
    e[..., 3:9] = ax * 2.0
    e[..., 9:12] = torch.rand(t, k, 3, generator=gen)
    e[..., 12] = opacity
    counts = torch.randint(0, k + 1, (t,), generator=gen, dtype=torch.int32)
    return e, counts, torch.tensor([0.4, 0.4])


@pytest.mark.parametrize("opacity", [0.05, 0.95])
def test_entry_pixels_follow_the_plain_walk(opacity):
    cfg = RasterizeConfig(height=64, width=64, tile=16, tile_budget=64, pallas_chunk=16)
    entries, counts, scalars = _inputs(cfg, 3, opacity)
    _, _, ndone = cuda_blend.blend_tiles_reference(entries, counts, scalars, cfg,
                                                   return_stash=True)
    n = torch.clamp(counts, max=cfg.tile_budget).long()
    plain = int(torch.minimum(n, ndone.long() * cfg.pallas_chunk).sum()) * cfg.tile ** 2
    assert trace.entry_pixels(entries, counts, scalars, cfg) == plain
    assert plain > 0
    # the opaque scene saturates tiles before their entries run out
    assert bool((ndone.long() * cfg.pallas_chunk < n).any()) == (opacity > 0.5)
