"""The blend at tiles without an instantiation (run as sub-tiles on the
card), against the JAX package.

The plain versions (`blend_tiles_reference` and its autograd, which take
any tile) are held against `lara_tpu.ops.rasterizer.pallas_blend` in Pallas
interpret mode at tile 64 (128², 2×2 tiles), tile 24 (48²) and tile 12 (48²,
an edge that none of 8, 16 and 32 divides), budget 64 and chunk 32, the
forward and the backward from the stash and replaying, each from one JAX
VJP (its primal is the forward): accumulators at the bars of
tests/test_torch_blend.py; gradients at its atol 5e-4 and rtol 1e-3 plus
2e-6 times the largest |gradient| of the element's column. The last term
is f32 summation order: a tile-64 gradient sums 4,096 pixels, and on these
windows one of 3,328 tile-64 elements, in the position-x column (largest
|gradient| 988.6), differs by 1.30e-3, 1.3e-6 of that column's scale,
from either backward.

Then the sub-tile layout the kernels use (`cuda_blend.subtile`,
`blend_common.cuh:tile_pixel`, restated), their shared memory and
backward form at the sub-tile's edge against the sources' formula, and
the serving slice at `tiny_config` with `render.tile` 64 and
`render_scale` 2 (a 128² render, 2×2 tiles) against the JAX forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu_torch.config import config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.train.step import make_forward
from tests.test_model import synthetic_batch, tiny_config
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from tests.test_rasterizer import front_camera
from tests.test_torch_blend import (assert_accumulators_close, cotangent, jax_cfg,  # noqa: F401
                                    one_torch_thread, pallas_interpret, scene_np, torch_cfg)
from tests.test_torch_build import source_smem
from tests.test_torch_rasterizer import torch_camera

# (tile, image edge): 2×2 tiles of 64, 2×2 of 24, 4×4 of 12
CASES = [(64, 128), (24, 48), (12, 48)]
COLUMN_SCALE = 2e-6
FLIP_PIXELS = 1e-4


@pytest.fixture(scope="module")
def windows():
    """{tile: (cfg kwargs, windows)} of the random scene at budget 64,
    chunk 32, made once per tile with the port's preprocess and binning
    (equal to the JAX package's, tests/test_torch_binning.py; both blends
    read the same windows)."""
    cache = {}

    def get(tile, size):
        if tile not in cache:
            kw = dict(tile=tile, height=size, width=size, tile_budget=64, pallas_chunk=32, dup=3)
            cfg, cam = torch_cfg(jax_cfg(**kw)), torch_camera(front_camera())
            with torch.no_grad():
                g = preprocess_surfels(*(torch.from_numpy(a) for a in scene_np(5, 800)), cam, cfg)
                packed, binned = bin_view(g, cfg)
                entries = window_gather(packed, binned.win_gidx, binned.entry_valid)
            scalars = torch.stack([cam.tanfovx, cam.tanfovy]).float()
            cache[tile] = kw, tuple(np.ascontiguousarray(x.numpy())
                                    for x in (entries, binned.counts, scalars))
        return cache[tile]

    return get


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "replay"])
@pytest.mark.parametrize("tile,size", CASES)
def test_reference_matches_pallas_subtiled_tiles(pallas_interpret, windows, tile, size,  # noqa: F811
                                                 stash):
    """The forward and the backward from the stash (`_run_bwd_stash`) or
    replaying (`_run_bwd`) at tiles the card runs as sub-tiles: the
    accumulators at the bars of tests/test_torch_blend.py, the gradients at
    the bar of the module's docstring."""
    kw, (entries, counts, scalars) = windows(tile, size)
    cfg = jax_cfg(**kw, pallas_stash_carries=stash)
    assert entries.shape[0] == (size // tile) ** 2 and counts.max() == 64
    cot = cotangent(cfg.num_tiles, tile, tile * tile)
    out_want, vjp = jax.vjp(lambda e: pallas_interpret.blend_tiles_pallas(
        e, jnp.asarray(counts), jnp.asarray(scalars), cfg), jnp.asarray(entries))
    (want,) = vjp(jnp.asarray(cot))
    want = np.asarray(want)
    e = torch.from_numpy(entries).requires_grad_(True)
    out = cuda_blend.blend_tiles(e, torch.from_numpy(counts), torch.from_numpy(scalars),
                                 torch_cfg(cfg))
    (got,) = torch.autograd.grad(out, e, torch.from_numpy(cot))
    got = got.numpy()

    assert out.shape[2] == tile * tile and float(np.asarray(out_want)[:, 3].max()) > 0.5
    assert_accumulators_close(out.detach().numpy(), np.asarray(out_want))
    assert np.abs(want).max() > 1.0
    column = np.abs(want).max(axis=(0, 1), keepdims=True)
    bar = 5e-4 + 1e-3 * np.abs(want) + COLUMN_SCALE * column
    over = np.abs(got - want) > bar
    assert not over.any(), (f"{int(over.sum())} of {over.size} elements past the bar, "
                            f"max |Δ| {np.abs(got - want).max():.3e}")


def sub_pixels(tile):
    """`blend_common.cuh:tile_pixel`, restated: {(sub-tile, local pixel):
    tile pixel y · tile + x}, sub-tile `part` row-major, `parts_x` a side,
    local pixels past the tile's edge left out."""
    s, px = cuda_blend.subtile(tile), cuda_blend.parts_x(tile)
    out = {}
    for part in range(px * px):
        for local in range(s * s):
            x = (part % px) * s + local % s
            y = (part // px) * s + local // s
            if x < tile and y < tile:
                out[part, local] = y * tile + x
    return out


@pytest.mark.parametrize("tile", [1, 4, 7, 12, 20, 24, 28, 40, 48, 56, 64, 96])
def test_subtile_layout_covers_each_pixel_once(tile):
    """Every pixel of a tile belongs to exactly one (sub-tile, local pixel),
    the rest of the launched pixels lying past the tile's edge; the edge is
    the one of 8, 16 and 32 with the fewest launched pixels, ties to the
    larger; the instantiated tiles are one block of their own."""
    edge, px = cuda_blend.subtile(tile), cuda_blend.parts_x(tile)
    launched = {s: (-(-tile // s) * s) ** 2 for s in cuda_blend.TILES}
    assert launched[edge] == min(launched.values())
    assert edge == max(s for s, n in launched.items() if n == launched[edge])
    assert px == -(-tile // edge) and (px - 1) * edge < tile <= px * edge
    layout = sub_pixels(tile)
    assert sorted(layout.values()) == list(range(tile * tile))
    assert len(layout) == tile * tile <= px * px * edge * edge
    if tile in cuda_blend.TILES:
        assert (edge, px) == (tile, 1)


@pytest.mark.parametrize("tile", [4, 12, 20, 24, 48, 64])
def test_subtile_smem_and_form_follow_the_edge(tile):
    """Shared memory, the backward's form, the threads, the reduction group
    and the global form's scratch at a sub-tiled tile are those of its
    sub-tile's edge, as the sources compute them (`source_smem`); the
    scratch holds one region per sub-tile."""
    edge, parts = cuda_blend.subtile(tile), cuda_blend.parts_x(tile) ** 2
    assert cuda_blend.threads(tile) == edge * edge // 2
    assert cuda_blend.reduce_group(tile) == cuda_blend.reduce_group(edge)
    assert cuda_blend.fwd_min_smem(tile) == cuda_blend.fwd_min_smem(edge)
    for chunk, budget in ((32, 64), (64, 2048), (64, 8192), (512, 512), (1024, 4096)):
        smem = cuda_blend.kernel_smem(chunk, budget, tile)
        assert smem == cuda_blend.kernel_smem(chunk, budget, edge)
        for kind, replay in (("blend_bwd", False), ("blend_bwd_replay", True)):
            global_form = source_smem(edge, chunk, budget, replay, False) > cuda_blend.MAX_SMEM
            assert cuda_blend.bwd_global(tile, chunk, budget, replay) == global_form
            assert smem[kind] == source_smem(edge, chunk, budget, replay, global_form)
            size = tile * 2
            cfg = RasterizeConfig(height=size, width=size, tile=tile, tile_budget=budget,
                                  pallas_chunk=chunk)
            kept = budget // chunk if replay else 1
            assert cuda_blend.scratch_words(cfg, replay) == (
                cfg.num_tiles * parts * 2 * kept * -(-chunk // 32) * edge * edge)
    # tile 64 at the flagship's 0.5 entries a pixel: the stash backward in the
    # shared form, the replay's kept bits (512 KiB a 32×32 sub-tile) global
    assert not cuda_blend.bwd_global(64, 64, 2048, False)
    assert cuda_blend.bwd_global(64, 64, 2048, True)
    assert cuda_blend.launch_key("blend_fwd", 64) in cuda_blend.LAUNCHES


def test_subtiled_serving_slice_matches_jax():
    """`make_forward(render_scale=2)` at `tiny_config` with `render.tile`
    64: 64² inputs rendered at 128² (2×2 tiles of 64, eval budget 64), the
    coarse and the fine stage, against `LaRaNet.apply(render_scale=2)` under
    `jax.jit` with the JAX package's default CPU blend (its XLA formulation,
    as tests/test_torch_model.py:test_render_scale_matches_jax; the Pallas
    blend at tile 64 is held above), at the bars of the serving slice
    (tests/test_torch_model.py): the fine selection as sets, image and
    acc_map within 1e-3, depth within 5e-3. One exception, stated: on at
    most FLIP_PIXELS of the coarse render's pixels, image and acc_map may
    differ by one entry taken at the alpha >= alpha_min (1/255) cull, at
    most 1e-3 + 1/255. The networks agree to ~1e-6 in f32, not bit for bit,
    and on this batch one entry-pixel's alpha sits 2.6e-7 below 1/255 on
    the port's side (view 1, pixel (95, 93): acc_map 0.14297 against JAX's
    0.14633, the entry's alpha times T)."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, tile=64))
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    batch = synthetic_batch(B=1)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(0))
    tnet = LaRaNet(config_from_dict(dataclasses.asdict(cfg)), dtype=torch.float32,
                   device="cpu")
    tnet.load_state_dict(params_from_jax(params["params"]), strict=True)
    want = jax.jit(lambda p, b: jnet.apply(p, b, with_fine=True, train=False, return_buffer=True,
                                           render_scale=2.0))(params,
                                                              jax.tree.map(jnp.asarray, batch))
    before = dict(cuda_blend.LAUNCHES)
    got = make_forward(tnet, with_fine=True, return_buffer=True, render_scale=2.0)(
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert cuda_blend.LAUNCHES == before                  # CPU: plain version

    sel_want = np.asarray(want["render_pkg"]["fine"][2][..., 0]) > -1e3
    sel_got = got["render_pkg"]["fine"][2][..., 0].numpy() > -1e3
    assert 0 < sel_want.sum() <= cfg.model.fine_budget
    np.testing.assert_array_equal(sel_got, sel_want)
    flipped = np.zeros((1, 4, 128, 128), bool)
    for key in ("image", "acc_map"):
        d = np.abs(got[key].numpy() - np.asarray(want[key], np.float32))
        d = d.max(-1) if d.ndim == 5 else d
        assert d.max() <= 1e-3 + RasterizeConfig.alpha_min, key
        flipped |= d > 1e-3
    assert flipped.mean() <= FLIP_PIXELS, f"{int(flipped.sum())} pixels flipped"
    for key, atol in (("image", 1e-3), ("acc_map", 1e-3), ("image_fine", 1e-3),
                      ("acc_map_fine", 1e-3), ("depth", 5e-3), ("depth_fine", 5e-3)):
        g, w = got[key].numpy(), np.asarray(want[key], np.float32)
        assert tuple(g.shape[:4]) == (1, 4, 128, 128) == tuple(w.shape[:4]), key
        keep = ~flipped if key in ("image", "acc_map") else np.ones_like(flipped)
        np.testing.assert_allclose(g[keep], w[keep], atol=atol, err_msg=key)
    assert float(want["acc_map"].max()) > 0.01
