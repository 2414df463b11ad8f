"""The port's binning against the JAX package on the CPU.

  (a) `tile_windows` (its plain version on CPU tensors) against the JAX
      tool's Pallas window kernel (tools/profile_binning.py:196-216,
      restated here: it is nested in the tool's main()) in interpret mode:
      equal.
  (b) `bin_view` with bin_mode "count" and with pack_mode "fused" against
      the JAX `bin_view` on the same projected surfels: counts,
      entry_valid, order_v, slot_pos and the windows on valid entries equal.
  (c) count and fused renders against the sort render, all in the port
      (plain blend): outputs equal, gradients to means and opacities within
      rtol 1e-5 / atol 1e-7 (the transposes sum in other orders).
  (d) the slot-position backward of `window_gather` against autograd of
      plain indexing: allclose at 1e-6.
  (e) `lara_workload`'s shapes and statistics.
  (f) the ported binning profiler runs to its end on the CPU.
Plus the preprocess overflow fraction against the JAX value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.rasterizer.tiled import bin_view as jax_bin_view
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import rasterize, tiled
from lara_tpu_torch.ops.rasterizer.cuda_windows import INT32_MAX, tile_windows
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels, RasterizeConfig
from lara_tpu_torch.tools import profile_binning
from lara_tpu_torch.tools.workload import lara_workload
from tests.test_rasterizer import front_camera, make_cfg
from tests.test_torch_blend import one_torch_thread, scene_np, torch_cfg  # noqa: F401
from tests.test_torch_rasterizer import t, torch_camera


def jax_win_pallas(sk, starts, k):
    """`win_pallas` of tools/profile_binning.py: grid over blocks of 8
    tiles, scalar-prefetched starts, the padded keys in ANY memory; run in
    interpret mode."""
    tpb = 8

    def win_kernel(starts_ref, sk_ref, out_ref):
        blk = pl.program_id(0)
        for ts in range(tpb):
            s = starts_ref[blk * tpb + ts]
            out_ref[ts, :] = sk_ref[pl.ds(s, k)]

    padded = jnp.concatenate([sk, jnp.full((k,), INT32_MAX, jnp.int32)])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(starts.shape[0] // tpb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((tpb, k), lambda i, *_: (i, 0)))
    return pl.pallas_call(win_kernel, grid_spec=grid_spec, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((starts.shape[0], k), jnp.int32),
                          )(starts, padded)


@pytest.mark.parametrize("n_tiles", [64, 1024])
@pytest.mark.parametrize("k", [16, 128])
def test_tile_windows_match_pallas(n_tiles, k):
    rng = np.random.default_rng(n_tiles + k)
    m = 3000
    sk = np.sort(rng.integers(0, 2 ** 30, m)).astype(np.int32)
    starts = np.sort(rng.integers(0, m + 1, n_tiles)).astype(np.int32)
    starts[-8:-4] = m - rng.integers(1, k, 4)        # windows partly past the keys
    starts[-4:] = m                                  # windows all sentinel
    want = np.asarray(jax_win_pallas(jnp.asarray(sk), jnp.asarray(starts), k))
    got = tile_windows(t(sk), t(starts), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[-4:] == INT32_MAX).all() and (got[-8:-4] == INT32_MAX).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [13, 128, 512])
def test_tile_windows_kernel_matches_reference_on_cuda(k):
    """The window kernel on the card against its plain version, bit for
    bit: one word per lane at K 13, 16-byte stores at K 128 and 512, with
    windows partly and wholly past the keys and a ragged count of tiles;
    skipped without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(k)
    m = 20000
    sk = np.sort(rng.integers(0, 2 ** 30, m)).astype(np.int32)
    starts = np.sort(rng.integers(0, m + 1, 1021)).astype(np.int32)
    starts[-8:-4] = m - rng.integers(1, k, 4)
    starts[-4:] = m
    keys, st = torch.from_numpy(sk).cuda(), torch.from_numpy(starts).cuda()
    got = tile_windows(keys, st, k)
    assert torch.equal(got.cpu(), tile_windows(t(sk), t(starts), k))


CASES = [(400, {}), (700, {"tile_budget": 8}), (900, {"visible_budget": 640})]


def _projected(n, seed, cfg):
    """The JAX preprocess of a numpy scene: (JAX ProjectedSurfels, port's)."""
    g = jax_preprocess(*(jnp.asarray(a) for a in scene_np(seed, n)), front_camera(), cfg)
    return g, ProjectedSurfels(*(t(a) for a in g))


def _assert_windows_equal(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    ev = np.asarray(want.entry_valid)
    np.testing.assert_array_equal(got.entry_valid.numpy(), ev)
    np.testing.assert_array_equal(got.win_gidx.numpy()[ev], np.asarray(want.win_gidx)[ev])
    np.testing.assert_array_equal(got.order_v.numpy(), np.asarray(want.order_v))
    assert ev.sum() > 50                     # the scene exercises the windows


def packed_bounds(g, order_v, cfg):
    return tiled._pack_tile_bounds(g, cfg)[order_v]


@pytest.mark.parametrize("n,kw", CASES)
def test_bin_view_count_matches_jax(n, kw):
    cfg = make_cfg(bin_mode="count", **kw)
    g_j, g_t = _projected(n, 3 + n, cfg)
    packed_j, want = jax_bin_view(g_j, cfg)
    tcfg = torch_cfg(cfg)
    packed_t, got = bin_view(g_t, tcfg)
    _assert_windows_equal(got, want)
    np.testing.assert_array_equal(got.slot_pos.numpy(), np.asarray(want.slot_pos))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    # chunks of 128 surfels: the prefix sum's carry across chunks, and a
    # short last chunk
    win, valid, counts, slot_pos = tiled._windows_count(
        packed_bounds(g_t, got.order_v, tcfg), tcfg, chunk=128)
    np.testing.assert_array_equal(counts.numpy(), got.counts.numpy())
    np.testing.assert_array_equal(slot_pos.numpy(), got.slot_pos.numpy())
    np.testing.assert_array_equal(win[valid].numpy(), got.win_gidx[valid].numpy())


@pytest.mark.parametrize("n,kw", CASES)
def test_bin_view_fused_matches_jax(n, kw):
    cfg = make_cfg(pack_mode="fused", **kw)
    g_j, g_t = _projected(n, 3 + n, cfg)
    packed_j, want = jax_bin_view(g_j, cfg)
    packed_t, got = bin_view(g_t, torch_cfg(cfg))
    _assert_windows_equal(got, want)
    assert got.slot_pos is None and packed_t.shape == (n, 13)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))


@pytest.mark.parametrize("mode", [{}, {"bin_mode": "count"}, {"pack_mode": "fused"}],
                         ids=["sort_gather", "count", "fused"])
def test_bin_view_depth_ties_match_jax(mode):
    """Depths rounded to 0.05 so that many tie exactly, with the visible
    budget cutting through a tie: the port's stable depth sort
    (`ops/rasterizer/tiled.py:152`) must keep equal depths in index order as
    the JAX `bin_view` does (`lara_tpu/ops/rasterizer/tiled.py:194`, the
    stable `jnp.argsort`; the fused mode's stable `lax.sort`): equal
    `order_v`, windows and packed rows. One JAX compile per mode."""
    cfg = make_cfg(visible_budget=400, **mode)
    g_j, g_t = _projected(700, 11, cfg)
    depth = np.round(np.asarray(g_j.depth) / 0.05) * 0.05
    g_j = g_j._replace(depth=jnp.asarray(depth, jnp.float32))
    g_t = g_t._replace(depth=t(depth))
    packed_j, want = jax.jit(lambda g: jax_bin_view(g, cfg))(g_j)
    packed_t, got = bin_view(g_t, torch_cfg(cfg))
    _assert_windows_equal(got, want)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    key = np.where(np.asarray(g_j.valid), depth.astype(np.float32), np.inf)
    order = np.asarray(want.order_v)
    assert len(np.unique(key[order])) < len(order) / 4       # ties throughout
    assert np.sum(key == key[order[-1]]) > np.sum(key[order] == key[order[-1]])  # and at the cut


@pytest.mark.parametrize("field", ["bin_mode", "pack_mode"])
def test_unknown_binning_mode_raises(field):
    with pytest.raises(ValueError, match=field):
        RasterizeConfig(**{field: "radix"})


def _render_and_grads(cfg, scene, **mode):
    means, shs, op, scales, quats = (t(a) for a in scene)
    means.requires_grad_(True)
    op.requires_grad_(True)
    out = rasterize(means, shs, op, scales, quats, torch_camera(front_camera()),
                    torch.tensor([0.2, 0.4, 0.6]), dataclasses.replace(cfg, **mode))
    loss = (out.image.sum() + out.alpha.sum() + out.distortion.sum()
            + out.depth_expected.sum() + out.normal.sum())
    return out, torch.autograd.grad(loss, (means, op))


@pytest.mark.parametrize("mode", [{"bin_mode": "count"}, {"pack_mode": "fused"}])
def test_modes_render_as_sort(mode):
    cfg = torch_cfg(make_cfg(tile_budget=64, dup=2, visible_budget=256, pallas_chunk=32))
    scene = scene_np(11, 400)
    out_s, grads_s = _render_and_grads(cfg, scene)
    out_m, grads_m = _render_and_grads(cfg, scene, **mode)
    assert out_s.alpha.max() > 0.5
    for name, a, b in zip(out_s._fields, out_s, out_m):
        np.testing.assert_array_equal(b.detach().numpy(), a.detach().numpy(), err_msg=name)
    for a, b in zip(grads_s, grads_m):
        assert a.abs().max() > 0
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)


def test_slot_pos_backward_matches_indexing():
    cfg = make_cfg(bin_mode="count", tile_budget=8)
    _, g_t = _projected(700, 5, cfg)
    _, binned = bin_view(g_t, torch_cfg(cfg))
    rng = np.random.default_rng(0)
    packed = t(rng.normal(size=(binned.order_v.shape[0], 13)).astype(np.float32))
    cot = t(rng.normal(size=(*binned.win_gidx.shape, 13)).astype(np.float32))
    grads = []
    for slot_pos in (binned.slot_pos, None):
        p = packed.clone().requires_grad_(True)
        rows = window_gather(p, binned.win_gidx, binned.entry_valid, slot_pos)
        grads.append(torch.autograd.grad(rows, p, cot)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-6, rtol=1e-6)
    assert (grads[1] != 0).any(-1).sum() > 50


def test_radius_overflow_matches_jax():
    """The preprocess overflow fraction, on a scene of surfels small
    enough for the tile ring and on one of huge splats."""
    cfg = make_cfg(tile_budget=2048)
    cam = front_camera()
    scene = list(scene_np(3, 300))
    for scales, lo, hi in ((scene[3], 0.0, 0.01), (np.full((300, 2), 0.25, np.float32), 0.5, 1.0)):
        scene[3] = scales
        _, want = jax_preprocess(*(jnp.asarray(a) for a in scene), cam, cfg,
                                 return_overflow=True)
        _, got = preprocess_surfels(*(t(a) for a in scene), torch_camera(cam),
                                    torch_cfg(cfg), return_overflow=True)
        assert abs(float(got) - float(want)) <= 1e-6
        assert lo <= float(got) <= hi


def test_lara_workload_statistics():
    n = 40000
    means, shs, op_raw, sc_raw, quats = lara_workload(n, seed=3, device="cpu")
    assert [tuple(a.shape) for a in (means, shs, op_raw, sc_raw, quats)] == [
        (n, 3), (n, 4, 3), (n,), (n, 2), (n, 4)]
    shell = op_raw == 3.0
    assert abs(shell.float().mean().item() - 0.15) <= 0.01
    dust = op_raw[~shell]
    assert dust.min() >= -9.0 and dust.max() <= -5.0
    radius = torch.linalg.vector_norm(means[shell], dim=-1)
    assert abs(radius.mean().item() - 0.28) < 0.005
    assert means[~shell].abs().max() <= 0.5
    assert abs(sc_raw.mean().item() - np.log(0.5 * (2.0 / 64) / 3.0)) < 0.01
    assert torch.equal(lara_workload(n, seed=3, device="cpu")[0], means)


def test_profile_binning_runs_on_cpu(capsys):
    res = profile_binning.run(views=2, trials=1, device="cpu", n=4096)
    out = capsys.readouterr().out
    stages = ["argsort", "pack_gather", "keybuild", "keysort", "searchsorted",
              "win_dynslice", "win_flatgather", "row_gather"]
    want = ([f"{s}_1" for s in stages] + ["win_plain_1", "fused_binning_1"]
            + [f"{s}_b2" for s in stages if s != "win_plain"] + ["fused_binning_b2"]
            + ["windows_sort_1", "windows_count_1", "windows_sort_loop2",
               "windows_count_loop2", "bin_view_sort_1", "bin_view_count_1",
               "bin_view_fused_1"])
    assert sorted(res) == sorted(want)
    for name in want:
        assert f"\n{name} " in out


def test_serving_request_in_every_mode():
    """A serving request (`make_forward`, tiny config, CPU) through
    bin_mode "count" and pack_mode "fused" gives the sort binning's maps."""
    from lara_tpu_torch.config import config_from_dict
    from lara_tpu_torch.models import LaRaNet
    from lara_tpu_torch.train.step import make_forward
    from tests.test_model import synthetic_batch, tiny_config

    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0)).eval()
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(B=1).items()}
    outs = {}
    for mode, kw in (("sort", {}), ("count", {"bin_mode": "count"}),
                     ("fused", {"pack_mode": "fused"})):
        net.cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))
        outs[mode] = make_forward(net, with_fine=True)(batch)
    assert outs["sort"]["acc_map_fine"].max() > 0.01
    for mode in ("count", "fused"):
        for key in ("image", "acc_map", "depth", "image_fine", "acc_map_fine", "depth_fine"):
            np.testing.assert_array_equal(outs[mode][key].numpy(), outs["sort"][key].numpy(),
                                          err_msg=f"{mode} {key}")
