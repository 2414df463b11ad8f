"""The port's rasterizer chain against the JAX package on the same inputs:
geometry helpers and preprocess at f32 atol 1e-5 (plus rtol 1e-5 for
preprocess, whose inverse-scale axes are O(100)), bin_view bit-identical,
and whole renders against `rasterize_pallas` (Pallas interpret mode) at the
blend tolerances of tests/test_torch_blend.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.ops.rasterizer.api import rasterize_and_bin as jax_rasterize_and_bin
from lara_tpu.ops.rasterizer.api import rasterize_rebind as jax_rasterize_rebind
from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.rasterizer.tiled import bin_view as jax_bin_view
from lara_tpu.utils import camera as jcam
from lara_tpu.utils.quat import quat_to_rotmat as jax_quat_to_rotmat
from lara_tpu.utils.sh import eval_sh_color as jax_eval_sh_color
from lara_tpu.utils.sh import rsh_cart_3 as jax_rsh_cart_3
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import rasterize_and_bin, rasterize_rebind
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels
from lara_tpu_torch.utils import camera as tcam
from lara_tpu_torch.utils.quat import quat_to_rotmat
from lara_tpu_torch.utils.sh import eval_sh_color, rsh_cart_3
from tests.test_rasterizer import front_camera, make_cfg
from tests.test_torch_blend import pallas_interpret, scene_np, torch_cfg  # noqa: F401


def t(a):
    return torch.from_numpy(np.array(a))


def torch_camera(cam):
    return tcam.Camera(*(t(getattr(cam, f)) for f in cam._fields))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(quat_to_rotmat(t(q)).numpy(),
                               np.asarray(jax_quat_to_rotmat(jnp.asarray(q))), atol=1e-5)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(rsh_cart_3(t(d)).numpy(),
                               np.asarray(jax_rsh_cart_3(jnp.asarray(d))), atol=1e-5)
    shs = rng.normal(size=(64, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        eval_sh_color(t(shs), t(d), 1).numpy(),
        np.asarray(jax_eval_sh_color(jnp.asarray(shs), jnp.asarray(d), 1)), atol=1e-5)

    c2w = np.asarray(front_camera().w2c)
    c2w = np.linalg.inv(c2w).astype(np.float32)
    np.testing.assert_allclose(tcam.invert_rigid(t(c2w)).numpy(),
                               np.asarray(jcam.invert_rigid(jnp.asarray(c2w))), atol=1e-6)
    rays = rng.normal(size=(9, 11, 6)).astype(np.float32)
    np.testing.assert_allclose(tcam.ray_to_plucker(t(rays)).numpy(),
                               np.asarray(jcam.ray_to_plucker(jnp.asarray(rays))), atol=1e-5)
    depth = rng.uniform(1.0, 2.0, (9, 11)).astype(np.float32)
    np.testing.assert_allclose(tcam.depth_to_normal(t(rays), t(depth))[0].numpy(),
                               np.asarray(jcam.depth_to_normal(jnp.asarray(rays),
                                                               jnp.asarray(depth))[0]),
                               atol=1e-5)


@pytest.mark.parametrize("dup", [2, 3])
def test_preprocess_matches_jax(dup):
    cfg = make_cfg(dup=dup)
    cam = front_camera()
    scene = scene_np(3, 300, extent=1.2, op_rng=(-7.0, 3.0))
    want = jax_preprocess(*(jnp.asarray(a) for a in scene), cam, cfg)
    got = preprocess_surfels(*(t(a) for a in scene), torch_camera(cam), torch_cfg(cfg))
    for name in ProjectedSurfels._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "valid":
            np.testing.assert_array_equal(a, b)
        else:
            # au/bv are axes over σ (O(100) here): rtol covers their f32 ulps
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)
    assert 0 < want.valid.sum() < 300     # the frustum/opacity cull is exercised


@pytest.mark.parametrize("dup,visible", [(2, 0), (3, 0), (3, 200)])
def test_bin_view_identical(dup, visible):
    """Same ProjectedSurfels in → identical integer binning out."""
    cfg = make_cfg(dup=dup, tile_budget=64, visible_budget=visible)
    g = jax_preprocess(*(jnp.asarray(a) for a in scene_np(4, 300)), front_camera(), cfg)
    packed_j, bin_j = jax_bin_view(g, cfg)
    packed_t, bin_t = bin_view(ProjectedSurfels(*(t(a) for a in g)), torch_cfg(cfg))
    np.testing.assert_array_equal(bin_t.order_v.numpy(), np.asarray(bin_j.order_v))
    np.testing.assert_array_equal(bin_t.counts.numpy(), np.asarray(bin_j.counts))
    np.testing.assert_array_equal(bin_t.win_gidx.numpy(), np.asarray(bin_j.win_gidx))
    np.testing.assert_array_equal(bin_t.entry_valid.numpy(), np.asarray(bin_j.entry_valid))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    assert np.asarray(bin_j.counts).max() == 64    # some tile is over budget


def _assert_render_close(got, want):
    """RenderOutput fields → [T=1, C, P]-free comparison with the blend bar."""
    for name, atol in (("image", 2e-4), ("alpha", 2e-4), ("normal", 2e-4),
                       ("distortion", 2e-4), ("depth_expected", 1e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=atol, err_msg=name)
    bad = np.abs(got.depth_median.numpy() - np.asarray(want.depth_median)) > 1e-3
    assert bad.mean() <= 1e-3


def test_render_and_rebind_match_pallas(pallas_interpret):  # noqa: F811
    cfg = make_cfg(dup=3, tile_budget=64, backend="pallas", pallas_chunk=32,
                   visible_budget=256)
    cam = front_camera()
    means, shs, op, scales, quats = scene_np(7, 300)
    bg = np.array([0.2, 0.5, 0.8], np.float32)
    want, bin_j = jax_rasterize_and_bin(*(jnp.asarray(a) for a in
                                          (means, shs, op, scales, quats)),
                                        cam, jnp.asarray(bg), cfg)
    tc, tcfg = torch_camera(cam), torch_cfg(cfg)
    got, bin_t = rasterize_and_bin(*(t(a) for a in (means, shs, op, scales, quats)),
                                   tc, t(bg), tcfg)
    assert float(want.alpha.max()) > 0.5
    _assert_render_close(got, want)

    # re-render the same geometry with new SH and half the surfels disabled
    rng = np.random.default_rng(8)
    shs2 = (shs + rng.normal(size=shs.shape) * 0.2).astype(np.float32)
    op2 = np.where(rng.uniform(size=op.shape) < 0.5, op, 0.0).astype(np.float32)
    want2 = jax_rasterize_rebind(bin_j, *(jnp.asarray(a) for a in
                                          (means, shs2, op2, scales, quats)),
                                 cam, jnp.asarray(bg), cfg)
    got2 = rasterize_rebind(bin_t, *(t(a) for a in (means, shs2, op2, scales, quats)),
                            tc, t(bg), tcfg)
    _assert_render_close(got2, want2)
    assert not np.allclose(got2.image.numpy(), got.image.numpy())


def test_backend_names():
    from lara_tpu_torch.ops.rasterizer.api import resolve_backend
    assert resolve_backend("auto") == resolve_backend("pallas") == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("tiled")


def test_window_gather_invalid_slots_send_no_gradient():
    """Slots past a tile's count hold the sentinel index; the gather's
    backward sums only valid slots (`_window_gather_lazy` in the JAX
    package), so a gradient on a sentinel slot reaches no packed row."""
    rng = np.random.default_rng(0)
    packed = torch.from_numpy(rng.normal(size=(6, 13)).astype(np.float32)).requires_grad_(True)
    win = torch.tensor([[0, 3, 5, 2**19 - 1], [4, 2**19 - 1, 2**19 - 1, 2**19 - 1]])
    valid = torch.tensor([[True, True, True, False], [True, False, False, False]])
    rows = window_gather(packed, win, valid)
    np.testing.assert_array_equal(rows[valid].detach().numpy(),
                                  packed.detach().numpy()[win[valid].numpy()])
    assert not rows[~valid].any()
    (g,) = torch.autograd.grad(rows, packed, torch.ones_like(rows))
    np.testing.assert_array_equal(g.sum(-1).numpy(), [13.0, 0.0, 0.0, 13.0, 13.0, 13.0])
