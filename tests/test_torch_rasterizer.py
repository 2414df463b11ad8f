"""The port's rasterizer chain against the JAX package on the same inputs:
geometry helpers and preprocess at f32 atol 1e-5 (plus rtol 1e-5 for
preprocess, whose inverse-scale axes are O(100)), bin_view bit-identical,
and whole renders against `rasterize_pallas` (Pallas interpret mode) at the
blend tolerances of tests/test_torch_blend.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.ops.rasterizer.api import rasterize_and_bin as jax_rasterize_and_bin
from lara_tpu.ops.rasterizer.api import rasterize_rebind as jax_rasterize_rebind
from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.rasterizer.reference import rasterize_reference
from lara_tpu.ops.rasterizer.tiled import bin_view as jax_bin_view
from lara_tpu.utils import camera as jcam
from lara_tpu.utils.quat import quat_to_rotmat as jax_quat_to_rotmat
from lara_tpu.utils.sh import eval_sh_color as jax_eval_sh_color
from lara_tpu.utils.sh import rsh_cart_3 as jax_rsh_cart_3
from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import rasterize, rasterize_and_bin, rasterize_rebind
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels
from lara_tpu_torch.utils import camera as tcam
from lara_tpu_torch.utils.quat import quat_to_rotmat
from lara_tpu_torch.utils.sh import eval_sh_color, rsh_cart_3
from tests.test_rasterizer import dc_shs, front_camera, make_cfg, random_scene
from tests.test_torch_blend import (one_torch_thread, pallas_interpret,  # noqa: F401
                                    scene_np, torch_cfg)


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


# ------------------------------------------------------------------------
# The analytic battery of tests/test_rasterizer.py, with the port's
# `rasterize` (CPU: the blend's plain version, ordinary autograd) held
# against the JAX package's per-pixel `rasterize_reference` and against the
# analytic values. Bars: the JAX battery's (analytic 1e-3 / 2e-2 / 5e-3;
# the reference at its tiled backend's 1e-4 on image, alpha, normal and
# distortion and 1e-3 on the depths; gradients 5e-4; finite differences
# 5e-3 relative at eps 1e-3).


def _identity_quats(n):
    return np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), (n, 1))


def _dc_shs(rgb, n):
    return np.asarray(dc_shs(rgb, n))


def _analytic_scene(name):
    """(means, shs, opacities, scales, quats, bg) of the battery's analytic
    scenes (tests/test_rasterizer.py:54, :85, :123)."""
    if name == "single":            # one white surfel facing the camera
        return (np.zeros((1, 3), np.float32), _dc_shs([1.0, 1.0, 1.0], 1),
                np.array([0.8], np.float32), np.full((1, 2), 0.05, np.float32),
                _identity_quats(1), np.zeros(3, np.float32))
    if name == "two":               # red in front of blue on the optical axis
        return (np.array([[0.0, 0.0, -0.2], [0.0, 0.0, 0.2]], np.float32),
                np.concatenate([_dc_shs([1, 0, 0], 1), _dc_shs([0, 0, 1], 1)]),
                np.array([0.6, 0.9], np.float32), np.full((2, 2), 0.08, np.float32),
                _identity_quats(2), np.zeros(3, np.float32))
    s = np.sin(np.pi / 8), np.cos(np.pi / 8)   # "tilted": 45° about y
    return (np.zeros((1, 3), np.float32), _dc_shs([1, 1, 1], 1),
            np.array([0.95], np.float32), np.full((1, 2), 0.1, np.float32),
            np.array([[s[1], 0.0, s[0], 0.0]], np.float32), np.zeros(3, np.float32))


def _port_render(scene, cfg, cam=None):
    cam = cam or front_camera()
    return rasterize(*(t(a) for a in scene[:5]), torch_camera(cam), t(scene[5]),
                     torch_cfg(cfg))


def _assert_matches_reference(got, scene, cfg):
    want = rasterize_reference(*(jnp.asarray(a) for a in scene[:5]), front_camera(),
                               jnp.asarray(scene[5]), cfg)
    for name, atol in (("image", 1e-4), ("alpha", 1e-4), ("normal", 1e-4),
                       ("distortion", 1e-4), ("depth_expected", 1e-3),
                       ("depth_median", 1e-3)):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), atol=atol, err_msg=name)


@pytest.mark.parametrize("name", ["single", "two", "tilted"])
def test_analytic_scenes(name, one_torch_thread):  # noqa: F811
    """tests/test_rasterizer.py:54 (one surfel: alpha, colour, depth and
    normal at the center pixel), :85 (front-to-back compositing, median
    depth at the front surfel), :123 (a 45°-tilted surfel: depth monotone
    across the splat); each render also against the reference."""
    cfg = make_cfg()
    scene = _analytic_scene(name)
    out = _port_render(scene, cfg)
    _assert_matches_reference(out, scene, cfg)
    img, alpha = out.image.numpy(), out.alpha.numpy()
    if name == "single":
        sigma_px = 0.05 * (32.0 / np.tan(0.4)) / 2.0
        expected = 0.8 * np.exp(-0.5 * (0.25 + 0.25) / sigma_px ** 2)
        assert abs(alpha[32, 32] - expected) < 1e-3
        np.testing.assert_allclose(img[32, 32], expected, atol=1e-3)
        assert abs(out.depth_expected[32, 32].item() - 2.0) < 1e-3
        n = out.normal[32, 32].numpy() / max(alpha[32, 32], 1e-6)
        np.testing.assert_allclose(n, [0, 0, -1], atol=2e-2)
        assert alpha[2, 2] < 1e-3
    elif name == "two":
        np.testing.assert_allclose(img[32, 32], [0.6, 0.0, 0.36], atol=2e-2)
        assert abs(alpha[32, 32] - 0.96) < 2e-2
        assert abs(out.depth_median[32, 32].item() - 1.8) < 5e-3
    else:
        cols = np.where(alpha[32] > 0.5)[0]
        assert len(cols) > 4
        dd = out.depth_expected[32].numpy()[cols]
        assert dd[-1] != dd[0]
        assert np.all(np.diff(dd) > 0) or np.all(np.diff(dd) < 0)


def _jax_scene(seed, n):
    return tuple(np.asarray(a) for a in random_scene(jax.random.PRNGKey(seed), n))


def test_gradients_match_reference_and_fd(one_torch_thread):  # noqa: F811
    """tests/test_rasterizer.py:143: the port's autograd gradients of
    mean((image - target)²) + 0.1·mean(distortion) against jax.grad of the
    reference, and a central finite difference along a random direction."""
    cfg = make_cfg(tile_budget=512)
    means, shs, _, scales, quats = _jax_scene(3, 50)
    op_raw = np.asarray(jnp.clip(jax.random.normal(jax.random.PRNGKey(4), (50,)), -1.0, 1.0))
    params = (means, shs, op_raw, np.log(scales), quats)
    bg = np.full((3,), 0.5, np.float32)
    tgt = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (64, 64, 3)))
    cam = front_camera()

    def jax_loss(p):
        m, s, o, sc, q = p
        out = rasterize_reference(m, s, jax.nn.sigmoid(o), jnp.exp(sc), q, cam,
                                  jnp.asarray(bg), cfg)
        return jnp.mean((out.image - tgt) ** 2) + 0.1 * jnp.mean(out.distortion)

    def loss(p):
        m, s, o, sc, q = p
        out = rasterize(m, s, torch.sigmoid(o), torch.exp(sc), q, torch_camera(cam), t(bg),
                        torch_cfg(cfg))
        return torch.mean((out.image - t(tgt)) ** 2) + 0.1 * torch.mean(out.distortion)

    g_ref = jax.grad(jax_loss)(tuple(jnp.asarray(a) for a in params))
    tp = [t(a).requires_grad_(True) for a in params]
    loss(tp).backward()
    for a, b, name in zip(g_ref, tp, ["means", "shs", "op", "scales", "quats"]):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=5e-4, err_msg=name)

    key = jax.random.PRNGKey(7)
    vec = [np.asarray(jax.random.normal(key, a.shape)) for a in params]
    eps = 1e-3
    with torch.no_grad():
        plus = loss([t(a + eps * v) for a, v in zip(params, vec)])
        minus = loss([t(a - eps * v) for a, v in zip(params, vec)])
    fd = float((plus - minus) / (2 * eps))
    ad = sum(float(torch.sum(p.grad * t(v))) for p, v in zip(tp, vec))
    assert abs(fd - ad) < 5e-3 * max(1.0, abs(fd))


@pytest.mark.parametrize("budget", ["tile", "visible"])
def test_budget_overflow_keeps_nearest(budget, one_torch_thread):  # noqa: F811
    """tests/test_rasterizer.py:203: an opaque stack along the axis with a
    tile budget of 16 renders as with 512 wherever the first 16 entries
    saturate; :261: a visible budget of 1 renders the nearer of two
    surfels alone (both against the reference of what they keep)."""
    if budget == "tile":
        n = 64
        scene = (np.stack([np.zeros(n), np.zeros(n), np.linspace(-0.3, 0.3, n)], -1)
                 .astype(np.float32), _dc_shs([0.7, 0.2, 0.4], n),
                 np.full((n,), 0.95, np.float32), np.full((n, 2), 0.05, np.float32),
                 _identity_quats(n), np.zeros(3, np.float32))
        small = _port_render(scene, make_cfg(tile_budget=16, pallas_chunk=16))
        big_cfg = make_cfg(tile_budget=512)
        big = _port_render(scene, big_cfg)
        _assert_matches_reference(big, scene, big_cfg)
        core = small.alpha.numpy() > 0.999
        assert core.sum() > 20
        diff = np.abs(small.image.numpy() - big.image.numpy()).max(-1)
        assert diff[core].max() < 1e-3
    else:
        scene = (np.array([[0.0, 0.0, -0.2], [0.0, 0.0, 0.3]], np.float32),
                 _dc_shs([0.9, 0.2, 0.4], 2), np.array([0.7, 0.9], np.float32),
                 np.full((2, 2), 0.05, np.float32), _identity_quats(2),
                 np.zeros(3, np.float32))
        out = _port_render(scene, make_cfg(visible_budget=1))
        near = tuple(a[:1] for a in scene[:5]) + (scene[5],)
        out_near = _port_render(near, make_cfg())
        np.testing.assert_allclose(out.image.numpy(), out_near.image.numpy(), atol=1e-6)
        _assert_matches_reference(out, near, make_cfg())


def test_visible_budget_noop_when_generous(one_torch_thread):  # noqa: F811
    """tests/test_rasterizer.py:239: a visible budget above the visible
    count changes neither the render nor the gradients."""
    means, shs, op, scales, quats = _jax_scene(21, 200)
    bg = t(np.full((3,), 0.1, np.float32))
    cam = torch_camera(front_camera())

    def run(cfg):
        m = t(means).requires_grad_(True)
        o = rasterize(m, t(shs), t(op), t(scales), t(quats), cam, bg, torch_cfg(cfg))
        (torch.mean(o.image ** 2) + torch.mean(o.distortion)).backward()
        return o.image.detach().numpy(), m.grad.numpy()

    img_a, g_a = run(make_cfg(tile_budget=256))
    img_b, g_b = run(make_cfg(tile_budget=256, visible_budget=512))
    np.testing.assert_allclose(img_b, img_a, atol=1e-6)
    np.testing.assert_allclose(g_b, g_a, atol=1e-6)


def test_big_splat_truncation_bound(one_torch_thread):  # noqa: F811
    """tests/test_rasterizer.py:410: splats far wider than the dup×dup
    tile ring lose only their tails against the reference (PSNR > 20 dB)."""
    means, shs, op, _, quats = _jax_scene(3, 300)
    scene = (means, shs, op, np.full((300, 2), 0.25, np.float32), quats,
             np.ones(3, np.float32))
    cfg = make_cfg(tile_budget=2048)
    got = _port_render(scene, cfg).image.numpy()
    want = np.asarray(rasterize_reference(*(jnp.asarray(a) for a in scene[:5]),
                                          front_camera(), jnp.asarray(scene[5]), cfg).image)
    psnr = -10 * np.log10(np.mean((got - want) ** 2) + 1e-12)
    assert psnr > 20, f"big-splat truncation error too large: {psnr:.1f} dB"
