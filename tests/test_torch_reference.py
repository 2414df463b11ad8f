"""The port's reference rasterizer backend (`ops/rasterizer/reference.py`,
`render.backend: reference`) against the JAX package on the same inputs.

(a) `rasterize_reference` against JAX `rasterize_reference` on the scenes
    of tests/test_torch_rasterizer.py (the analytic ones, a random one and
    big splats): values (image, alpha, normal, both depths, distortion) at
    atol 1e-4, gradients of mean(image) + mean(distortion) against
    `jax.grad` at atol 5e-4. The scenes are padded with culled surfels
    (opacity 0) to one size, so the JAX side compiles once.
(b) surfel chunks of 7, 64 and N (and pixel chunks of 100) give the same
    render within 1e-6 (the depths, ~2, within 1e-6 relative): the carried
    transmittance, accumulators, median and distortion moments depend on
    the chunking only through f32 rounding.
(c) with nothing truncated (no radius past the dup clamp, no tile over its
    budget, no visible budget), the reference equals the binned backend
    (on the CPU the blend's plain version) at the blend's bars: values atol
    2e-4, gradients atol 5e-4 / rtol 1e-3.
(d) `LaRaNet` in f32 with `render.backend=reference`, coarse and fine,
    against the JAX `LaRaNet` with the same backend and the weights carried
    over by `params_from_jax`, at tests/test_torch_model.py's forward bars;
    `make_train_step` and `evaluate` run with the backend.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu.ops.rasterizer.reference import rasterize_reference as jax_reference
from lara_tpu_torch import evaluate
from lara_tpu_torch.config import TrainConfig, config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.ops.rasterizer import (cuda_blend, rasterize, rasterize_and_bin,
                                           rasterize_rebind)
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.reference import rasterize_reference
from lara_tpu_torch.ops.rasterizer.tiled import bin_view
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_forward, make_train_step
from tests.test_model import synthetic_batch, tiny_config
from tests.test_rasterizer import front_camera, make_cfg
from tests.test_torch_blend import one_torch_thread, scene_np, torch_cfg  # noqa: F401
from tests.test_torch_rasterizer import _analytic_scene, _jax_scene, t, torch_camera

FIELDS = ("image", "alpha", "normal", "depth_expected", "depth_median", "distortion")
PAD_N = 300


def _scene(name):
    """(means, shs, opacities, scales, quats, bg) of a battery scene."""
    if name in ("single", "two", "tilted"):
        return _analytic_scene(name)
    if name == "random":
        return (*scene_np(7, 300), np.array([0.2, 0.5, 0.8], np.float32))
    means, shs, op, _, quats = _jax_scene(3, 300)            # big splats
    return (means, shs, op, np.full((300, 2), 0.25, np.float32), quats,
            np.ones(3, np.float32))


def _padded(scene, n=PAD_N):
    """The scene with culled surfels (opacity 0) appended up to n."""
    k = n - scene[0].shape[0]
    pad = (np.zeros((k, 3)), np.zeros((k, 4, 3)), np.zeros((k,)), np.full((k, 2), 0.05),
           np.tile([[1.0, 0.0, 0.0, 0.0]], (k, 1)))
    return tuple(np.concatenate([a, p.astype(np.float32)]) for a, p in zip(scene[:5], pad)) \
        + (scene[5],)


@pytest.fixture(scope="module")
def jax_fns():
    cfg = make_cfg(backend="reference")
    cam = front_camera()

    def loss(m, s, o, sc, q, bg):
        out = jax_reference(m, s, o, sc, q, cam, bg, cfg)
        return jnp.mean(out.image) + jnp.mean(out.distortion)

    return (cfg, jax.jit(lambda *a: jax_reference(*a[:5], cam, a[5], cfg)),
            jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4))))


@pytest.mark.parametrize("name", ["single", "two", "tilted", "random", "big"])
def test_reference_matches_jax(name, jax_fns, one_torch_thread):  # noqa: F811
    cfg, jax_fwd, jax_grad = jax_fns
    scene = _padded(_scene(name))
    want = jax_fwd(*(jnp.asarray(a) for a in scene))
    leaves = [t(a).requires_grad_(True) for a in scene[:5]]
    got = rasterize_reference(*leaves, torch_camera(front_camera()), t(scene[5]),
                              torch_cfg(cfg))
    assert float(want.alpha.max()) > 0.3
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4, err_msg=f)
    (torch.mean(got.image) + torch.mean(got.distortion)).backward()
    g_want = jax_grad(*(jnp.asarray(a) for a in scene))
    for a, b, f in zip(g_want, leaves, ["means", "shs", "opacities", "scales", "quats"]):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=5e-4, err_msg=f)


def test_surfel_chunking_changes_nothing(one_torch_thread):  # noqa: F811
    """Chunks of 7 and 64 surfels (and 100 pixels) against one chunk of
    all N, on a scene whose opaque stack ends every pixel's walk early."""
    means, shs, op, scales, quats = scene_np(5, 400, op_rng=(0.0, 6.0))
    args = (*(t(a) for a in (means, shs, op, scales, quats)), torch_camera(front_camera()),
            t(np.full(3, 0.3, np.float32)), torch_cfg(make_cfg(backend="reference")))
    whole = rasterize_reference(*args, surfel_chunk=400)
    assert float(whole.alpha.max()) > 0.99
    for kw in ({"surfel_chunk": 7}, {"surfel_chunk": 64}, {"surfel_chunk": 64, "pixel_chunk": 100}):
        got = rasterize_reference(*args, **kw)
        for f in FIELDS:
            # the depths are ~2: 1e-6 relative there is ~4 f32 ulps
            rtol = 1e-6 if f.startswith("depth") else 0.0
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(whole, f).numpy(),
                                       atol=1e-6, rtol=rtol, err_msg=f"{kw} {f}")


def test_reference_equals_binned_when_nothing_truncates(one_torch_thread):  # noqa: F811
    scene = scene_np(11, 300)
    cfg = torch_cfg(make_cfg(tile_budget=512, pallas_chunk=64))
    cam, bg = torch_camera(front_camera()), t(np.full(3, 0.4, np.float32))
    g, overflow = preprocess_surfels(*(t(a) for a in scene), cam, cfg, return_overflow=True)
    _, binned = bin_view(g, cfg)
    assert float(overflow) == 0.0 and int(binned.counts.max()) < cfg.tile_budget

    def render(c):
        leaves = [t(a).requires_grad_(True) for a in scene]
        out = rasterize(*leaves, cam, bg, c)
        (torch.mean(out.image) + torch.mean(out.distortion)).backward()
        return out, [p.grad for p in leaves]

    ref, g_ref = render(dataclasses.replace(cfg, backend="reference"))
    got, g_got = render(cfg)
    assert float(ref.alpha.detach().max()) > 0.5
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   getattr(ref, f).detach().numpy(), atol=2e-4, err_msg=f)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3)


def test_reference_backend_has_no_binning():
    scene = [t(a) for a in scene_np(2, 50)]
    cam, bg = torch_camera(front_camera()), t(np.zeros(3, np.float32))
    cfg = torch_cfg(make_cfg(backend="reference"))
    out, binned = rasterize_and_bin(*scene, cam, bg, cfg)
    assert binned is None
    again = rasterize_rebind(None, *scene, cam, bg, cfg)
    np.testing.assert_array_equal(again.image.numpy(), out.image.numpy())


def _small_reference_config(backend="reference"):
    """tests/test_model.py:tiny_config with a 4³ volume (1,024 surfels) and
    the given raster backend."""
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, vol_feat_reso=4, vol_embedding_reso=4,
                                       n_groups=(2,), n_offset_groups=8, fine_budget=256),
        render=dataclasses.replace(cfg.render, backend=backend))


def test_laranet_reference_matches_jax(one_torch_thread):  # noqa: F811
    cfg = _small_reference_config()
    batch = synthetic_batch(B=1, H=32, W=32)
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(0))
    want = jax.jit(lambda p, b: jnet.apply(p, b, with_fine=True, train=False,
                                           return_buffer=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tnet = LaRaNet(config_from_dict(dataclasses.asdict(cfg)), dtype=torch.float32,
                   device="cpu")
    tnet.load_state_dict(params_from_jax(params["params"]), strict=True)
    before = dict(cuda_blend.LAUNCHES)
    got = make_forward(tnet.eval(), with_fine=True, return_buffer=True)(
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert cuda_blend.LAUNCHES == before

    sel_want = np.asarray(want["render_pkg"]["fine"][2][..., 0]) > -1e3
    sel_got = got["render_pkg"]["fine"][2][..., 0].numpy() > -1e3
    assert 0 < sel_want.sum() <= cfg.model.fine_budget
    np.testing.assert_array_equal(sel_got, sel_want)
    for key, atol in (("image", 1e-3), ("acc_map", 1e-3), ("image_fine", 1e-3),
                      ("acc_map_fine", 1e-3), ("depth", 5e-3), ("depth_fine", 5e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol,
                                   err_msg=key)
    assert float(want["acc_map"].max()) > 0.01
    assert not np.allclose(got["image_fine"].numpy(), got["image"].numpy())


def test_train_step_runs_on_reference(one_torch_thread):  # noqa: F811
    """One fine micro-step of `make_train_step` at render.backend=reference
    (16² views): finite stats and a gradient that reaches the decoders."""
    cfg = config_from_dict(dataclasses.asdict(_small_reference_config()))
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    state = TrainState(net, TrainConfig(warmup_iters=0, grad_accum=1), max_iters=10)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             synthetic_batch(B=1, H=16, W=16).items()}
    before = [p.detach().clone() for p in net.decoder.parameters()]
    stats = make_train_step(net, state, with_fine=True)(batch)
    assert {"loss", "mse_fine"} <= set(stats)
    assert all(torch.isfinite(v) for v in stats.values())
    assert not all(torch.equal(a, b) for a, b in zip(before, net.decoder.parameters()))


def test_evaluate_runs_on_reference(tmp_path, one_torch_thread):  # noqa: F811
    """`python -m lara_tpu_torch.evaluate ... render.backend=reference`
    (its `main`) on one held-out scene of a 32² store."""
    from lara_tpu_torch.data import write_synthetic_store
    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=4, img_size=(32, 32))
    got = evaluate.main(["configs/synthetic.yaml", "--device", "cpu",
                         "infer_dataset.dataset_name=synthetic", f"infer_dataset.data_root={store}",
                         "infer_dataset.img_size=[32,32]", "infer_dataset.n_scenes=1",
                         "model.vol_feat_reso=4", "model.vol_embedding_reso=4",
                         "model.n_groups=[2]", "model.n_offset_groups=8",
                         "render.backend=reference", f"infer.save_folder={tmp_path}/out",
                         f"infer.metric_path={tmp_path}/m"], dtype=torch.float32)
    assert got["scenes"] == ["scene_0000"] and np.isfinite(got["mean_psnr"])
