"""The port's network and serving forward against the JAX package, in f32
on both sides, on `tests/test_model.py:tiny_config` with the same weights
(`params_from_jax`).

Tolerances: the ViT, ModLN and decoders at atol 1e-4 (f32 matmul order);
the volume transformer at 5e-4 (two stacked layers, as tests/test_convert.py);
the slice at atol 1e-3 on image / acc_map (coarse and fine) and 5e-3 on
depth, after the fine selections agree as sets (lax.top_k and torch.topk may
order ties differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu.models.convert import convert_network_state_dict
from lara_tpu_torch.config import config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.train.step import make_forward
from tests.test_model import synthetic_batch, tiny_config
from tests.test_torch_blend import pallas_interpret  # noqa: F401


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def nets():
    """(jax cfg, jax net, jax params, torch net) with identical weights."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, backend="pallas"))
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    batch = synthetic_batch(B=1)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(0))
    tnet = LaRaNet(config_from_dict(dataclasses.asdict(cfg)), dtype=torch.float32,
                   device="cpu")
    tnet.load_state_dict(params_from_jax(params["params"]), strict=True)
    return cfg, jnet, params, tnet.eval()


def test_params_from_jax_round_trips(nets):
    cfg, _, params, tnet = nets
    sd = {k: v.numpy() for k, v in params_from_jax(params["params"]).items()}
    back = convert_network_state_dict(sd, num_layers=cfg.model.num_layers,
                                      encoder_depth=cfg.model.encoder_depth)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=str(k))
    # and the state dict names are exactly the module's
    assert set(sd) == set(tnet.state_dict())


def test_vit_and_encode_parity(nets):
    """64² input → the pos-embed is bicubic-resampled 14 → 4."""
    _, jnet, params, tnet = nets
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    rays = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(imgs), method=lambda m, x: m.img_encoder(x))
    with torch.no_grad():
        got = tnet.img_encoder(_t(imgs))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    want = jnet.apply(params, jnp.asarray(imgs), jnp.asarray(rays), method="encode_images")
    with torch.no_grad():
        got = tnet.encode_images(_t(imgs), _t(rays))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


def test_vol_transformer_parity(nets):
    cfg, jnet, params, tnet = nets
    m = cfg.model
    r = m.vol_feat_reso
    feats = np.random.default_rng(2).normal(
        size=(1, cfg.n_views, r, r, r, m.encoder_dim + m.view_embed_dim)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(feats), method=lambda mod, x: mod.vol_decoder(x))
    with torch.no_grad():
        got = tnet.vol_decoder(_t(feats))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-4)


def test_decoder_parity(nets):
    cfg, jnet, params, tnet = nets
    m = cfg.model
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(1, 27, m.vol_embedding_out_dim)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(feats), method=lambda mod, x: mod.decoder_coarse(
        x, mod.opacity_shift, mod.scaling_shift))
    with torch.no_grad():
        got = tnet.decoder.forward_coarse(_t(feats), tnet.opacity_shift, tnet.scaling_shift)
    for name, a, b in zip(["offset", "sh", "scaling", "rotation", "opacity"], got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4, err_msg=name)

    vol = rng.normal(size=(40, m.vol_embedding_out_dim)).astype(np.float32)
    pf = rng.normal(size=(40, cfg.n_views, 8)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(vol), jnp.asarray(pf),
                      method=lambda mod, v, p: mod.decoder_fine(v, p))
    with torch.no_grad():
        got = tnet.decoder.forward_fine(_t(vol), _t(pf))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


def test_serving_slice_matches_jax(nets, pallas_interpret):  # noqa: F811
    """LaRaNet.apply(with_fine=True, train=False) vs make_forward."""
    cfg, jnet, params, tnet = nets
    batch = synthetic_batch(B=1)
    want = jnet.apply(params, batch, with_fine=True, train=False, return_buffer=True)
    fwd = make_forward(tnet, with_fine=True, return_buffer=True)
    before = dict(cuda_blend.LAUNCHES)
    got = fwd({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert cuda_blend.LAUNCHES == before                  # CPU: plain version

    # the fine selection, as sets
    sel_want = _np(want["render_pkg"]["fine"][2][..., 0]) > -1e3
    sel_got = got["render_pkg"]["fine"][2][..., 0].numpy() > -1e3
    assert 0 < sel_want.sum() <= cfg.model.fine_budget
    np.testing.assert_array_equal(sel_got, sel_want)

    for key, atol in (("image", 1e-3), ("acc_map", 1e-3), ("image_fine", 1e-3),
                      ("acc_map_fine", 1e-3), ("depth", 5e-3), ("depth_fine", 5e-3)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]), atol=atol, err_msg=key)
    assert float(want["acc_map"].max()) > 0.01
    assert not np.allclose(got["image_fine"].numpy(), got["image"].numpy())
    for key in ("rend_normal", "rend_dist", "depth_normal"):
        assert got[key + "_fine"].shape == want[key + "_fine"].shape, key


def test_unported_options_raise(nets):
    _, _, _, tnet = nets
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(B=1).items()}
    with pytest.raises(NotImplementedError):
        tnet(batch, render_scale=0.5)
    with pytest.raises(NotImplementedError):
        tnet(batch, n_views_sel=1)


def test_laranet_builds_on_the_card_unless_asked():
    """LaRaNet's entry point runs on the card: without a CUDA device the
    default raises, and device="cpu" builds on the CPU."""
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    if torch.cuda.is_available():
        assert next(LaRaNet(cfg).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LaRaNet(cfg)
    assert next(LaRaNet(cfg, device="cpu").parameters()).device.type == "cpu"
