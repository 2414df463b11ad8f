"""The port's network and serving forward against the JAX package, in f32
on both sides, on `tests/test_model.py:tiny_config` with the same weights
(`params_from_jax`), and the view selection (`n_views_sel`, `view_mask`)
and `render_scale` against the JAX forward at 4 input views; the
unscanned volume-transformer stack (`n_groups=(4, 2)`, block sizes
cycling) converted and held against JAX's.

Tolerances: the ViT, ModLN and decoders at atol 1e-4 (f32 matmul order);
the volume transformer at 5e-4 (two stacked layers, as tests/test_convert.py);
the slice at atol 1e-3 on image / acc_map (coarse and fine) and 5e-3 on
depth, after the fine selections agree as sets (the render buffers hold the
selection as a mask; the index sequence, ties to the lower index as
lax.top_k gives them, is held in tests/test_torch_select.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu.models.convert import convert_network_state_dict
from lara_tpu_torch.config import DatasetConfig, config_from_dict
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
    _assert_slice_matches_jax(nets, synthetic_batch(B=1))


def test_mvgen_slice_matches_jax(nets, pallas_interpret):  # noqa: F811
    """Single image → 3D: the procedural zero123plus fixture's grid through
    `MVGenDataset` (slice, matte, INTER_AREA resize, the v1.1 rig) and
    `collate`, at the test config's 64², then the serving slice on both
    sides (the batch has the shapes of `synthetic_batch(B=1)`)."""
    from lara_tpu_torch.data import MVGenDataset
    from lara_tpu_torch.data.loader import collate
    from lara_tpu_torch.data.synthetic import fake_zero123plus_pipeline

    image = np.random.default_rng(4).uniform(size=(48, 40, 3)).astype(np.float32)
    ds = MVGenDataset(DatasetConfig(img_size=(64, 64)),
                      prompts=["a disc"], pipeline=fake_zero123plus_pipeline,
                      text_to_image=lambda p: image)
    batch = collate([ds[0]])
    assert batch["tar_rgb"].shape == (1, 4, 64, 64, 3)
    _assert_slice_matches_jax(nets, {k: v for k, v in batch.items() if k != "meta"})


def _assert_slice_matches_jax(nets, batch):
    cfg, jnet, params, tnet = nets
    want = jnet.apply(params, jax.tree.map(jnp.asarray, batch), with_fine=True, train=False,
                      return_buffer=True)
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
    """render_scale and n_views_sel are ported (the tests below); what
    stays outside the port, or outside the options' range, raises."""
    cfg, _, _, tnet = nets
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(B=1).items()}
    with pytest.raises(ValueError, match="render_scale"):
        tnet(batch, render_scale=0.0)
    for n in (0, cfg.n_views + 1):
        with pytest.raises(ValueError, match="n_views_sel"):
            tnet(batch, n_views_sel=n)


def test_masked_modules_match_jax(nets):
    """The key masks of the volume transformer (per view, spread over each
    group's tokens) and of the fine decoder (per view) against the JAX
    modules, with one of the two views masked."""
    cfg, jnet, params, tnet = nets
    m = cfg.model
    r = m.vol_feat_reso
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 2, r, r, r, m.encoder_dim + m.view_embed_dim)).astype(np.float32)
    vm = np.array([[True, False], [True, False]])
    want = jnet.apply(params, jnp.asarray(feats), jnp.asarray(vm),
                      method=lambda mod, x, v: mod.vol_decoder(x, v))
    with torch.no_grad():
        got = tnet.vol_decoder(_t(feats), torch.from_numpy(vm))
        unmasked = tnet.vol_decoder(_t(feats))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-4)
    assert not np.allclose(got.numpy(), unmasked.numpy(), atol=1e-3)

    vol = rng.normal(size=(40, m.vol_embedding_out_dim)).astype(np.float32)
    pf = rng.normal(size=(40, 2, 8)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(vol), jnp.asarray(pf), jnp.asarray(vm[0]),
                      method=lambda mod, v, p, k: mod.decoder_fine(v, p, k))
    with torch.no_grad():
        got = tnet.decoder.forward_fine(_t(vol), _t(pf), torch.from_numpy(vm[0]))
        one_view = tnet.decoder.forward_fine(_t(vol), _t(pf[:, :1]))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), one_view.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def nets_groups():
    """The `nets` setting with `n_groups=(4, 2)` and 3 layers: block sizes
    2, 4, 2, which JAX builds as the unscanned `layer0 … layer2`; the
    weights from PRNGKey(0), carried across by `params_from_jax` and loaded
    strictly. One JAX init for the tests below."""
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, n_groups=(4, 2), num_layers=3),
        render=dataclasses.replace(cfg.render, backend="pallas"))
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    params = jax.jit(lambda r: jnet.init(r, synthetic_batch(B=1), with_fine=True,
                                         train=False))(jax.random.PRNGKey(0))
    tnet = LaRaNet(config_from_dict(dataclasses.asdict(cfg)), dtype=torch.float32,
                   device="cpu")
    tnet.load_state_dict(params_from_jax(params["params"]), strict=True)
    return cfg, jnet, params, tnet.eval()


def test_unscanned_stack_converts_to_the_scanned_names(nets_groups):
    """The JAX tree has `layer{i}` in place of `layers/block`; converted, it
    gives the state-dict names of the same network with one block size."""
    cfg, _, params, _ = nets_groups
    vol = params["params"]["vol_decoder"]
    assert "layers" not in vol and {f"layer{i}" for i in range(3)} <= set(vol)
    one_size = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, n_groups=(4,)))
    scanned = LaRaNet(config_from_dict(dataclasses.asdict(one_size)), dtype=torch.float32,
                      device="cpu")
    sd = params_from_jax(params["params"])
    assert set(sd) == set(scanned.state_dict())
    blk = vol["layer1"]
    np.testing.assert_array_equal(sd["vol_decoder.layers.1.norm2.weight"].numpy(),
                                  _np(blk["norm2"]["scale"]))
    np.testing.assert_array_equal(sd["vol_decoder.layers.1.mlp.0.weight"].numpy(),
                                  _np(blk["mlp"]["fc1"]["kernel"]).T)


def test_scanned_stack_still_converts(nets):
    """A one-block-size config keeps JAX's scanned stack, and each layer's
    tensors are that stack's slices."""
    _, _, params, _ = nets
    vol = params["params"]["vol_decoder"]
    assert "layers" in vol and not any(k.startswith("layer") and k[5:].isdigit() for k in vol)
    sd = params_from_jax(params["params"])
    stack = vol["layers"]["block"]
    for i in range(2):
        np.testing.assert_array_equal(sd[f"vol_decoder.layers.{i}.norm1.bias"].numpy(),
                                      _np(stack["norm1"]["bias"])[i])
        np.testing.assert_array_equal(
            sd[f"vol_decoder.layers.{i}.cnn.weight"].numpy(),
            _np(stack["cnn"]["kernel"])[i].transpose(4, 3, 0, 1, 2))


def test_unscanned_vol_transformer_parity(nets_groups):
    """The block sizes cycle as JAX's (`i % len(n_groups)`, volume.py:217):
    the port's stack equals JAX's at the atol of test_vol_transformer_parity,
    and the same weights with the sizes in the other order do not."""
    cfg, jnet, params, tnet = nets_groups
    m = cfg.model
    r = m.vol_feat_reso
    feats = np.random.default_rng(2).normal(
        size=(1, cfg.n_views, r, r, r, m.encoder_dim + m.view_embed_dim)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(feats), method=lambda mod, x: mod.vol_decoder(x))
    assert tnet.vol_decoder.block_sizes == [2, 4]
    with torch.no_grad():
        got = tnet.vol_decoder(_t(feats))
        tnet.vol_decoder.block_sizes = [4, 2]
        try:
            swapped = tnet.vol_decoder(_t(feats))
        finally:
            tnet.vol_decoder.block_sizes = [2, 4]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-4)
    assert np.abs(swapped.numpy() - _np(want)).max() > 1e-2


def test_unscanned_serving_slice_matches_jax(nets_groups, pallas_interpret):  # noqa: F811
    """The serving forward on the unscanned stack, as
    test_serving_slice_matches_jax runs it."""
    _assert_slice_matches_jax(nets_groups, synthetic_batch(B=1))


@pytest.fixture(scope="module")
def nets4():
    """tiny_config(n_views=4) in f32 on both sides, weights from
    PRNGKey(2), batch seed 4: tests/test_model.py:199,211's setting. The
    JAX side renders with its default CPU backend (the XLA formulation)."""
    cfg = tiny_config(n_views=4)
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    batch = synthetic_batch(B=1, n_views=4, H=64, W=64, seed=4)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(2))
    tnet = LaRaNet(config_from_dict(dataclasses.asdict(cfg)), dtype=torch.float32,
                   device="cpu")
    tnet.load_state_dict(params_from_jax(params["params"]), strict=True)
    return jnet, params, batch, tnet


def _assert_views_match(got, want, shape):
    for key, atol in (("image", 1e-3), ("image_fine", 1e-3), ("acc_map_fine", 1e-3),
                      ("depth", 5e-3), ("depth_fine", 5e-3)):
        assert tuple(got[key].shape[:4]) == shape == tuple(want[key].shape[:4]), key
        np.testing.assert_allclose(got[key].detach().numpy(), _np(want[key]), atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("case", ["n_views_sel=2", "n_views_sel=3", "view_mask=3"])
def test_view_selection_matches_jax(nets4, case):
    """use_rand_views both ways, on the training forward (train=True, fine
    on), against the JAX forward (atol as the serving slice's)."""
    jnet, params, batch, tnet = nets4
    name, n = case.split("=")
    n = int(n)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    if name == "view_mask":
        vm = np.arange(4) < n
        jb = dict(batch, view_mask=jnp.asarray(vm))
        want = jax.jit(lambda p, b: jnet.apply(p, b, with_fine=True, train=True))(params, jb)
        got = tnet(dict(tb, view_mask=torch.from_numpy(vm)), with_fine=True, train=True)
        # the mask path equals the prefix path (tests/test_model.py:211)
        sliced = tnet(tb, with_fine=True, train=True, n_views_sel=n)
        for k in ("image", "image_fine", "depth"):
            np.testing.assert_allclose(got[k].detach().numpy(), sliced[k].detach().numpy(),
                                       atol=2e-5, err_msg=k)
    else:
        want = jax.jit(lambda p, b: jnet.apply(p, b, with_fine=True, train=True,
                                               n_views_sel=n))(params, batch)
        got = tnet(tb, with_fine=True, train=True, n_views_sel=n)
    _assert_views_match(got, want, (1, 8, 64, 64))


def test_render_scale_matches_jax(nets4):
    """render_scale=0.5 (tests/test_model.py:199): 32² renders of the
    linearly resized rays; the fine stage samples the coarse renders
    resized back to 64²; make_forward takes the scale."""
    jnet, params, batch, tnet = nets4
    want = jax.jit(lambda p, b: jnet.apply(p, b, with_fine=True, train=False,
                                           render_scale=0.5))(params, batch)
    got = make_forward(tnet, with_fine=True, render_scale=0.5)(
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    _assert_views_match(got, want, (1, 8, 32, 32))


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
