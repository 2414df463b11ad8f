"""The port's MS-SSIM, losses and optimizer against the JAX package on the
same numpy-made inputs.

Tolerances: MS-SSIM and the losses in f32 at atol 1e-5 on values and 1e-6
on input gradients (the JAX blur is a banded matmul, the port's a
depthwise convolution: the same sums in another order). Parameters after
each optimizer micro-step at atol 1e-6 (one AdamW update of size ~lr in
f32; optax and torch order the Adam arithmetic differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lara_tpu.models.convert import convert_network_state_dict
from lara_tpu.ops import msssim as jmsssim
from lara_tpu.train import loss as jloss
from lara_tpu.train import state as jstate
from lara_tpu_torch.config import TrainConfig, config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.ops import msssim
from lara_tpu_torch.train import loss as tloss
from lara_tpu_torch.train import state as tstate
from tests.test_model import tiny_config
from tests.test_torch_blend import one_torch_thread  # noqa: F401


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("shape,weights", [
    ((2, 3, 64, 96), (0.0448, 0.2856, 0.3001)),
    ((1, 3, 176, 192), msssim._MSSSIM_WEIGHTS),
])
def test_ms_ssim_matches_jax(shape, weights):
    rng = np.random.default_rng(0)
    y = rng.uniform(size=shape).astype(np.float32)
    x = np.clip(y + 0.2 * rng.normal(size=shape), 0, 1).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda a: jmsssim.ms_ssim(a, jnp.asarray(y), weights=weights)))(jnp.asarray(x))
    xt = _t(x, grad=True)
    got = msssim.ms_ssim(xt, _t(y), weights=weights)
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6)
    assert np.abs(np.asarray(want_g)).max() > 1e-5
    # single-scale SSIM too
    np.testing.assert_allclose(msssim.ssim(_t(x), _t(y)).item(),
                               float(jax.jit(jmsssim.ssim)(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-5)


OUT_KEYS = ("image", "image_fine", "rend_dist", "rend_normal", "depth_normal", "acc_map")


def _outputs(B=1, N=3, H=48, W=64, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(B, N, H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    out = {
        "image": rng.uniform(size=(B, N, H, W, 3)),
        "image_fine": rng.uniform(size=(B, N, H, W, 3)),
        "rend_dist": rng.uniform(0, 1e-3, size=(B, N, H, W)),
        "rend_normal": nrm,
        "depth_normal": nrm + 0.3 * rng.normal(size=(B, N, H, W, 3)),
        "acc_map": rng.uniform(size=(B, N, H, W)),
    }
    batch = {"tar_rgb": rng.uniform(size=(B, N, H, W, 3))}
    return ({k: v.astype(np.float32) for k, v in out.items()},
            {k: v.astype(np.float32) for k, v in batch.items()})


@pytest.fixture(scope="module")
def jax_losses():
    """One JAX compile for every step value: the step is traced."""
    out, batch = _outputs()
    fn = jax.jit(jax.value_and_grad(
        lambda o, s: jloss.compute_losses(batch, o, s), has_aux=True))
    return out, batch, fn


@pytest.mark.parametrize("step", [0, 2002])
def test_compute_losses_matches_jax(jax_losses, step):
    out, batch, fn = jax_losses
    (want, want_stats), want_g = fn({k: jnp.asarray(v) for k, v in out.items()},
                                    jnp.int32(step))
    tout = {k: _t(v, grad=True) for k, v in out.items()}
    got, stats = tloss.compute_losses({"tar_rgb": _t(batch["tar_rgb"])}, tout, step)
    grads = torch.autograd.grad(got, [tout[k] for k in OUT_KEYS], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    assert set(stats) == set(want_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v.item(), float(want_stats[k]), atol=1e-5, err_msg=k)
    for k, g in zip(OUT_KEYS, grads):
        g = np.zeros_like(out[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want_g[k]), atol=1e-6, err_msg=k)
    # the gate: distortion and normal terms only after step 1000; the alpha
    # of the normal term is detached in both
    gated = [np.abs(np.asarray(want_g[k])).max() for k in ("rend_dist", "rend_normal")]
    assert all(g > 0 for g in gated) == (step > 1000)
    assert np.abs(np.asarray(want_g["acc_map"])).max() == 0.0


def test_num_scales_matches_jax():
    for hw in [(32, 32), (64, 96), (128, 512), (176, 176), (512, 512), (512, 2048)]:
        assert tloss._num_scales(*hw) == jloss._num_scales(*hw)


def test_schedule_matches_jax():
    cfg = TrainConfig()
    want = jstate.cosine_warmup_schedule(cfg.lr, cfg.warmup_iters, 30000)
    got = tstate.cosine_warmup_schedule(cfg.lr, cfg.warmup_iters, 30000)
    for step in (0, 1, 2, 500, 999, 1000, 1001, 2002, 15000, 29999, 30000, 40000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-10)


# parameters a coarse-only step does not reach: their gradient is None in
# torch and 0 under optax
FINE_ONLY = ("decoder.mlp_fine.", "decoder.cross_att.", "decoder.norm.")


@pytest.fixture(scope="module")
def tiny_net():
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    return cfg, LaRaNet(cfg, dtype=torch.float32, device="cpu")


def test_decay_mask_matches_jax(tiny_net):
    cfg, net = tiny_net
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params = convert_network_state_dict(sd, num_layers=cfg.model.num_layers,
                                        encoder_depth=cfg.model.encoder_depth)
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                        jstate.decay_mask(params), params)
    want = {k for k, v in params_from_jax(mask).items() if bool(v.flatten()[0])}
    got = {k for k, v in tstate.decay_mask(net).items() if v}
    assert got == want
    assert {"img_encoder.model.pos_embed", "img_encoder.model.cls_token",
            "view_embed", "vol_decoder.pos_embed"} <= got
    assert "dir_norm.norm.weight" not in got and "decoder.mlp_fine.0.bias" not in got


def test_optimizer_matches_optax(tiny_net):
    """Four micro-steps with grad_accum 2 (two AdamW updates, the first at
    the schedule's initial lr, the second at its peak) under clip 0.5, with
    seeded synthetic gradients; the fine-only parameters get none."""
    cfg, net = tiny_net
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    tcfg = TrainConfig(warmup_iters=1, grad_accum=2)
    state = tstate.TrainState(net, tcfg, max_iters=10)
    sd = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    conv = lambda d: convert_network_state_dict(  # noqa: E731
        d, num_layers=cfg.model.num_layers, encoder_depth=cfg.model.encoder_depth)
    params = conv(sd)
    tx, _ = jstate.make_optimizer(tcfg, 10)
    opt_state = tx.init(params)

    @jax.jit
    def update(g, s, p):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    rng = np.random.default_rng(0)
    before = sd
    for micro in range(4):
        grads = {k: (np.zeros_like(v) if k.startswith(FINE_ONLY)
                     else rng.normal(size=v.shape).astype(np.float32) * 0.1)
                 for k, v in sd.items()}
        for k, p in net.named_parameters():
            if not k.startswith(FINE_ONLY):
                g = torch.from_numpy(grads[k].copy())   # backward accumulates
                p.grad = g if p.grad is None else p.grad + g
        updated, info = state.apply_gradients()
        params, opt_state = update(conv(grads), opt_state, params)
        assert updated == (micro % 2 == 1) and state.step == micro + 1
        want = {k: v.numpy() for k, v in params_from_jax(params).items()}
        got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=f"{micro} {k}")
        moved = max(np.abs(got[k] - before[k]).max() for k in got)
        if micro == 3:
            assert info["grad_norm"] > tcfg.grad_clip and info["lr"] == tcfg.lr
            assert moved > 1e-4
        elif micro == 1:
            assert 0.0 < moved < 1e-8           # the update at lr 1e-10
        else:
            assert moved == 0.0
        before = {k: v.copy() for k, v in got.items()}
