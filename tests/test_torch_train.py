"""The port's training step against the JAX package, in f32 on both sides,
on `tests/test_model.py:tiny_config` at B=1 with the fine stage on and the
same weights (`params_from_jax`); the JAX side runs its Pallas blend in
interpret mode, the port its plain blend under autograd.

Tolerance: the loss and every stat at atol 1e-5 (rtol 1e-4 for PSNR), and
each parameter's gradient within 5e-3 of the JAX gradient in relative L2
norm. The two backward passes sum the same f32 terms in another order:
the blend's (log-domain transmittance against the TPU kernel's
vjp-by-chunk), the fine stage's grid samples and the transformers'
attention. The largest difference seen is 8.3e-4.

The loss gates are tested off (step 0) and on (step 2002) with one JAX
compile: the step is a traced argument. One more compile holds the step
with the training knobs `flash_attn=True` and `pallas_stash_carries=False`
(JAX: Pallas flash attention and the replay blend backward, both
interpreted, remat off on both sides since the flash interpreter's effect
is rejected by jax.remat) to the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu.train.loss import compute_losses as jax_compute_losses
from lara_tpu_torch.config import TrainConfig, config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.train.loss import compute_losses
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_eval_step, make_train_step
from tests.test_model import synthetic_batch, tiny_config
from tests.test_torch_blend import one_torch_thread  # noqa: F401

GRAD_RTOL = 5e-3


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """(cfg, params, batch, jitted value_and_grad(params, step)). The
    Pallas blend runs in interpret mode for this module's compiles."""
    import lara_tpu.ops.rasterizer.pallas_blend as pb

    mp = pytest.MonkeyPatch()
    orig = pb.pl.pallas_call
    mp.setattr(pb.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, backend="pallas"))
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    batch = synthetic_batch(B=1)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(0))

    def loss_fn(p, step):
        out = jnet.apply(p, batch, with_fine=True, train=True)
        return jax_compute_losses(batch, out, step)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    results = {step: vg(params, jnp.int32(step)) for step in (0, 2002)}
    mp.undo()
    return cfg, params, batch, results


@pytest.fixture(scope="module")
def jax_knobs(jax_side):
    """(knob cfg, value_and_grad at step 2002) with the JAX side's weights.
    Only the blend's pallas_call is switched to interpret mode: JAX's flash
    attention runs in its own TPU interpreter off the TPU."""
    import types

    import lara_tpu.ops.rasterizer.pallas_blend as pb

    cfg, params, batch, _ = jax_side
    kcfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, flash_attn=True, remat=False),
        render=dataclasses.replace(cfg.render, pallas_stash_carries=False))
    jnet = JaxLaRaNet(kcfg, dtype=jnp.float32)

    def loss_fn(p, step):
        out = jnet.apply(p, batch, with_fine=True, train=True)
        return jax_compute_losses(batch, out, step)

    orig = pb.pl.pallas_call
    pl = types.SimpleNamespace(**vars(pb.pl))
    pl.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    mp = pytest.MonkeyPatch()
    mp.setattr(pb, "pl", pl)
    result = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jnp.int32(2002))
    mp.undo()
    return kcfg, result


def torch_net(cfg, params, remat=True, policy="full"):
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, remat=remat, remat_policy=policy))
    net = LaRaNet(tcfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(params["params"]), strict=True)
    return net.train()


def torch_grads(net, batch, step):
    out = net(_torch_batch(batch), with_fine=True, train=True)
    loss, stats = compute_losses(_torch_batch(batch), out, step)
    net.zero_grad(set_to_none=True)
    loss.backward()
    return loss, stats, {n: p.grad for n, p in net.named_parameters()}


def assert_step_matches(got, stats, grads, want, want_stats, want_g):
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    assert set(stats) == set(want_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v.item(), float(want_stats[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g["params"]))
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        w = want_g[name]
        assert g is not None and torch.isfinite(g).all(), name
        err = torch.linalg.vector_norm(g - w).item()
        assert err <= GRAD_RTOL * torch.linalg.vector_norm(w).item() + 1e-12, \
            f"{name}: |g - g_jax| = {err:.3e}, |g_jax| = {torch.linalg.vector_norm(w):.3e}"
    # every stage of the network is trained, including the fine MLP
    for prefix in ("img_encoder.", "vol_decoder.", "decoder.mlp_coarse.", "decoder.mlp_fine."):
        assert any(g.abs().max() > 0 for n, g in grads.items() if n.startswith(prefix)), prefix


@pytest.mark.parametrize("step", [0, 2002])
def test_train_step_matches_jax(jax_side, step):
    cfg, params, batch, results = jax_side
    (want, want_stats), want_g = results[step]
    assert_step_matches(*torch_grads(torch_net(cfg, params), batch, step),
                        want, want_stats, want_g)


def test_train_step_with_knobs_matches_jax(jax_side, jax_knobs):
    """flash_attn=True and pallas_stash_carries=False, remat off on both
    sides: the knobs reach the port's modules (on the CPU each runs its
    plain version) and the step agrees with the JAX package's."""
    _, params, batch, _ = jax_side
    kcfg, ((want, want_stats), want_g) = jax_knobs
    net = torch_net(kcfg, params, remat=False)
    assert all(blk.attn.use_flash for blk in net.img_encoder.model.blocks)
    assert net._render_cfg(64, 64, train=True).stash_carries is False
    assert_step_matches(*torch_grads(net, batch, 2002), want, want_stats, want_g)


def test_remat_policy_dots_matches_full(jax_side):
    """remat_policy changes what the backward keeps, never the math: "dots"
    gives the loss and gradients of "full" (tests/test_model.py:240)."""
    cfg, params, batch, _ = jax_side
    runs = [torch_grads(torch_net(cfg, params, policy=p), batch, 2002) for p in ("dots", "full")]
    np.testing.assert_allclose(runs[0][0].item(), runs[1][0].item(), rtol=1e-6)
    for name, g in runs[0][2].items():
        np.testing.assert_allclose(g.numpy(), runs[1][2][name].numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=name)


def test_remat_gives_the_same_gradients(jax_side):
    cfg, params, batch, _ = jax_side
    runs = [torch_grads(torch_net(cfg, params, remat), batch, 2002) for remat in (True, False)]
    np.testing.assert_allclose(runs[0][0].item(), runs[1][0].item(), rtol=1e-6)
    for name, g in runs[0][2].items():
        np.testing.assert_allclose(g.numpy(), runs[1][2][name].numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=name)


def test_train_and_eval_steps(jax_side):
    """make_train_step with grad_accum 2: parameters are unchanged after
    the first micro-step and change after the second; the coarse step
    (with_fine False) gives no fine stats; the eval step returns the
    outputs and the losses."""
    cfg, params, batch, _ = jax_side
    net = torch_net(cfg, params)
    state = TrainState(net, TrainConfig(warmup_iters=0, grad_accum=2), max_iters=100)
    tb = _torch_batch(batch)

    def snapshot():
        return [p.detach().clone() for p in net.parameters()]

    coarse = make_train_step(net, state, with_fine=False, grad_accum=2)
    fine = make_train_step(net, state, with_fine=True, grad_accum=2)
    p0 = snapshot()
    stats = coarse(tb)
    assert "mse_fine" not in stats and torch.isfinite(stats["loss"])
    assert all(torch.equal(a, b) for a, b in zip(p0, snapshot()))
    stats = coarse(tb)
    assert state.step == 2 and not all(torch.equal(a, b) for a, b in zip(p0, snapshot()))
    p1 = snapshot()
    stats = fine(tb)
    assert all(torch.equal(a, b) for a, b in zip(p1, snapshot()))
    stats = fine(tb)
    assert {"loss", "mse_fine", "ssim_fine"} <= set(stats)
    assert all(torch.isfinite(v) for v in stats.values())
    assert not all(torch.equal(a, b) for a, b in zip(p1, snapshot()))

    out, stats = make_eval_step(net)(tb, 2002)
    assert out["image_fine"].shape == tb["tar_rgb"].shape
    assert not out["image_fine"].requires_grad
    assert torch.isfinite(stats["loss"])
