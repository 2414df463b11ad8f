"""The port's data parallelism against the JAX package's dp mesh, on the
CPU: two ranks of one gloo group, spawned by `torch.multiprocessing` with a
`file://` rendezvous under the test's temporary directory (their bodies are
in tests/torch_parallel_workers.py, which imports no JAX);
`tests/test_model.py:tiny_config` in f32.

Bars:
- dp=2 against JAX `value_and_grad` of `compute_losses` on the same global
  batch of 2 and the same weights (`params_from_jax`; the Pallas blend in
  interpret mode, as tests/test_torch_train.py): the loss at atol 1e-5 and
  each parameter's all-reduced gradient within 5e-3 relative L2 (the bars
  of tests/test_torch_train.py);
- dp=2 against the port at dp=1 on that batch: the loss within 5e-4
  relative (tests/test_train.py:110), the all-reduced gradient within
  5e-3 relative L2 per parameter, and the parameters after one AdamW
  update at rtol 2e-4 / atol 1e-5, that update being the first of the
  schedule as tests/test_train.py:110 takes it (a warmup from 1e-10);
  the two ranks' parameters equal bit for bit. The gradient is not bit
  for bit dp=1's: the forward of one scene rounds differently in a batch
  of 1 and of 2, and the blend's order of near-coincident surfels follows
  (measured: 1.2e-3 on these weights); against one process that forwards
  one scene at a time, as the ranks do, it is held at 1e-4 (measured:
  5e-6, the f32 sums in another order). Adam's first step is ±lr wherever
  |g| ≫ eps, so at lr 1e-3 a few parameters whose gradient is near 0 move
  the other way (4 of pos_embed's 9,456, by up to 1.9e-5): the
  gradient bar is the check with teeth;
- the global-batch loss against the B=2 loss at atol 1e-6 (f32 means
  summed in another order), and the mean of the two halves' losses (what
  per-rank losses with averaged gradients optimise) more than 1e-5 away;
- distributed evaluation against one process: the same scenes, PSNR and
  SSIM within 5e-3 (tests/test_eval.py:270).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.config import DatasetConfig as JaxDatasetConfig
from lara_tpu.config import LoggerConfig as JaxLoggerConfig
from lara_tpu.config import TrainConfig as JaxTrainConfig
from lara_tpu.models import LaRaNet as JaxLaRaNet
from lara_tpu.train.loss import compute_losses as jax_compute_losses
from lara_tpu_torch import evaluate
from lara_tpu_torch.config import TrainConfig, config_from_dict
from lara_tpu_torch.data import DataLoader, SyntheticDataset, write_synthetic_store
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.parallel import distributed, mesh
from lara_tpu_torch.train import checkpoint as ckpt
from lara_tpu_torch.train import state as state_mod
from lara_tpu_torch.train.loss import compute_losses
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_train_step
from tests import torch_parallel_workers as workers
from tests.test_model import synthetic_batch, tiny_config
from tests.test_torch_blend import one_torch_thread  # noqa: F401

STEP = 2002                      # the fine stage and the loss gates on
GRAD_RTOL = 5e-3
TRAIN = TrainConfig(lr=1e-3, warmup_iters=2, grad_accum=1)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """(port cfg, port weights, global batch of 2, JAX ((loss, stats),
    grads) at STEP): one JAX compile, the Pallas blend interpreted."""
    import lara_tpu.ops.rasterizer.pallas_blend as pb

    mp = pytest.MonkeyPatch()
    orig = pb.pl.pallas_call
    mp.setattr(pb.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, backend="pallas"))
    jnet = JaxLaRaNet(cfg, dtype=jnp.float32)
    batch = synthetic_batch(B=2)
    params = jax.jit(lambda r: jnet.init(r, batch, with_fine=True, train=False))(
        jax.random.PRNGKey(0))

    def loss_fn(p):
        return jax_compute_losses(batch, jnet.apply(p, batch, with_fine=True, train=True),
                                  jnp.int32(STEP))

    result = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    mp.undo()
    weights = params_from_jax(jax.tree.map(np.asarray, params["params"]))
    return config_from_dict(dataclasses.asdict(cfg)), weights, _torch_batch(batch), result


@pytest.fixture(scope="module")
def dp2(jax_side, tmp_path_factory):
    """step_body on two ranks over the global batch of 2."""
    cfg, weights, batch, _ = jax_side
    return workers.run_ranks(workers.step_body, 2, str(tmp_path_factory.mktemp("dp2")),
                             cfg, weights, batch, TRAIN, STEP)


def _net(cfg, weights):
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(weights, strict=True)
    return net


def _loss(cfg, weights, batch):
    net = _net(cfg, weights).train()
    return compute_losses(batch, net(batch, with_fine=True, train=True), STEP)[0].item()


def test_dp2_matches_jax(jax_side, dp2):
    """Case 1: the dp=2 loss and all-reduced gradient against JAX's on the
    global batch."""
    _, _, _, ((want, _), want_g) = jax_side
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g["params"]))
    for r in dp2:
        assert r["group_found"] is True
        np.testing.assert_allclose(r["stats"]["loss"], float(want), atol=1e-5)
        assert set(r["grads"]) == set(want_g)
        for name, g in r["grads"].items():
            w = want_g[name]
            err = torch.linalg.vector_norm(g - w).item()
            assert err <= GRAD_RTOL * torch.linalg.vector_norm(w).item() + 1e-12, \
                f"{name}: |g - g_jax| = {err:.3e}, |g_jax| = {torch.linalg.vector_norm(w):.3e}"
        assert any(g.abs().max() > 0 for n, g in r["grads"].items()
                   if n.startswith("decoder.mlp_fine."))


def test_dp2_matches_dp1(jax_side, dp2, one_torch_thread):  # noqa: F811
    """Case 2: dp=2 against dp=1 on the same global batch: the loss, the
    all-reduced gradient (also against one process that forwards one scene
    at a time, as the ranks do), and the parameters after one AdamW update;
    the ranks hold the same bits."""
    cfg, weights, batch, _ = jax_side
    grads = []
    clip = state_mod.clip_by_global_norm_

    def recording_clip(gs, max_norm):
        grads.append([g.clone() for g in gs])
        return clip(gs, max_norm)

    forward = LaRaNet.forward

    def per_scene(self, batch, **kw):
        outs = [forward(self, {k: v[i:i + 1] for k, v in batch.items()}, **kw)
                for i in range(2)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(state_mod, "clip_by_global_norm_", recording_clip)
        net = _net(cfg, weights)
        want = make_train_step(net, TrainState(net, TRAIN, max_iters=10 ** 6, step=STEP),
                               with_fine=True)(batch)["loss"].item()
        first = _net(cfg, weights)
        make_train_step(first, TrainState(first, TRAIN, max_iters=100), with_fine=True)(batch)
        mp.setattr(LaRaNet, "forward", per_scene)
        split = _net(cfg, weights)
        make_train_step(split, TrainState(split, TRAIN, max_iters=10 ** 6, step=STEP),
                        with_fine=True)(batch)
    names = [n for n, _ in net.named_parameters()]
    want_g, split_g = dict(zip(names, grads[0])), dict(zip(names, grads[2]))
    worst = {"batch": 0.0, "split": 0.0}
    for r in dp2:
        assert abs(r["stats"]["loss"] - want) < 5e-4 * max(1.0, abs(want))
        for name in names:
            for key, ref, bar in (("batch", want_g, GRAD_RTOL), ("split", split_g, 1e-4)):
                err = torch.linalg.vector_norm(r["grads"][name] - ref[name]).item()
                rel = err / max(torch.linalg.vector_norm(ref[name]).item(), 1e-12)
                worst[key] = max(worst[key], rel)
                assert rel <= bar, f"{name}: relative L2 {rel:.3e} against the {key} reference"
        for name, p in first.named_parameters():
            np.testing.assert_allclose(r["first_update"][name].numpy(), p.detach().numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=name)
    print(f"largest relative L2 difference of a gradient, dp=2 against dp=1: "
          f"{worst['batch']:.3e}; against one process forwarding one scene at a time: "
          f"{worst['split']:.3e}")
    assert dp2[0]["stats"] == dp2[1]["stats"]
    for key in ("params", "first_update"):
        assert all(torch.equal(p, dp2[1][key][n]) for n, p in dp2[0][key].items())


def test_global_loss_is_not_the_mean_of_rank_losses(jax_side, dp2, one_torch_thread):  # noqa: F811
    """Case 3: MS-SSIM is a product of powers of batch means, so the mean
    of the two halves' losses is not the loss of the batch of 2; the
    global-statistics loss of dp=2 is."""
    cfg, weights, batch, _ = jax_side
    whole = _loss(cfg, weights, batch)
    halves = [_loss(cfg, weights, mesh.shard_batch(batch, r, 2)) for r in range(2)]
    print(f"B=2 loss {whole:.7f}, mean of the halves' {np.mean(halves):.7f}, "
          f"dp=2 {dp2[0]['stats']['loss']:.7f}")
    assert abs(np.mean(halves) - whole) > 1e-5, (halves, whole)
    np.testing.assert_allclose(dp2[0]["stats"]["loss"], whole, rtol=0, atol=1e-6)


def test_grad_accum_reduces_once_per_optimizer_step(dp2):
    """Case 4: two coarse micro-steps at grad_accum 2: one gradient
    all-reduce, on the second; no change after the first; the unreached
    fine MLP decayed by lr·weight_decay, equally on both ranks."""
    for r in dp2:
        acc = r["accum"]
        assert len(acc["grad_all_reduces"]) == 1
        s0, s1, s2 = acc["snapshots"]
        assert all(torch.equal(s0[n], s1[n]) for n in s0)
        assert not all(torch.equal(s0[n], s2[n]) for n in s0)
        w, bias = "decoder.mlp_fine.0.weight", "decoder.mlp_fine.0.bias"
        decay = 1.0 - acc["lr"] * TRAIN.weight_decay
        assert decay < 1.0 - 1e-6
        np.testing.assert_allclose(s2[w].numpy(), (s0[w] * decay).numpy(), rtol=1e-6)
        assert torch.equal(s2[bias], s0[bias])
    a, b = (r["accum"]["snapshots"][2] for r in dp2)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_loader_rank_slices_make_the_global_batches(tmp_path):
    """Case 5: each rank's batches of an epoch, side by side, are the
    one-process batches, the training split's random views and backgrounds
    included; a last batch that does not divide goes to rank 0 alone."""
    data = [{"x": np.full(2, i, np.float32), "meta": {"scene": str(i)}} for i in range(11)]
    for drop_last in (True, False):
        one = DataLoader(data, 4, shuffle=True, num_workers=0, seed=3, drop_last=drop_last)
        ranks = [DataLoader(data, 4, shuffle=True, num_workers=1, seed=3, drop_last=drop_last,
                            rank=r, world_size=2) for r in range(2)]
        for loader in (one, *ranks):
            loader.set_epoch(2)
        assert len(ranks[0]) == len(ranks[1]) == len(one) == (2 if drop_last else 3)
        for b, (want, x0, x1) in enumerate(zip(one, *ranks)):
            if b < 2:
                assert len(x0["meta"]) == len(x1["meta"]) == 2
                got = np.concatenate([x0["x"], x1["x"]])
                assert x0["meta"] + x1["meta"] == want["meta"]
            else:                  # 3 scenes over 2 ranks
                assert x1 == {"meta": []}
                got = x0["x"]
            np.testing.assert_array_equal(got, want["x"])
    with pytest.raises(ValueError, match="batch_size=3"):
        DataLoader(data, 3, rank=0, world_size=2)

    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=12, img_size=(32, 32))
    ds_cfg = _fit_config(store, str(tmp_path / "logs")).train_dataset

    def epoch(rank, world):
        loader = DataLoader(SyntheticDataset(ds_cfg), 2, shuffle=True, num_workers=1, seed=5,
                            rank=rank, world_size=world)
        loader.set_epoch(1)
        return list(loader)

    one, r0, r1 = epoch(0, 1), epoch(0, 2), epoch(1, 2)
    for want, x0, x1 in zip(one, r0, r1):
        assert x0["meta"] + x1["meta"] == want["meta"]
        for k in ("tar_rgb", "bg_color", "tar_c2w"):
            np.testing.assert_array_equal(np.concatenate([x0[k], x1[k]]), want[k], err_msg=k)


def _fit_config(store, logdir, **train):
    """tiny_config with 4 views on a 12-scene store at 32² (10 train scenes,
    5 global batches of 2; 2 held out); random 2-3 input views."""
    ds = JaxDatasetConfig(dataset_name="synthetic", data_root=store, split="train",
                          img_size=(32, 32), n_group=4, n_scenes=12, batch_size=2,
                          num_workers=0)
    base = dict(n_epoch=2, limit_train_batches=0.4, limit_val_batches=1.0, grad_accum=1,
                start_fine=1, ckpt_every_n_epoch=1, vis_every_n_steps=1, use_rand_views=True,
                warmup_iters=2, seed=5)
    base.update(train)
    cfg = dataclasses.replace(tiny_config(n_views=4), train_dataset=ds,
                              test_dataset=dataclasses.replace(ds, split="test"),
                              train=JaxTrainConfig(**base), logger=JaxLoggerConfig(dir=logdir))
    return config_from_dict(dataclasses.asdict(cfg))


def test_fit_on_two_ranks(tmp_path):
    """Case 6 (and case 5's views): a 2-rank fit, its resume, and a fit
    that rank 1 alone is asked to stop."""
    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=12, img_size=(32, 32))
    logs, stop = tmp_path / "logs", tmp_path / "stop"
    cfgs = [_fit_config(store, str(logs)), _fit_config(store, str(logs), n_epoch=3),
            _fit_config(store, str(stop), grad_accum=2, limit_train_batches=1.0,
                        vis_every_n_steps=0)]
    res = workers.run_ranks(workers.fit_body, 2, str(tmp_path / "ranks"), cfgs, 3)

    for i, (a, b) in enumerate(zip(res[0]["runs"], res[1]["runs"])):
        # the same micro-steps, views and fine gate; each rank its scenes
        assert [m[:4] for m in a["micro"]] == [m[:4] for m in b["micro"]], i
        assert all(len(m[4]) == 1 for m in a["micro"] + b["micro"])
        assert all(sa[4] != sb[4] for sa, sb in zip(a["micro"], b["micro"]))
        assert a["step"] == b["step"] and a["ckpt_epochs"] == b["ckpt_epochs"]
        assert all(torch.equal(p, b["params"][n]) for n, p in a["params"].items())
    run, resume, stopped = res[0]["runs"]
    assert [m[0] for m in run["micro"]] == [0, 0, 1, 1] and run["step"] == 4
    assert {m[2] for m in run["micro"]} <= {2, 3, None} and {m[3] for m in run["micro"]} == {
        False, True}
    assert run["val_epochs"] == [0, 1] and run["ckpt_epochs"] == [0, 1]
    assert [m[0] for m in resume["micro"]] == [2, 2] and resume["step"] == 6
    assert [m[1] for m in stopped["micro"]] == [0, 1, 2] and stopped["step"] == 3
    assert stopped["ckpt_epochs"] == [0] and stopped["val_epochs"] == []

    # rank 0 alone wrote: one logger per fit, panels, 2 + 1 + 1 checkpoints
    assert res[0]["wrote"]["loggers"] == 3 and res[0]["wrote"]["saves"] == 4
    assert res[0]["wrote"]["images"] > 0
    assert res[1]["wrote"] == {"loggers": 0, "images": 0, "saves": 0}
    assert ckpt.latest_step(str(logs / "ckpts")) == 6
    assert list((logs / "panels").glob("train_pred_rgb_fine_*.png"))
    scalars = [json.loads(x) for x in (logs / "scalars.jsonl").read_text().splitlines()]
    assert {d["step"] for d in scalars if d["tag"] == "val/loss"} == {0, 1, 2}
    # the open accumulation of the stopped run: the two ranks' sum
    saved = torch.load(ckpt.checkpoint_path(str(stop / "ckpts"), 3), weights_only=True)
    assert saved["step"] == 3 and len(saved["grads"]) == len(run["params"])

    for key, msg in res[0]["errors"].items():
        assert f"{key}.batch_size=3 does not divide by the world size 2" in msg
    assert set(res[0]["errors"]) == {"train_dataset", "test_dataset"}


def test_evaluate_on_two_ranks_matches_one(tmp_path, one_torch_thread):  # noqa: F811
    """Case 7: `evaluate.main` at batch_size 2 on two ranks against one
    process at batch_size 1; then `eval_all` under a launcher."""
    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=12, img_size=(64, 64))
    args = ["configs/synthetic.yaml", "infer_dataset.dataset_name=synthetic",
            f"infer_dataset.data_root={store}", "infer_dataset.img_size=[64,64]",
            "infer_dataset.num_workers=0", "--device", "cpu"]

    def out(tag):
        return [f"infer.save_folder={tmp_path / tag}", f"infer.metric_path={tmp_path / tag}_m"]

    want = evaluate.main(args + ["infer_dataset.batch_size=1", *out("one")],
                         dtype=torch.float32)
    res = workers.run_ranks(workers.eval_body, 2, str(tmp_path / "ranks"),
                            args + ["infer_dataset.batch_size=2", *out("two")])
    for r in res:
        assert r["metrics"] == res[0]["metrics"]
    got = res[0]["metrics"]
    assert got["scenes"] == want["scenes"] == ["scene_0000", "scene_0010"]
    diff = max(np.max(np.abs(np.subtract(got[k], want[k]))) for k in ("psnr", "ssim"))
    print(f"largest psnr / ssim difference, 2 ranks against 1: {diff:.3e}")
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=5e-3)
    with open(tmp_path / "two_m" / "synthetic.json") as f:
        assert json.load(f) == got
    assert sorted(os.listdir(tmp_path / "two")) == ["scene_0000.png", "scene_0010.png"]

    assert res[0]["eval_all"] == res[1]["eval_all"] == [0, 1, 0, 0]
    assert len(res[0]["calls"]) == len(res[1]["calls"]) == 4
    assert res[0]["printed"].count("+ ") == 4 and "gobjeverse failed with code 1" in \
        res[0]["printed"]
    assert res[1]["printed"] == ""


def test_maybe_initialize_distributed(monkeypatch, tmp_path):
    """Case 8: no launcher, no group; a launcher's environment without its
    address raises (no fallback to one process); a batch that does not
    divide raises. (A group already there: case 1's ranks.)"""
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize_distributed("cpu") is False
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size(), distributed.is_main()) == (0, 1, True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.maybe_initialize_distributed("cpu")
    assert not distributed.is_initialized()
    assert distributed.resolve_device("cuda") == torch.device("cuda", 1)
    assert distributed.resolve_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not divide by the world size 2"):
        mesh.shard_batch({"x": np.zeros(3), "meta": [0, 1, 2]}, 0, 2)
    assert mesh.shard_batch({"x": np.arange(4), "meta": list("abcd")}, 1, 2)["meta"] == ["c", "d"]
