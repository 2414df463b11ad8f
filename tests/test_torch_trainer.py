"""The port's training loop and entry against the JAX package's.

- The schedule: both trainers run with their train and eval steps replaced
  by recorders (`monkeypatch`; no JAX step compiles, nothing in `lara_tpu`
  is edited) on the same synthetic scenes. Both must show the same scenes
  per micro-step, the same (fine stage on, views selected) per micro-step,
  the same validation, checkpoint, panel and scalar-log steps, and the same
  final step. Exact: these are integer decisions.
- A real fit of the port on the tiny config: the port of
  tests/test_train.py:test_fit_truncated_epoch_still_validates_and_checkpoints,
  then a resume; a checkpoint on SIGTERM between micro-steps; loggers that
  are missing; encoder weights from a timm state dict.
- `python -m lara_tpu_torch.train configs/synthetic.yaml --device cpu` in a
  subprocess, to its end, and again to resume.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import lara_tpu.data.gobjverse as jax_gobjverse
import lara_tpu.parallel.mesh as jax_mesh
import lara_tpu.train.loop as jax_loop
import lara_tpu.train.step as jax_step
import lara_tpu_torch.data.gobjverse as torch_gobjverse
import lara_tpu_torch.train.loop as torch_loop
from lara_tpu.config import Config as JaxConfig
from lara_tpu.config import DatasetConfig as JaxDatasetConfig
from lara_tpu.config import LoggerConfig as JaxLoggerConfig
from lara_tpu.config import TrainConfig as JaxTrainConfig
from lara_tpu.data.synthetic import write_synthetic_h5
from lara_tpu_torch.config import config_from_dict
from lara_tpu_torch.data import write_synthetic_store
from lara_tpu_torch.train import checkpoint as ckpt
from tests.test_model import tiny_config
from tests.test_torch_blend import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same 12 scenes at 32² as an HDF5 shard (JAX) and a store (port)."""
    d = tmp_path_factory.mktemp("trainer")
    return (write_synthetic_h5(str(d / "syn.h5"), n_scenes=12, img_size=(32, 32)),
            write_synthetic_store(str(d / "syn"), n_scenes=12, img_size=(32, 32)))


def schedule_config(data_root: str, logdir: str) -> JaxConfig:
    """4 input views with use_rand_views; 10 train scenes at B=2, 4 of the
    5 batches per epoch, 5 epochs at grad_accum 2 (20 micro-steps, the
    scalar log at the last); the fine stage after optimizer step 3;
    validation every 3rd epoch and at the last, checkpoints every 2nd and
    at the last, panels every 2 optimizer steps."""
    ds = JaxDatasetConfig(dataset_name="synthetic", data_root=data_root, split="train",
                          img_size=(32, 32), n_group=4, n_scenes=12, batch_size=2,
                          num_workers=0)
    return dataclasses.replace(
        tiny_config(n_views=4), train_dataset=ds,
        test_dataset=dataclasses.replace(ds, split="test", batch_size=1),
        train=JaxTrainConfig(n_epoch=5, limit_train_batches=0.8, limit_val_batches=0.5,
                             check_val_every_n_epoch=3, ckpt_every_n_epoch=2, start_fine=3,
                             use_rand_views=True, grad_accum=2, vis_every_n_steps=2,
                             warmup_iters=2, seed=5),
        logger=JaxLoggerConfig(dir=logdir))


def _tag_scenes(monkeypatch, module):
    """Samples carry their scene's number as an array, which reaches the
    train step in the batch."""
    orig = module.GObjaverseDataset.__getitem__

    def getitem(self, index):
        out = orig(self, index)
        out["scene_no"] = np.int64(int(str(self.scenes_name[index]).split("_")[-1]))
        return out

    monkeypatch.setattr(module.GObjaverseDataset, "__getitem__", getitem)


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step)))


def run_jax_schedule(cfg, monkeypatch) -> dict:
    rec = {"micro": [], "panels": [], "ckpts": []}
    _tag_scenes(monkeypatch, jax_gobjverse)
    writer = _Writer()

    class State:
        def __init__(self, step=0):
            self.step, self.params, self.opt_state = step, None, None

    def make_train_step(net, mesh, with_fine, grad_accum=1, n_views_sel=None):
        def step(state, batch):
            rec["micro"].append((list(np.asarray(batch["scene_no"])), with_fine, n_views_sel))
            return State(state.step + 1), {"loss": 0.0}
        return step

    def make_eval_step(net, mesh, with_fine=True):
        return lambda params, batch, step: ({}, {"loss": 0.0})

    monkeypatch.setattr(jax_loop, "make_mesh",
                        lambda n_tp=1: jax_mesh.make_mesh(devices=jax.devices()[:1]))
    monkeypatch.setattr(jax_loop.Trainer, "init_state", lambda self, s, m: State())
    monkeypatch.setattr(jax_loop, "make_train_step", make_train_step)
    monkeypatch.setattr(jax_loop, "make_eval_step", make_eval_step)
    monkeypatch.setattr(jax_step, "make_eval_step", make_eval_step)
    monkeypatch.setattr(jax_loop.Trainer, "writer", property(lambda self: writer))
    monkeypatch.setattr(jax_loop.Trainer, "_log_panels",
                        lambda self, out, batch, step, prefix: rec["panels"].append(
                            (prefix, int(step))))
    monkeypatch.setattr(jax_loop.ckpt, "save_checkpoint",
                        lambda d, step, state, epoch: rec["ckpts"].append((step, epoch)))
    tr = jax_loop.Trainer(cfg)
    tr.fit()
    rec["final_step"] = int(tr.state.step)
    rec["scalars"] = writer.scalars
    return rec


def run_torch_schedule(cfg, monkeypatch) -> dict:
    rec = {"micro": [], "panels": [], "ckpts": []}
    _tag_scenes(monkeypatch, torch_gobjverse)

    def make_train_step(net, state, with_fine, grad_accum=1, n_views_sel=None):
        def step(batch):
            rec["micro"].append((batch["scene_no"].tolist(), with_fine, n_views_sel))
            state.step += 1
            return {"loss": torch.tensor(0.0)}
        return step

    def make_eval_step(net, with_fine=True):
        return lambda batch, step: ({}, {"loss": torch.tensor(0.0)})

    def save_checkpoint(d, state, epoch):
        rec["ckpts"].append((state.step, epoch))

    monkeypatch.setattr(torch_loop, "make_train_step", make_train_step)
    monkeypatch.setattr(torch_loop, "make_eval_step", make_eval_step)
    monkeypatch.setattr(torch_loop.Trainer, "_log_panels",
                        staticmethod(lambda logger, out, batch, step, prefix:
                                     rec["panels"].append((prefix, int(step)))))
    monkeypatch.setattr(torch_loop.ckpt, "save_checkpoint", save_checkpoint)
    tr = torch_loop.Trainer(cfg, device="cpu")
    tr.fit()
    rec["final_step"] = tr.state.step
    with open(os.path.join(cfg.logger.dir, "scalars.jsonl")) as f:
        rec["scalars"] = [(d["tag"], d["step"]) for d in map(json.loads, f)]
    rec["trainer"] = tr
    return rec


def test_schedule_matches_jax_trainer(stores, tmp_path, monkeypatch):
    h5, npy = stores
    jcfg = schedule_config(h5, str(tmp_path / "jax"))
    tcfg = config_from_dict(dataclasses.asdict(schedule_config(npy, str(tmp_path / "torch"))))
    tcfg = dataclasses.replace(tcfg, train_dataset=dataclasses.replace(
        tcfg.train_dataset, num_workers=1))
    want = run_jax_schedule(jcfg, monkeypatch)
    got = run_torch_schedule(tcfg, monkeypatch)

    assert len(want["micro"]) == 20 and want["final_step"] == 20
    assert got["micro"] == want["micro"]
    assert got["final_step"] == want["final_step"]
    assert got["ckpts"] == want["ckpts"] == [(8, 1), (16, 3), (20, 4)]
    assert got["panels"] == want["panels"]
    assert got["scalars"] == want["scalars"]
    val_epochs = sorted({s for t, s in want["scalars"] if t.startswith("val/")})
    assert val_epochs == got["trainer"].val_epochs == [2, 4]
    # the schedule's branches were all taken
    assert {f for _, f, _ in want["micro"]} == {False, True}
    assert {n for _, _, n in want["micro"]} == {2, 3, None}
    assert ("train/loss", 9) in want["scalars"]   # micro-step 20, optimizer step 9


def tiny_run_config(root: str, logdir: str, **train):
    """The tiny model on 16 synthetic scenes at 64² (15 train, 7 batches of
    2), truncated to 1 batch per epoch by limit_train_batches 0.15, as
    tests/test_train.py:141 is at its dp=8 batch."""
    ds = JaxDatasetConfig(dataset_name="synthetic", data_root=root, split="train",
                          img_size=(64, 64), n_group=2, n_scenes=16, batch_size=2,
                          num_workers=0)
    base = dict(n_epoch=2, limit_train_batches=0.15, limit_val_batches=0.05, grad_accum=1,
                start_fine=10 ** 9, ckpt_every_n_epoch=1, vis_every_n_steps=0,
                warmup_iters=2)
    base.update(train)
    cfg = dataclasses.replace(tiny_config(), train_dataset=ds, test_dataset=ds,
                              train=JaxTrainConfig(**base),
                              logger=JaxLoggerConfig(dir=logdir))
    return config_from_dict(dataclasses.asdict(cfg))


def test_fit_truncated_epoch_still_validates_and_checkpoints(tmp_path, one_torch_thread):  # noqa: F811
    """A truncated epoch still validates and checkpoints (the round-1 bug of
    the JAX loop), and a second run resumes after the saved epoch."""
    cfg = tiny_run_config(str(tmp_path / "syn"), str(tmp_path / "logs"))
    tr = torch_loop.Trainer(cfg, device="cpu")
    stats = tr.fit()
    assert tr.state.step == 2 and len(tr.micro_log) == 2
    assert tr.val_epochs == [0, 1] and tr.ckpt_epochs == [0, 1]
    assert ckpt.latest_step(str(tmp_path / "logs" / "ckpts")) == 2
    assert stats == {}                     # no scalar interval completed
    vals = [json.loads(x) for x in
            (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert {(v["tag"], v["step"]) for v in vals} >= {("val/loss", 0), ("val/loss", 1)}
    assert all(np.isfinite(v["value"]) for v in vals)
    assert list((tmp_path / "logs" / "panels").glob("val_pred_rgb_*.png"))

    cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, n_epoch=3))
    tr = torch_loop.Trainer(cfg3, device="cpu")
    tr.fit()
    assert [m["epoch"] for m in tr.micro_log] == [2] and tr.state.step == 3
    assert tr.val_epochs == [2] and ckpt.latest_step(str(tmp_path / "logs" / "ckpts")) == 3


def test_sigterm_checkpoints_between_micro_steps(stores, tmp_path, monkeypatch):
    """SIGTERM during micro-step 3 of a grad_accum-2 run: the fit saves a
    checkpoint at step 3, with the open accumulation's gradients, and
    returns."""
    _, npy = stores
    cfg = tiny_run_config(npy, str(tmp_path / "logs"), grad_accum=2, limit_train_batches=1.0,
                          n_epoch=3)
    cfg = dataclasses.replace(cfg, train_dataset=dataclasses.replace(
        cfg.train_dataset, img_size=(32, 32), n_scenes=12))

    def make_train_step(net, state, with_fine, grad_accum=1, n_views_sel=None):
        def step(batch):
            p = next(net.parameters())
            p.grad = torch.full_like(p, float(state.step + 1))
            state.step += 1
            if state.step == 3:
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return {"loss": torch.tensor(0.0)}
        return step

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(torch_loop, "make_train_step", make_train_step)
    tr = torch_loop.Trainer(cfg, device="cpu")
    tr.fit()
    assert signal.getsignal(signal.SIGTERM) == before      # restored
    assert tr.state.step == 3 and tr.ckpt_epochs == [0] and tr.val_epochs == []
    saved = torch.load(ckpt.checkpoint_path(str(tmp_path / "logs" / "ckpts"), 3),
                       weights_only=True)
    assert saved["step"] == 3 and saved["epoch"] == 0
    (name, grad), = saved["grads"].items()
    assert torch.equal(grad, torch.full_like(grad, 3.0))


def test_missing_loggers_print_one_line(tmp_path, monkeypatch, capsys):
    cfg = tiny_run_config(str(tmp_path / "syn"), str(tmp_path / "logs"))
    for name in ("tensorboard", "wandb"):
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        monkeypatch.setitem(sys.modules, "wandb", None)
        c = dataclasses.replace(cfg, logger=dataclasses.replace(cfg.logger, name=name))
        logger = torch_loop.RunLogger(c, str(tmp_path / name))
        logger.add_scalar("train/loss", 0.5, 3)
        logger.add_image("val/pred_rgb", np.zeros((4, 6, 3), np.float32), 3)
        logger.close()
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-1].startswith("logger: tensorboardX is not installed")
        assert len(lines) == (2 if name == "wandb" else 1)
        assert json.loads((tmp_path / name / "scalars.jsonl").read_text()) == {
            "tag": "train/loss", "value": 0.5, "step": 3}
        assert (tmp_path / name / "panels" / "val_pred_rgb_0000003.png").exists()


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_encoder_weights_load(tmp_path, fmt):
    """model.encoder_pretrained_path: a timm-named state dict written by the
    test loads into the ViT with a strict key check."""
    cfg = tiny_run_config(str(tmp_path / "syn"), str(tmp_path / "logs"))
    tr = torch_loop.Trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    state = {k: torch.randn(v.shape, generator=g)
             for k, v in tr.net.img_encoder.model.state_dict().items()}
    assert "blocks.0.attn.qkv.weight" in state and "patch_embed.proj.weight" in state
    path = str(tmp_path / f"dino.{fmt}")

    def write(sd):
        if fmt == "npz":
            np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        else:
            torch.save(sd, path)

    write(state)
    with_path = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder_pretrained_path=path))
    tr = torch_loop.Trainer(with_path, device="cpu")
    tr._maybe_load_encoder()
    got = tr.net.img_encoder.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items())

    del state["norm.weight"]
    write(state)
    with pytest.raises(RuntimeError, match="norm.weight"):
        torch_loop.Trainer(dataclasses.replace(with_path), device="cpu")._maybe_load_encoder()
    missing = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder_pretrained_path=str(tmp_path / "none.pt")))
    with pytest.raises(FileNotFoundError):
        torch_loop.Trainer(missing, device="cpu")._maybe_load_encoder()


def test_trainer_runs_on_the_card_unless_asked(tmp_path):
    cfg = tiny_run_config(str(tmp_path / "syn"), str(tmp_path / "logs"))
    if not torch.cuda.is_available():
        from lara_tpu_torch.train.__main__ import main

        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["configs/synthetic.yaml"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_loop.Trainer(cfg)


def test_cli_trains_to_its_end_and_resumes(stores, tmp_path):
    """The entry in a subprocess on configs/synthetic.yaml: 2 micro-steps,
    validation, a checkpoint, scalars and panels; then a resume for one
    more epoch."""
    _, npy = stores
    args = [sys.executable, "-m", "lara_tpu_torch.train", "configs/synthetic.yaml",
            "--device", "cpu", f"train_dataset.data_root={npy}",
            f"test_dataset.data_root={npy}", "train_dataset.img_size=[32,32]",
            "test_dataset.img_size=[32,32]", "train_dataset.n_scenes=12",
            "test_dataset.n_scenes=12", "train_dataset.num_workers=1",
            "train.limit_train_batches=0.4", "train.vis_every_n_steps=1",
            f"logger.dir={tmp_path / 'logs'}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for n_epoch, step in ((1, 2), (2, 4)):
        out = subprocess.run(args + [f"train.n_epoch={n_epoch}"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "training finished in" in out.stdout.splitlines()[-1]
        assert ckpt.latest_step(str(tmp_path / "logs" / "ckpts")) == step
    vals = [json.loads(x) for x in
            (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert {v["step"] for v in vals if v["tag"] == "val/psnr"} == {0, 1}
    assert all(np.isfinite(v["value"]) for v in vals)
    panels = {p.name for p in (tmp_path / "logs" / "panels").glob("*.png")}
    assert {"train_pred_rgb_0000001.png", "train_pred_rgb_0000003.png",
            "val_pred_rgb_0000002.png", "val_pred_rgb_0000004.png"} <= panels
