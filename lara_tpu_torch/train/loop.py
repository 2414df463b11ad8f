"""Training loop, the counterpart of `lara_tpu/train/loop.py:Trainer`
(train_lightning.py + lightning/system.py), decision for decision:

  - `limit_train_batches` of the loader per epoch; optimizer steps =
    micro-steps / grad_accum, and `global_step` (the fine gate
    `global_step > start_fine` and the loss gates) counts optimizer steps;
  - `use_rand_views`: 2..min(4, n_views) input views per micro-step from
    `default_rng((seed, 17))`, encoded as a prefix (`n_views_sel`);
  - scalars every 10·grad_accum micro-steps, where `steps_per_sec` and
    `step_time_p50_s` leave out the first interval (the JAX package's
    compile interval; here the kernels' first launches and allocator warm-up);
  - panels every `vis_every_n_steps` optimizer steps;
  - validation on `limit_val_batches` at the end of every
    `check_val_every_n_epoch`-th epoch and always at the last;
  - a checkpoint every `ckpt_every_n_epoch` epochs and at the last, one on
    SIGTERM, and resume from `model.ckpt_path` or the newest checkpoint in
    `<logger.dir>/ckpts` at the saved epoch + 1.

The JAX trainer draws one batch through a separate loader to initialise its
parameters; the port's parameters exist when the net is built, so it
skips that batch. Scalars go to `<logger.dir>/scalars.jsonl` and panels to
`<logger.dir>/panels/*.png` always, and to tensorboardX or wandb
(`logger.name`) where the package is installed.

Data parallelism (`python -m torch.distributed.run --nproc_per_node=N -m
lara_tpu_torch.train ...`, or a process group the caller made): one
process per device, each on its slice of every global batch of
`train_dataset.batch_size` (and `test_dataset.batch_size`) scenes, which
must divide by the world size. Every rank draws the same views, holds the
global batch's loss and stats and, after each optimizer step, the same
parameters (`parallel/mesh.py`). Rank 0 alone builds the logger and writes
scalars, panels (of the global batch, gathered) and checkpoints; a SIGTERM
on any rank stops every rank at the same micro-step.

Tensor parallelism (`train.tp=K`, the JAX trainer's `make_mesh(n_tp=...)`):
the W ranks form a (dp = W / K, K) grid (`parallel/mesh.py:make_layout`,
which raises unless W divides by K). The batch sizes must divide by dp; the
K ranks of one dp index load the same scenes, take the first one's draws
of views and backgrounds (`tp.broadcast_batch`), and split the encode, the
volume transformer's groups and the render loop (`parallel/tp.py`), in the
train steps and in validation. Panels gather over dp only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List

import numpy as np
import torch

from lara_tpu_torch.config import Config
from lara_tpu_torch.data import DataLoader, device_prefetch, get_dataset
from lara_tpu_torch.eval.vis import vis_images, write_png
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.parallel.distributed import (any_rank, is_main, maybe_initialize_distributed,
                                                 resolve_device, world_size)
from lara_tpu_torch.parallel import tp
from lara_tpu_torch.parallel.mesh import (check_divides, gather_batch, make_layout,
                                          replicate_state)
from lara_tpu_torch.train import checkpoint as ckpt
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_eval_step, make_train_step


# the outputs `eval/vis.py:vis_images` reads (with "_fine" too)
VIS_KEYS = ("image", "depth", "rend_normal", "depth_normal")


class RunLogger:
    """Scalars as JSON lines (`{"tag", "value", "step"}`) in
    `<dir>/scalars.jsonl` and panels as `<dir>/panels/<tag>_<step>.png`,
    plus tensorboardX ("tensorboard", the default) or wandb ("wandb") as
    `logger.name` asks, where the package is installed; a missing package
    costs one printed line, not the run."""

    def __init__(self, cfg: Config, workdir: str):
        self.panel_dir = os.path.join(workdir, "panels")
        os.makedirs(self.panel_dir, exist_ok=True)
        self._scalars = open(os.path.join(workdir, "scalars.jsonl"), "a")
        self._tb = self._wandb = None
        if cfg.logger.name == "wandb":
            try:
                import wandb
            except ImportError:
                print("logger: wandb is not installed; trying tensorboardX")
            else:
                os.environ.setdefault("WANDB__SERVICE_WAIT", "600")  # train_lightning.py:54
                self._wandb = wandb.init(project="LaRa", name=cfg.exp_name, dir=workdir,
                                         config=dataclasses.asdict(cfg))
        if self._wandb is None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("logger: tensorboardX is not installed; scalars go to "
                      "scalars.jsonl and panels to panels/ only")
            else:
                self._tb = SummaryWriter(workdir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._scalars.write(json.dumps({"tag": tag, "value": float(value),
                                        "step": int(step)}) + "\n")
        self._scalars.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=int(step))

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        write_png(os.path.join(self.panel_dir, f"{tag.replace('/', '_')}_{step:07d}.png"),
                  img_hwc)
        if self._tb is not None:
            self._tb.add_image(tag, img_hwc.transpose(2, 0, 1), step)
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(img_hwc)}, step=int(step))

    def close(self) -> None:
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class Trainer:
    """`fit()` runs the schedule above on `device` (the CUDA device unless
    the caller asks for another; without one it raises). After a fit,
    `micro_log` holds one record per micro-step (epoch, scenes, with_fine,
    n_sel, seconds, loss, and under tensor parallelism the `tp.COUNTS` of
    its batch broadcast and step), `val_epochs` and `ckpt_epochs` what ran, and
    `loader_wait_s` / `fit_s` the seconds spent waiting on the loader and in
    the whole fit. Under a launcher (or in a process group the caller made)
    the trainer is one rank of a data-parallel run, and a `cuda` device
    without an index is `cuda:LOCAL_RANK`."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.workdir = cfg.logger.dir
        os.makedirs(self.workdir, exist_ok=True)
        self.device = resolve_device(device)
        maybe_initialize_distributed(self.device)
        self.layout = make_layout(cfg.train.tp)
        what = ("the world size" if self.layout.tp == 1
                else f"the data-parallel size (world size {world_size()} / train.tp)")
        for key in ("train_dataset", "test_dataset"):
            check_divides(getattr(cfg, key).batch_size, self.layout.dp, f"{key}.batch_size",
                          what)
        self.net = LaRaNet(cfg, device=self.device,
                           generator=torch.Generator().manual_seed(cfg.train.seed))
        self._preempted = False
        self._rv_rng = np.random.default_rng((cfg.train.seed, 17))
        self.micro_log: List[Dict] = []
        self.val_epochs: List[int] = []
        self.ckpt_epochs: List[int] = []
        self.loader_wait_s = self.fit_s = 0.0

    def _num_opt_steps(self, loader: DataLoader) -> int:
        """lightning/system.py:69-76: batches × epochs × limit_train_batches
        / grad_accum."""
        t = self.cfg.train
        per_epoch = int(len(loader) * t.limit_train_batches)
        return max(1, per_epoch * t.n_epoch // t.grad_accum)

    def _maybe_load_encoder(self) -> None:
        """Load a timm ViT state dict (`.npz`, or a file `torch.load` reads)
        into the encoder with a strict key check (the reference downloads
        the DINO weights, lightning/network.py:44). The port's ViT carries
        timm's parameter names, so no conversion is needed."""
        path = self.cfg.model.encoder_pretrained_path
        if not path:
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"model.encoder_pretrained_path {path} does not exist")
        if path.endswith(".npz"):
            with np.load(path) as z:
                state = {k: torch.from_numpy(z[k]) for k in z.files}
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
        self.net.img_encoder.model.load_state_dict(state, strict=True)
        print(f"loaded pretrained encoder from {path}")

    def _save(self, ckpt_dir: str, state: TrainState, epoch: int) -> None:
        ckpt.save_checkpoint(ckpt_dir, state, epoch)
        self.ckpt_epochs.append(epoch)

    def fit(self) -> Dict:
        cfg, t = self.cfg, self.cfg.train
        train_ds = get_dataset(cfg.train_dataset.dataset_name)(cfg.train_dataset)
        val_ds = get_dataset(cfg.test_dataset.dataset_name)(cfg.test_dataset)
        # the tp ranks of one dp index load the same samples
        shard = dict(rank=self.layout.dp_index, world_size=self.layout.dp)
        train_loader = DataLoader(train_ds, cfg.train_dataset.batch_size, shuffle=True,
                                  num_workers=cfg.train_dataset.num_workers, seed=t.seed,
                                  **shard)
        val_loader = DataLoader(val_ds, cfg.test_dataset.batch_size, shuffle=False,
                                num_workers=cfg.test_dataset.num_workers, **shard)
        state = TrainState(self.net, t, self._num_opt_steps(train_loader))
        self._maybe_load_encoder()
        self.state = state

        start_epoch = 0
        ckpt_dir = os.path.join(self.workdir, "ckpts")
        resume_from = cfg.model.ckpt_path or (
            ckpt_dir if ckpt.latest_step(ckpt_dir) is not None else None)
        if resume_from:
            start_epoch = ckpt.restore_checkpoint(resume_from, state) + 1
        replicate_state(state)

        logger = RunLogger(cfg, self.workdir) if is_main() else None
        previous = self._install_preemption_handler()
        t_fit = time.perf_counter()
        try:
            with tp.enabled_for(self.layout):
                return self._fit(state, train_loader, val_loader, start_epoch, ckpt_dir,
                                 logger)
        finally:
            self.fit_s = time.perf_counter() - t_fit
            if logger is not None:
                logger.close()
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _install_preemption_handler(self):
        """Checkpoint on SIGTERM (preemption); returns the handler it
        replaced, or None off the main thread, where none can be set."""
        def handler(signum, frame):
            self._preempted = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None

    def _fit(self, state, train_loader, val_loader, start_epoch, ckpt_dir, logger) -> Dict:
        cfg, t = self.cfg, self.cfg.train
        steps: Dict = {}

        def get_step(with_fine: bool, n_sel):
            if (with_fine, n_sel) not in steps:
                steps[with_fine, n_sel] = make_train_step(
                    self.net, state, with_fine, t.grad_accum, n_views_sel=n_sel)
            return steps[with_fine, n_sel]

        eval_steps = {f: make_eval_step(self.net, with_fine=f) for f in (False, True)}
        batches_per_epoch = max(1, int(len(train_loader) * t.limit_train_batches))
        micro = int(state.step)
        t_warm, micro_warm, t_prev = None, micro, None
        step_times: list = []
        last_stats: Dict = {}
        cuda = self.device.type == "cuda"

        for epoch in range(start_epoch, t.n_epoch):
            train_loader.set_epoch(epoch)
            batches = device_prefetch(iter(train_loader), self.device)
            try:
                for _ in range(batches_per_epoch):
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    self.loader_wait_s += time.perf_counter() - t0
                    if batch is None:
                        break
                    counts = dict(tp.COUNTS)
                    batch = tp.broadcast_batch(batch)
                    global_step = micro // t.grad_accum
                    sb = {k: v for k, v in batch.items() if k != "meta"}
                    n_sel = None
                    if t.use_rand_views:
                        # random 2-4 input views (lightning/network.py:434-438),
                        # as a prefix: the loader shuffles view order
                        n_sel = int(self._rv_rng.integers(2, min(4, cfg.n_views) + 1))
                        if n_sel == cfg.n_views:
                            n_sel = None
                    with_fine = global_step > t.start_fine
                    t0 = time.perf_counter()
                    stats = get_step(with_fine, n_sel)(sb)
                    if cuda:
                        # the micro-step's own time; the step is host-bound
                        # (PERF.md §5), so the wait costs the device little
                        torch.cuda.synchronize(self.device)
                    self.micro_log.append({
                        "epoch": epoch, "micro": micro, "with_fine": with_fine,
                        "n_sel": n_sel, "scenes": [m["scene"] for m in batch["meta"]],
                        "seconds": time.perf_counter() - t0, "loss": float(stats["loss"])})
                    if tp.enabled():
                        self.micro_log[-1]["tp"] = {k: v - counts[k]
                                                    for k, v in tp.COUNTS.items()}
                    micro += 1
                    if micro % (10 * t.grad_accum) == 0:
                        last_stats = {k: float(v) for k, v in stats.items()}
                        now = time.perf_counter()
                        if t_warm is None:
                            t_warm, micro_warm = now, micro
                        else:
                            last_stats["steps_per_sec"] = (micro - micro_warm) / (now - t_warm)
                            step_times.append((now - t_prev) / (10 * t.grad_accum))
                            last_stats["step_time_p50_s"] = float(np.median(step_times))
                        t_prev = now
                        for k, v in last_stats.items():
                            if logger is not None:
                                logger.add_scalar(f"train/{k}", v, global_step)
                    if t.vis_every_n_steps and global_step > 0 and \
                            micro % (t.vis_every_n_steps * t.grad_accum) == 0:
                        out, _ = eval_steps[with_fine](sb, global_step)
                        self._log_panels(logger, out, batch, global_step, "train")
                    # every rank leaves at the same micro-step, or one would
                    # wait in the next collective for ever
                    if any_rank(self._preempted, self.device):
                        self._save(ckpt_dir, state, epoch)
                        if is_main():
                            print(f"[preempt] checkpoint saved at step {state.step}")
                        return last_stats
            finally:
                batches.close()

            last = epoch == t.n_epoch - 1
            ckpt_due = bool(t.ckpt_every_n_epoch) and (epoch + 1) % t.ckpt_every_n_epoch == 0
            if (epoch + 1) % max(1, t.check_val_every_n_epoch) != 0 and not last:
                if ckpt_due:
                    self._save(ckpt_dir, state, epoch)
                continue
            self._validate(state, val_loader, micro, epoch, eval_steps, logger)
            if ckpt_due or last:
                self._save(ckpt_dir, state, epoch)
        return last_stats

    def _validate(self, state, val_loader, micro, epoch, eval_steps, logger) -> None:
        """lightning/system.py:38-52 on `limit_val_batches` of the loader;
        the mean of each stat goes to `val/<stat>` at the epoch."""
        t = self.cfg.train
        val_batches = max(1, int(len(val_loader) * t.limit_val_batches))
        global_step = micro // t.grad_accum
        efn = eval_steps[global_step > t.start_fine]
        agg: Dict[str, list] = {}
        batches = device_prefetch(iter(val_loader), self.device)
        try:
            for j in range(val_batches):
                batch = next(batches, None)
                if batch is None:
                    break
                batch = tp.broadcast_batch(batch)
                out, stats = efn({k: v for k, v in batch.items() if k != "meta"},
                                 global_step)
                if j == 0:
                    self._log_panels(logger, out, batch, global_step, "val")
                for k, v in stats.items():
                    agg.setdefault(k, []).append(float(v))
        finally:
            batches.close()
        for k, vs in agg.items():
            if logger is not None:
                logger.add_scalar(f"val/{k}", float(np.mean(vs)), epoch)
        self.val_epochs.append(epoch)

    @staticmethod
    def _log_panels(logger, out, batch, step: int, prefix: str) -> None:
        """The panels of the global batch (every dp rank's slice, gathered
        over the dp group: a collective, so every rank calls it), written
        where `logger` is not None (rank 0)."""
        group = tp.dp_group()
        host_out = {k: gather_batch(v, group).float().cpu().numpy() for k, v in out.items()
                    if isinstance(v, torch.Tensor) and k.startswith(VIS_KEYS)}
        host_batch = {"tar_rgb": gather_batch(batch["tar_rgb"], group).float().cpu().numpy()}
        if logger is None:
            return
        for key, value in vis_images(host_out, host_batch).items():
            b, h, w = value.shape[:3]
            logger.add_image(f"{prefix}/{key}", np.clip(value.reshape(b * h, w, 3), 0, 1),
                             step)
