"""Rank bodies for tests/test_torch_parallel.py, in a module of their own
that imports neither JAX nor the JAX package: `torch.multiprocessing.spawn`
imports it afresh in every rank. Each rank brings its own gloo group
(`file://` rendezvous), runs its body on the CPU and saves the body's
result for the parent."""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(body, world: int, tmp: str, *args) -> list:
    """body(rank, world, *args) in `world` spawned processes of one gloo
    group; returns their results in rank order."""
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(body, world, tmp, args), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, body, world, tmp, args):
    torch.set_num_threads(1)
    # a rank that fails before its first collective leaves the others
    # waiting: a minute, not the default half hour
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(body(rank, world, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _net(cfg, weights):
    from lara_tpu_torch.models import LaRaNet

    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(weights, strict=True)
    return net


@contextlib.contextmanager
def _counting_all_reduces(counts: list):
    """Count the all-reduces of more than one element (the gradients'; the
    loss's global means are scalars)."""
    orig = dist.all_reduce

    def all_reduce(t, *a, **kw):
        if t.numel() > 1:
            counts.append(t.numel())
        return orig(t, *a, **kw)

    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        dist.all_reduce = orig


def step_body(rank, world, cfg, weights, batch, train_cfg, step):
    """One fine micro-step (grad_accum 1) from optimizer step `step` on this
    rank's slice of `batch`, one from step 0, then two coarse micro-steps at
    grad_accum 2. Returns the loss and stats and the all-reduced gradient
    before the clip of the first, the parameters after each update and the
    gradient all-reduces of the last two."""
    from lara_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from lara_tpu_torch.parallel.mesh import shard_batch
    from lara_tpu_torch.train import state as state_mod
    from lara_tpu_torch.train.state import TrainState
    from lara_tpu_torch.train.step import make_train_step

    res = {"group_found": maybe_initialize_distributed("cpu")}
    local = shard_batch(batch, rank, world)
    clip = state_mod.clip_by_global_norm_
    grads = []

    def recording_clip(gs, max_norm):
        grads.append([g.clone() for g in gs])
        return clip(gs, max_norm)

    state_mod.clip_by_global_norm_ = recording_clip
    try:
        net = _net(cfg, weights)
        state = TrainState(net, train_cfg, max_iters=10 ** 6, step=step)
        stats = make_train_step(net, state, with_fine=True)(local)
        names = [n for n, _ in net.named_parameters()]
        res["stats"] = {k: v.item() for k, v in stats.items()}
        res["grads"] = dict(zip(names, grads[0]))
        res["params"] = {n: p.detach().clone() for n, p in net.named_parameters()}

        # the first update of the schedule, as tests/test_train.py:110 takes it
        net = _net(cfg, weights)
        make_train_step(net, TrainState(net, train_cfg, max_iters=100), with_fine=True)(local)
        res["first_update"] = {n: p.detach().clone() for n, p in net.named_parameters()}

        # grad_accum 2, coarse: mlp_fine is not reached
        net = _net(cfg, weights)
        acc = dataclasses.replace(train_cfg, grad_accum=2)
        state = TrainState(net, acc, max_iters=10 ** 6, step=2 * step)
        coarse = make_train_step(net, state, with_fine=False, grad_accum=2)
        snap = [{n: p.detach().clone() for n, p in net.named_parameters()}]
        counts: list = []
        with _counting_all_reduces(counts):
            for _ in range(2):
                coarse(local)
                snap.append({n: p.detach().clone() for n, p in net.named_parameters()})
        res["accum"] = {"snapshots": snap, "grad_all_reduces": counts,
                        "lr": state.schedule(state.opt_step - 1)}
    finally:
        state_mod.clip_by_global_norm_ = clip
    return res


def fit_body(rank, world, cfgs, preempt_step):
    """Three fits of `train/loop.py:Trainer`: cfgs[0], cfgs[1] (its resume)
    and cfgs[2], in which rank 1 alone sets the SIGTERM flag after
    micro-step `preempt_step`. Returns what each fit ran and what this rank
    wrote."""
    from lara_tpu_torch.train import checkpoint as ckpt
    from lara_tpu_torch.train import loop

    wrote = {"loggers": 0, "images": 0, "saves": 0}
    logger_init, add_image, write = loop.RunLogger.__init__, loop.RunLogger.add_image, \
        ckpt._write

    def counting(key, fn):
        def run(*a, **kw):
            wrote[key] += 1
            return fn(*a, **kw)
        return run

    loop.RunLogger.__init__ = counting("loggers", logger_init)
    loop.RunLogger.add_image = counting("images", add_image)
    ckpt._write = counting("saves", write)
    runs = []
    try:
        for i, cfg in enumerate(cfgs):
            tr = loop.Trainer(cfg, device="cpu")
            if i == 2 and rank == 1:
                make = loop.make_train_step

                def make_train_step(net, state, *a, **kw):
                    step = make(net, state, *a, **kw)

                    def run(batch):
                        out = step(batch)
                        if state.step == preempt_step:
                            tr._preempted = True
                        return out
                    return run

                loop.make_train_step = make_train_step
            try:
                tr.fit()
            finally:
                if i == 2 and rank == 1:
                    loop.make_train_step = make
            runs.append({"micro": [(m["epoch"], m["micro"], m["n_sel"], m["with_fine"],
                                    m["scenes"]) for m in tr.micro_log],
                         "val_epochs": tr.val_epochs, "ckpt_epochs": tr.ckpt_epochs,
                         "step": tr.state.step,
                         "params": {n: p.detach().clone()
                                    for n, p in tr.net.named_parameters()}})
        errors = {}
        for key in ("train_dataset", "test_dataset"):
            bad = dataclasses.replace(cfgs[0], **{key: dataclasses.replace(
                getattr(cfgs[0], key), batch_size=3)})
            try:
                loop.Trainer(bad, device="cpu")
            except ValueError as e:
                errors[key] = str(e)
    finally:
        loop.RunLogger.__init__, loop.RunLogger.add_image = logger_init, add_image
        ckpt._write = write
    return {"runs": runs, "wrote": wrote, "errors": errors}


def eval_body(rank, world, args):
    """`evaluate.main(args)` on this rank, then `eval_all.main` under a
    launcher's environment with `evaluate.main` replaced by a recorder
    that fails the second benchmark. Returns the metrics, the recorded
    arguments, eval_all's codes and what this rank printed."""
    from lara_tpu_torch import eval_all, evaluate

    metrics = evaluate.main(args, dtype=torch.float32)
    calls = []

    def recorder(a):
        calls.append(a)
        if len(calls) == 2:
            raise FileNotFoundError("no such benchmark data")

    out = io.StringIO()
    main, os.environ["WORLD_SIZE"] = evaluate.main, str(world)
    evaluate.main = recorder
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            codes = eval_all.main(["logs/run/ckpts", "--device", "cpu"])
    finally:
        evaluate.main = main
        del os.environ["WORLD_SIZE"]
    return {"metrics": metrics, "eval_all": codes, "calls": calls, "printed": out.getvalue()}


@contextlib.contextmanager
def _recording_clip(grads: list):
    """Record each clipped gradient list (the all-reduced gradient of an
    optimizer step, before the clip) in `grads`."""
    from lara_tpu_torch.train import state as state_mod

    clip = state_mod.clip_by_global_norm_

    def recording_clip(gs, max_norm):
        grads.append([g.clone() for g in gs])
        return clip(gs, max_norm)

    state_mod.clip_by_global_norm_ = recording_clip
    try:
        yield
    finally:
        state_mod.clip_by_global_norm_ = clip


@contextlib.contextmanager
def _forward_marks(marks: list, counts: list):
    """Append (all-reduces so far, `tp.COUNTS`) to `marks` at the end of each
    forward of a train step (`compute_losses` returns)."""
    from lara_tpu_torch.parallel import tp
    from lara_tpu_torch.train import step as step_mod

    losses = step_mod.compute_losses

    def marked(*a, **kw):
        out = losses(*a, **kw)
        marks.append((len(counts), dict(tp.COUNTS)))
        return out

    step_mod.compute_losses = marked
    try:
        yield
    finally:
        step_mod.compute_losses = losses


def _counted_step(net, state, local, with_fine: bool) -> dict:
    """One micro-step of `make_train_step` at grad_accum 1 with its
    collectives counted: the all-reduces of more than one element and
    `tp.COUNTS` at the end of the forward and of the step."""
    from lara_tpu_torch.parallel import tp
    from lara_tpu_torch.train.step import make_train_step

    counts, marks = [], []
    tp.reset_counts()
    with _counting_all_reduces(counts), _forward_marks(marks, counts):
        stats = make_train_step(net, state, with_fine=with_fine)(local)
    (fwd_reduces, fwd), = marks
    return {"stats": {k: v.item() for k, v in stats.items()}, "all_reduces": len(counts),
            "forward_all_reduces": fwd_reduces, "forward": fwd, "step": dict(tp.COUNTS)}


def tp_body(rank, world, tp_size, cfg, weights, batch, train_cfg, step, extra=False):
    """At train.tp=`tp_size` on this world: one fine micro-step (grad_accum
    1) from optimizer step `step` on this dp index's slice of `batch`, then
    one coarse micro-step, each with its collectives counted; the fine
    step's loss, stats, all-reduced gradient and the parameters after its
    update; the warnings of the forwards. With `extra`, also the same two
    micro-steps at tp=1 (counted) and the split / gather pair on a small
    function (`split_gather_grads`)."""
    import warnings

    from lara_tpu_torch.parallel import tp
    from lara_tpu_torch.parallel.mesh import make_layout, shard_batch
    from lara_tpu_torch.train.state import TrainState

    layout = make_layout(tp_size)
    res = {"layout": (layout.dp, layout.tp, layout.dp_index, layout.tp_index)}
    local = shard_batch(batch, layout.dp_index, layout.dp)
    grads: list = []
    with tp.enabled_for(layout), _recording_clip(grads), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        net = _net(cfg, weights)
        state = TrainState(net, train_cfg, max_iters=10 ** 6, step=step)
        res["fine"] = _counted_step(net, state, local, True)
        res["params"] = {n: p.detach().clone() for n, p in net.named_parameters()}
        res["coarse"] = _counted_step(net, state, local, False)
    res["warnings"] = [(w.category.__name__, str(w.message)) for w in caught]
    names = [n for n, _ in net.named_parameters()]
    res["grads"] = dict(zip(names, grads[0]))
    if extra:
        one = make_layout(1)
        with tp.enabled_for(one):
            local = shard_batch(batch, one.dp_index, one.dp)
            net = _net(cfg, weights)
            state = TrainState(net, train_cfg, max_iters=10 ** 6, step=step)
            res["tp1"] = {"fine": _counted_step(net, state, local, True),
                          "coarse": _counted_step(net, state, local, False)}
        with tp.enabled_for(layout):
            res["split_gather"] = split_gather_grads(7)
            res["broadcast"] = broadcast_batch_of(layout)
        # NCCL's branch (all-gather into a tensor, reduce-scatter), which
        # gloo also has for CPU tensors
        grads.clear()
        with tp.enabled_for(dataclasses.replace(layout, backend="nccl")), \
                _recording_clip(grads):
            net = _net(cfg, weights)
            state = TrainState(net, train_cfg, max_iters=10 ** 6, step=step)
            res["nccl_branch"] = {
                "split_gather": split_gather_grads(7),
                "fine": _counted_step(net, state, shard_batch(batch, layout.dp_index,
                                                              layout.dp), True),
                "grads": dict(zip(names, grads[0]))}
    return res


def batch_of(rank: int) -> dict:
    """A batch whose every entry differs between ranks: float and integer
    tensors and `meta`."""
    g = torch.Generator().manual_seed(rank)
    return {"tar_rgb": torch.rand(2, 3, 4, 4, generator=g),
            "near_far": torch.rand(2, 2, generator=g, dtype=torch.float64),
            "tar_view": torch.randint(0, 10, (2, 3), generator=g),
            "fovx": torch.rand(2, generator=g),
            "meta": [{"scene": f"s{rank}", "tar_view": [rank]}]}


def broadcast_batch_of(layout) -> dict:
    """`tp.broadcast_batch` of this rank's `batch_of` (tp enabled by the
    caller), with the broadcasts it counted."""
    from lara_tpu_torch.parallel import tp

    tp.reset_counts()
    out = tp.broadcast_batch(batch_of(dist.get_rank()))
    return {"batch": out, "counts": dict(tp.COUNTS)}


def split_gather_grads(n: int) -> dict:
    """f(x) = Σ sin(gather(split(x) · w)²) · x over the global mean, x and
    w replicated: this rank's gradients of x and w (partial contributions,
    to be summed over the ranks) and the loss."""
    from lara_tpu_torch.parallel import tp
    from lara_tpu_torch.parallel.mesh import global_mean

    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, 5, generator=g, dtype=torch.float64).requires_grad_()
    w = torch.randn(5, 5, generator=g, dtype=torch.float64).requires_grad_()
    y = tp.shard_batch_dim(tp.split(x) @ w, n)
    loss = global_mean(torch.sin(y ** 2) * x)
    loss.backward()
    return {"loss": loss.item(), "x": x.grad, "w": w.grad}


def fit_tp_body(rank, world, cfg):
    """`fit_recorded(cfg)` on this rank (train.tp set in `cfg`)."""
    return fit_recorded(cfg)


def fit_recorded(cfg) -> dict:
    """`Trainer(cfg, "cpu").fit()` with each train micro-step's loss, the
    batches it read, and the loggers, panels and checkpoints this process
    wrote, recorded; returns them with what the fit ran and its
    parameters."""
    from lara_tpu_torch.train import checkpoint as ckpt
    from lara_tpu_torch.train import loop

    wrote = {"loggers": 0, "images": 0, "saves": 0}
    logger_init, add_image, write = loop.RunLogger.__init__, loop.RunLogger.add_image, \
        ckpt._write
    make = loop.make_train_step
    losses, batches = [], []

    def counting(key, fn):
        def run(*a, **kw):
            wrote[key] += 1
            return fn(*a, **kw)
        return run

    def make_train_step(*a, **kw):
        step = make(*a, **kw)

        def run(batch):
            batches.append({k: v.clone() for k, v in batch.items()})
            stats = step(batch)
            losses.append(stats["loss"].item())
            return stats
        return run

    loop.RunLogger.__init__ = counting("loggers", logger_init)
    loop.RunLogger.add_image = counting("images", add_image)
    ckpt._write = counting("saves", write)
    loop.make_train_step = make_train_step
    try:
        tr = loop.Trainer(cfg, device="cpu")
        tr.fit()
    finally:
        loop.RunLogger.__init__, loop.RunLogger.add_image = logger_init, add_image
        ckpt._write, loop.make_train_step = write, make
    return {"micro": [(m["epoch"], m["micro"], m["n_sel"], m["with_fine"], m["scenes"])
                      for m in tr.micro_log],
            "losses": losses, "batches": batches, "wrote": wrote,
            "val_epochs": tr.val_epochs, "ckpt_epochs": tr.ckpt_epochs,
            "params": {n: p.detach().clone() for n, p in tr.net.named_parameters()}}
