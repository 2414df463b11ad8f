"""Training traffic: fine micro-steps through the program's training step,
one after the other, as the trainer calls it.

Parameters beside those every kind reads (`benchmark/load.py`):

  start_step, max_iters  the TrainState's first micro-step count and the
                   schedule's length
  checked          the micro-steps of set-up that the reference follows

Set-up builds the one TrainState the window drives and runs the checked
micro-steps through the window's own call; the reference follows them
from the same weights and scenes. End to end: `train_scenes_per_s`, every
scene of every micro-step of the window over the window, and
`train_peak_mem_gb`, the device's memory peak over the window.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Dict, List

import torch

from benchmark import flops, load, program, trace as trace_mod
from benchmark.reference import net as ref_net, set_float32, train as ref_train


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> tuple:
    """(gap, leaf) of the worst leaf by |‖prog‖ − ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖."""
    names = list(names)
    if not names:
        return 0.0, ""
    med = statistics.median(ref[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n) for n in names)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors.values()]).tolist()
    return dict(zip(tensors, vals))


def run(ctx: load.Context) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    cfg = program.config(ctx.entry)
    w = load.make_weights(ctx)
    net = program.network(cfg, w, dev)
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    del w
    step, state = program.train_step(net, cfg, t["start_step"], t["max_iters"])
    step = ctx.wrap(step, net=net, state=state, kind="train")
    batch = load.batches(ctx, load.make_pool(ctx))
    per = t["scenes_per_step"]

    # the checked micro-steps: set-up, warm-up, and what the reference follows
    losses, g_norms = [], None
    beta1 = cfg.train.beta1
    for i in range(t["checked"]):
        losses.append(float(step(batch(i))["loss"]))
        if (i + 1) == cfg.train.grad_accum:
            g_norms = {}
            for n, p in net.named_parameters():
                m = state.optimizer.state.get(p, {}).get("exp_avg")
                g_norms[n] = 0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1 - beta1)
    d_norms = _norms({n: p.detach() - p0[n] for n, p in net.named_parameters()})
    del p0
    load.free(dev)

    loss_log: List[torch.Tensor] = []

    def run_step(i):
        loss_log.append(step(batch(i))["loss"])

    setup_end = time.perf_counter()
    w = load.window(ctx, run_step, t["checked"],
                    lambda: program.Spans(net, state, keep_blend=t["keep_blend"]))
    failed = sum(1 for x in torch.stack(loss_log).tolist() if not math.isfinite(x))
    out = {"setup_end": setup_end, "attempted": len(loss_log), "failed": failed,
           "peak": w.peak, "notes": [f"[window] {load.step_seconds(w)}"],
           "end_to_end": {"train_scenes_per_s": w.steps * per / w.seconds,
                          "train_peak_mem_gb": w.peak / 1e9}}
    if ctx.trace:
        out["trace"] = trace_mod.read(w, flops.train_step(ctx.entry, per, t["size"]))
    del step, state, net, loss_log, w
    load.free(dev)
    ref_l, ref_g, ref_d = reference(ctx, cfg, batch)
    out["check"] = numbers(losses, g_norms, d_norms, ref_l, ref_g, ref_d, cfg.train.grad_accum)
    return out


def numbers(losses, g, d, ref_l, ref_g, ref_d, ga: int) -> Dict[str, float]:
    """loss_gap: the worst relative gap of a micro-step's loss before the
    first update; loss_gap_after: of the later checked micro-steps' losses;
    grad_gap and update_gap: the worst leaf's gap of the first update's
    clipped mean gradient and of its change, by norm (`_leaf_gap`). The
    change leaves out the leaves whose reference gradient is under a
    thousandth of the median leaf's: they move by rounding alone."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_l)]
    med = statistics.median(ref_g.values())
    moved = [n for n in ref_g if ref_g[n] >= 1e-3 * med]
    grad, grad_leaf = _leaf_gap(g, ref_g, ref_g)
    update, update_leaf = _leaf_gap(d, ref_d, moved)
    return {"loss_gap": max(gaps[:ga]), "loss_gap_after": max(gaps[ga:], default=0.0),
            "grad_gap": grad, "update_gap": update,
            "leaves": f"grad {grad_leaf}, update {update_leaf}"}


def reference(ctx: load.Context, cfg, batch, fp8: bool = False):
    """(losses, {leaf: ‖clipped mean gradient‖}, {leaf: ‖change‖}) of the
    reference over the checked micro-steps, from the same weights and
    scenes; `fp8` rounds the network's products to float8 (the control)."""
    set_float32()
    t = ctx.traffic
    tc = dict(lr=cfg.train.lr, warmup_iters=cfg.train.warmup_iters, max_iters=t["max_iters"],
              beta1=cfg.train.beta1, beta2=cfg.train.beta2,
              weight_decay=cfg.train.weight_decay, grad_clip=cfg.train.grad_clip)
    ga = cfg.train.grad_accum
    ref = ref_net.LaRa(ctx.entry).to_empty(device=ctx.device)
    w = load.make_weights(ctx)
    ref.load_state_dict(w)
    decay = ref_train.decayed(ref)
    losses, grads = [], []
    lowp = ref_net.fp8_products if fp8 else contextlib.nullcontext
    for i in range(ga):
        b = batch(i)
        with lowp():
            out = ref(b, train=True, remat=True)
            loss = ref_train.losses(b, out, (t["start_step"] + i) // ga)
            loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().clone() for n, p in ref.named_parameters()})
        ref.zero_grad(set_to_none=True)
        del out, loss
    clipped, new = ref_train.first_update({n: p.detach() for n, p in ref.named_parameters()},
                                          grads, decay, tc, (t["start_step"] + ga) // ga - 1)
    del grads
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(new[n])
        for i in range(ga, t["checked"]):
            b = batch(i)
            with lowp():
                out = ref(b, train=True)
                losses.append(float(ref_train.losses(b, out, (t["start_step"] + i) // ga)))
            del out
    d = _norms({n: new[n] - w[n] for n in new})
    g = _norms(clipped)
    del ref, w, new, clipped
    load.free(ctx.device)
    return losses, g, d


def control(ctx: load.Context, fp8: bool = True) -> Dict[str, float]:
    """The cell's numbers with the reference in the program's place, its
    products rounded to float8."""
    cfg = program.config(ctx.entry)
    batch = load.batches(ctx, load.make_pool(ctx))
    low = reference(ctx, cfg, batch, fp8=fp8)
    return numbers(*low, *reference(ctx, cfg, batch), cfg.train.grad_accum)
