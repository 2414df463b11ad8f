"""Serving traffic: requests through the program's serving forward (coarse
and fine stage), one scene after the other, as `evaluate` runs them: each
request is called when the one before it has ended.

Parameters beside those every kind reads (`benchmark/load.py`):

  warmup           requests of set-up
  checked          requests of the window that the reference works out
                   again, drawn from the seed among the window's first pass
                   over the pool

End to end: `serve_scenes_per_s`, every scene of every request of the
window over the window, and `serve_p95_ms`, the 95th percentile of every
request's time from its call to the synchronise that ends it.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict

import torch

from benchmark import flops, load, program, trace as trace_mod
from benchmark.reference import net as ref_net, set_float32


def run(ctx: load.Context) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    cfg = program.config(ctx.entry)
    w = load.make_weights(ctx)
    net = program.network(cfg, w, dev)
    del w
    fwd = ctx.wrap(program.forward(net, cfg), net=net, kind="serve")
    batch = load.batches(ctx, load.make_pool(ctx))
    per = t["scenes_per_step"]
    cycle = t["pool"] // per

    for i in range(t["warmup"]):
        fwd(batch(i))
    load.free(dev)
    gen = torch.Generator().manual_seed(ctx.seed % (1 << 63))
    keep = sorted(torch.randperm(cycle, generator=gen)[:t["checked"]].tolist())
    kept, lat, ok = {}, [], []
    first = t["warmup"]

    def run_step(i):
        t_call = time.perf_counter()
        out = fwd(batch(i))
        ok.append(torch.isfinite(out["image_fine"]).all())
        load.sync(dev)
        lat.append(time.perf_counter() - t_call)
        if i - first in keep:
            kept[i] = program.served(out)

    setup_end = time.perf_counter()
    w = load.window(ctx, run_step, first, lambda: program.Spans(net, keep_blend=t["keep_blend"]))
    failed = sum(1 for x in torch.stack(ok).tolist() if not x)
    lat = lat[:w.steps]
    q = statistics.quantiles(lat, n=100, method="inclusive") if len(lat) > 1 else lat * 99
    out = {"setup_end": setup_end, "attempted": len(ok), "failed": failed, "peak": w.peak,
           "end_to_end": {"serve_scenes_per_s": w.steps * per / w.seconds,
                          "serve_p95_ms": q[94] * 1e3},
           "notes": [f"[serve] {w.steps} requests in {w.seconds:.3f} s; latency ms p50 "
                     f"{q[49] * 1e3:.2f} p95 {q[94] * 1e3:.2f} max {max(lat) * 1e3:.2f}",
                     f"[window] {load.step_seconds(w)}"]}
    if ctx.trace:
        out["trace"] = trace_mod.read(w, flops.serve_step(ctx.entry, per, t["size"]))
    del fwd, net, ok, w
    load.free(dev)
    gaps: Dict[str, float] = {}
    for i in sorted(kept):
        for k, v in compare(kept.pop(i), reference(ctx, cfg, batch(i))).items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        load.free(dev)
    out["check"] = gaps
    return out


def reference(ctx: load.Context, cfg, b: Dict, fp8: bool = False) -> Dict:
    """The reference's outputs of one request, in the comparison's terms,
    from the same weights and scenes; `fp8` rounds the network's products
    to float8 (the control)."""
    set_float32()
    ref = ref_net.LaRa(ctx.entry).to_empty(device=ctx.device)
    ref.load_state_dict(load.make_weights(ctx))
    with torch.no_grad(), (ref_net.fp8_products() if fp8 else contextlib.nullcontext()):
        out = ref(b, train=False, render_scale=cfg.infer.render_img_scale)
    res = {"surfels": out["surfels"], "sh_fine": out["sh_fine"], "selected": out["selected"],
           "maps": {k: out[k] for k in program.MAPS}}
    del ref
    return res


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """Relative L2 gaps: surfel_gap, the worst coarse surfel leaf's;
    fine_sh_gap, the fine SH's over the surfels both sides selected;
    image_gap, the worse head's image (coarse or fine); depth_gap,
    normal_gap and alpha_gap, the coarse head's maps, and the same of the
    fine head with `_fine`. select_gap: the share of the fine stage's
    selection that differs."""

    def rel(a, b):
        a, b = a.float(), b.float()
        return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                                    min=1e-30))

    sel_g, sel_r = got["selected"], ref["selected"]
    both = sel_g & sel_r
    m_got, m_ref = got["maps"], ref["maps"]
    out = {
        "surfel_gap": max(rel(a, b) for a, b in zip(got["surfels"], ref["surfels"])),
        "fine_sh_gap": rel(got["sh_fine"][both], ref["sh_fine"][both]),
        "select_gap": float((sel_g ^ sel_r).sum()) / max(1.0, float(sel_r.sum())),
        "image_gap": max(rel(m_got[k], m_ref[k]) for k in ("image", "image_fine")),
    }
    for name, key in (("depth", "depth"), ("normal", "rend_normal"), ("alpha", "acc_map")):
        out[f"{name}_gap"] = rel(m_got[key], m_ref[key])
        out[f"{name}_gap_fine"] = rel(m_got[key + "_fine"], m_ref[key + "_fine"])
    return out


def control(ctx: load.Context, fp8: bool = True) -> Dict[str, float]:
    """The cell's numbers with the reference in the program's place, its
    products rounded to float8, on the requests a run with this seed
    compares."""
    t = ctx.traffic
    cfg = program.config(ctx.entry)
    batch = load.batches(ctx, load.make_pool(ctx))
    gen = torch.Generator().manual_seed(ctx.seed % (1 << 63))
    gaps: Dict[str, float] = {}
    for k in sorted(torch.randperm(t["pool"] // t["scenes_per_step"],
                                   generator=gen)[:t["checked"]].tolist()):
        b = batch(t["warmup"] + k)
        got = reference(ctx, cfg, b, fp8=fp8)
        for name, v in compare(got, reference(ctx, cfg, b)).items():
            gaps[name] = max(gaps.get(name, 0.0), v)
        del got
    return gaps
