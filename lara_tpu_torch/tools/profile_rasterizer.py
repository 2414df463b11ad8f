"""Where the time of one render goes, stage by stage, forward and backward:
the port of `tools/profile_rasterizer.py`, `tools/profile_raster.py` and
`tools/profile_chain_bwd.py`.

    python -m lara_tpu_torch.tools.profile_rasterizer [--device cuda] [--size 512] [--n 524288] [--quick]

On `lara_workload` from the bench camera, at the production train (tile
128, visible 131,072) and eval (512, 262,144) raster configs:

  1. stages: preprocess, the depth sort, `bin_view` (sort, pack and
     windows), the pack gather, the window gather, the blend forward and
     the blend backward alone (autograd of the blend from its saved
     inputs: on the card the stash forward's `blend_bwd`, or
     `blend_bwd_replay`), and the whole render forward and forward +
     backward of mean(image) + mean(rend_dist);
  2. (train config) forward + backward of the isolated subgraphs of the
     JAX package's chain table (docs/rasterizer.md:167-176), each the sum
     of squares of its output: the preprocess (its packed rows); + the
     pack gather into depth order; the window gather alone (packed rows a
     leaf); the whole non-blend chain with the binning fixed; the chain
     with the binning recomputed;
  3. (train config) `torch.profiler` over one render: the `aten::bmm`
     calls and their device time in the preprocess forward, in its
     backward and in the whole render forward + backward, with their
     input shapes, and the render's 12 costliest ops by self device time;
  4. the reference backend (`ops/rasterizer/reference.py`) at the tool's
     size: ms of one forward (host clock, synchronised) and the PSNR of
     the train and eval renders against it.

`ms` is a host-clock slope ended by a synchronise (`timing.slope_time`);
on the card `dev_ms` is the device time of the same calls, a few queued
behind a sleep kernel (`timing.time_call`). A CPU run reports no device
time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from lara_tpu_torch.ops.gather import window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend, rasterize
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import bin_view, pack_surfels
from lara_tpu_torch.ops.renderer import render_view
from lara_tpu_torch.tools.timing import (FWD_REPS, FWDBWD_REPS, N_SURFELS, SIZE, activated,
                                         banner, bench_camera, fetcher,
                                         production_config, psnr, time_call, tool_device)
from lara_tpu_torch.tools.workload import lara_workload

CONFIGS = ("train", "eval")


def _grad_of_square(out: torch.Tensor, leaves):
    return torch.autograd.grad(torch.sum(out * out), leaves)


def _no_grad(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def _profiled(fn, dev, op: str = "aten::bmm", top: int = 0) -> dict:
    """Calls of `op` in one call of `fn` and their device ms (None on the
    CPU), and the same per input shape; with `top`, also the `top` ops of
    the call by self device time (on the card)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fn()
    fetcher(dev)(None)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        fn()
        fetcher(dev)(None)

    def dev_ms(e):
        return e.device_time_total / 1e3 if dev.type == "cuda" else None

    rows = [e for e in prof.key_averages(group_by_input_shape=True) if e.key == op]
    total = sum(e.device_time_total for e in rows) / 1e3 if dev.type == "cuda" else None
    res = {"calls": sum(e.count for e in rows), "device_ms": total,
           "by_shape": [{"shapes": str(e.input_shapes), "calls": e.count,
                         "device_ms": dev_ms(e)} for e in rows]}
    if top and dev.type == "cuda":
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:top]
        res["top_self_device_ms"] = [[e.key, e.count, e.self_device_time_total / 1e3]
                                     for e in ops]
    return res


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, quick: bool = False) -> dict:
    dev = tool_device(device)
    banner(dev)
    scene = lara_workload(n, 0, dev)
    cam, bg = bench_camera(dev), torch.ones(3, device=dev)
    act = activated(scene)
    scalars = torch.stack([cam.tanfovx, cam.tanfovy]).to(torch.float32)
    fetch = fetcher(dev)

    res = {"tool": "profile_rasterizer", "device": str(dev), "size": size, "n": n}
    images = {}
    for name in CONFIGS:
        cfg = production_config(size, train=name == "train")
        v = min(cfg.visible_budget, n) if cfg.visible_budget else n
        with torch.no_grad():
            g = preprocess_surfels(*act, cam, cfg)
            order_v = torch.argsort(torch.where(g.valid, g.depth, torch.inf), stable=True)[:v]
            packed, binned = bin_view(g, cfg)
            win = (binned.win_gidx, binned.entry_valid, binned.slot_pos)
            entries = window_gather(packed, *win)
            images[name] = render_view(cam, None, *scene, bg, cfg)["image"]
        e_leaf = entries.detach().requires_grad_(True)
        blend_out = cuda_blend.blend_tiles(e_leaf, binned.counts, scalars, cfg)
        cot = torch.rand(blend_out.shape, generator=torch.Generator().manual_seed(0)).to(dev)
        leaves = [p.detach().requires_grad_(True) for p in scene]

        def render_fwdbwd():
            f = render_view(cam, None, *leaves, bg, cfg)
            return torch.autograd.grad(torch.mean(f["image"]) + torch.mean(f["rend_dist"]),
                                       leaves)

        stages = {
            "preprocess": (_no_grad(lambda: preprocess_surfels(*act, cam, cfg)), FWD_REPS),
            "depth_sort": (_no_grad(lambda: torch.argsort(
                torch.where(g.valid, g.depth, torch.inf), stable=True)[:v]), FWD_REPS),
            "bin_view": (_no_grad(lambda: bin_view(g, cfg)), FWD_REPS),
            "pack_gather": (_no_grad(lambda: pack_surfels(g)[order_v]), FWD_REPS),
            "window_gather": (_no_grad(lambda: window_gather(packed, *win)), FWD_REPS),
            "blend_fwd": (_no_grad(lambda: cuda_blend.blend_tiles(
                entries, binned.counts, scalars, cfg)), FWD_REPS),
            "blend_bwd": (lambda: torch.autograd.grad(blend_out, e_leaf, cot,
                                                      retain_graph=True), FWDBWD_REPS),
            "render_fwd": (_no_grad(lambda: render_view(cam, None, *scene, bg, cfg)["image"]),
                           FWD_REPS),
            "render_fwdbwd": (render_fwdbwd, FWDBWD_REPS),
        }
        res[name] = {"stages": {k: time_call(fn, dev, reps, quick)
                                for k, (fn, reps) in stages.items()}}
        for k, row in res[name]["stages"].items():
            print(f"[{name}] {k:14s} {row['ms']:9.3f} ms  device {row['dev_ms']}", flush=True)
        if name != "train":
            continue

        def pre_packed():
            return pack_surfels(preprocess_surfels(*activated(leaves), cam, cfg))

        p_leaf = packed.detach().requires_grad_(True)

        def chain_live():
            pk, b = bin_view(preprocess_surfels(*activated(leaves), cam, cfg), cfg)
            return _grad_of_square(window_gather(pk, b.win_gidx, b.entry_valid, b.slot_pos),
                                   leaves)

        chain = {
            "preprocess": lambda: _grad_of_square(pre_packed(), leaves),
            "preprocess_pack": lambda: _grad_of_square(pre_packed()[order_v], leaves),
            "window_gather": lambda: _grad_of_square(window_gather(p_leaf, *win), p_leaf),
            "chain": lambda: _grad_of_square(window_gather(pre_packed()[order_v], *win),
                                             leaves),
            "chain_live_binning": chain_live,
        }
        res[name]["chain_fwdbwd"] = {k: time_call(fn, dev, FWDBWD_REPS, quick)
                                     for k, fn in chain.items()}
        for k, row in res[name]["chain_fwdbwd"].items():
            print(f"[chain fwd+bwd] {k:18s} {row['ms']:9.3f} ms  device {row['dev_ms']}",
                  flush=True)

        g_leaf = pre_packed()
        pre_loss = torch.sum(g_leaf * g_leaf)
        res[name]["bmm_per_render"] = {
            "preprocess_fwd": _profiled(lambda: preprocess_surfels(*activated(leaves), cam, cfg),
                                        dev),
            "preprocess_bwd": _profiled(
                lambda: torch.autograd.grad(pre_loss, leaves, retain_graph=True), dev),
            "render_fwdbwd": _profiled(render_fwdbwd, dev, top=12),
        }
        print("[bmm per render] " + str({k: (r["calls"], r["device_ms"]) for k, r in
                                          res[name]["bmm_per_render"].items()}), flush=True)

    with torch.no_grad():
        fetch(None)
        t0 = time.perf_counter()
        ref = rasterize(*act, cam, bg, production_config(size, backend="reference")).image
        fetch(None)
        ms = 1e3 * (time.perf_counter() - t0)
    res["reference"] = {"ms": ms, **{f"psnr_{k}": psnr(images[k], torch.clamp(ref, 0.0, 1.0))
                                     for k in CONFIGS}}
    print(f"[reference] {res['reference']}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--n", type=int, default=N_SURFELS)
    ap.add_argument("--quick", action="store_true", help="few repetitions, one trial")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.size, a.n, a.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
