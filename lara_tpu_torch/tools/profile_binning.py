"""Where the time of the binning goes, stage by stage: the port of
`tools/profile_binning.py`.

    python -m lara_tpu_torch.tools.profile_binning [--views 8] [--trials 3] [--device cuda]

Run from the repository root. On the `lara_workload` scene (N = 524,288
surfels with trained statistics) at the production raster config
(visible_budget 131,072, dup 3, T = 1,024 tiles of 16² at 512², K = 128;
M = 9·131,072 sort keys per view) it times:
  A. each stage of one view's sort binning, and three ways to cut the
     [T, K] windows out of the sorted keys: a per-tile slice (`unfold`),
     one flat gather, and the CUDA kernel `tile_windows` (`win_cuda_1`;
     with `--device cpu` its plain version, `win_plain_1`);
  B. the same stages batched over NV views (`*_b{NV}`, the torch op's
     batched form along dim 1);
  C. the sort windows against the counting-sort windows (per view, so the
     batched rows loop over the views: `*_loop{NV}`), and whole `bin_view`
     calls in each bin_mode and in pack_mode "fused".

Each stage is timed by the JAX tool's slope method: the time of r2 calls
less that of r1 calls, over r2 - r1, best of `trials`, each run ended by
`torch.cuda.synchronize()` (`ms`). Eager PyTorch dispatches op by op, so a
stage of a few small ops reads its host time there; on the card the table
also gives the device time (`dev ms`, `queued_ms`: r1 calls queued behind a
sleep kernel that outlasts their dispatch). The kernel's windows must equal the per-tile
slices bit for bit, and the count windows the sort windows on every valid
entry: a failing check or kernel raises. The tool runs on the card unless
`--device cpu` is given; times of a CPU run are the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from lara_tpu_torch.config import RenderConfig
from lara_tpu_torch.models.lara import make_cameras
from lara_tpu_torch.ops.rasterizer.cuda_windows import (INT32_MAX, tile_windows,
                                                        tile_windows_reference)
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.tiled import (_GIDX_BITS, _pack_tile_bounds,
                                                 _windows_count, _windows_sort,
                                                 bin_view, pack_surfels, slot_keys,
                                                 tile_ranges)
from lara_tpu_torch.ops.rasterizer.types import ProjectedSurfels, RasterizeConfig
from lara_tpu_torch.ops.renderer import (opacity_activation, rotation_activation,
                                         scaling_activation)
from lara_tpu_torch.tools.workload import lara_workload
from lara_tpu_torch.utils.camera import Camera

H = W = 512


def slope_time(fn, args, r1, r2, fetch, trials=3) -> float:
    """Seconds per call: (time of r2 calls - time of r1 calls) / (r2 - r1),
    the least of `trials` such slopes, after r1 warm-up calls (one in the
    JAX tool: here the caching allocator also grows its pool on the first
    calls, which would inflate a first r1 run and shrink its slope);
    `fetch` waits for the last call's result."""

    def run(reps):
        t0 = time.perf_counter()
        o = None
        for _ in range(reps):
            o = fn(*args)
        fetch(o)
        return time.perf_counter() - t0

    run(r1)
    best = math.inf
    for _ in range(trials):
        a, b = run(r1), run(r2)
        best = min(best, max((b - a) / (r2 - r1), 1e-9))
    return best


def queued_ms(fn, reps: int = 50, rounds: int = 5, cover_s: float = 0.025) -> float:
    """Device ms per call of `fn` on the card: `reps` calls queued behind a
    sleep kernel of about `cover_s` seconds (at 2 GHz), so the events time
    back-to-back device work and not the host's dispatch, as long as the
    host enqueues the calls within `cover_s`; median of `rounds`."""
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cover_s * 2e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def raster_config() -> RasterizeConfig:
    """The production training raster config (RenderConfig's defaults)."""
    r = RenderConfig()
    return RasterizeConfig(height=H, width=W, tile=r.tile, dup=r.dup,
                           tile_budget=r.tile_budget, sh_degree=1,
                           visible_budget=r.visible_budget,
                           pallas_chunk=min(r.pallas_chunk, r.tile_budget))


def orbit_cameras(nv: int, device):
    """nv cameras at distance 1.8 orbiting the scene about the y axis."""
    c2ws = []
    for i in range(nv):
        ang = 2 * np.pi * i / nv
        c2w = np.eye(4)
        c2w[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                                [-np.sin(ang), 0, np.cos(ang)]])
        c2w[:3, 3] = -c2w[:3, :3] @ np.array([0, 0, 1.8])
        c2ws.append(c2w)
    c2ws = torch.tensor(np.stack(c2ws), dtype=torch.float32, device=device)
    scalar = lambda x: torch.tensor(x, device=device)  # noqa: E731
    return make_cameras(c2ws, scalar(0.69), scalar(0.69), scalar(1.0), scalar(2.6))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [N, ...] at idx [V] for one view, or of x [NV, N, ...] at
    idx [NV, V] for several (indexing along dim 1)."""
    if idx.dim() == 1:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def run(views: int = 8, trials: int = 3, device="cuda", n: int = 64 ** 3 * 2) -> dict:
    """Time and check every stage; print the table; return {stage: seconds}."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi_line
        print(nvidia_smi_line())
        fetch = lambda _: torch.cuda.synchronize(dev)  # noqa: E731
    else:
        print(f"[device] {dev}: plain versions; the times are this CPU's")
        fetch = lambda _: None  # noqa: E731
    cfg = raster_config()
    nv, k_budget, t_total = views, cfg.tile_budget, cfg.num_tiles
    v = min(cfg.visible_budget, n)
    win_label = "win_cuda_1" if dev.type == "cuda" else "win_plain_1"
    means, shs, op_raw, sc_raw, quats = lara_workload(n, 0, dev)
    op, sc, qn = (opacity_activation(op_raw), scaling_activation(sc_raw),
                  rotation_activation(quats))
    cams = orbit_cameras(nv, dev)
    cam_at = [Camera(**{f.name: getattr(cams, f.name)[i] for f in dataclasses.fields(cams)})
              for i in range(nv)]

    def preprocess(cam, c=cfg):
        return preprocess_surfels(means, shs, op, sc, qn, cam, c)

    g0 = preprocess(cam_at[0])
    g_b = ProjectedSurfels(*(torch.stack(f) for f in zip(*(preprocess(c) for c in cam_at))))
    print(f"[scene] {n} surfels, {int(g0.valid.sum())} valid in view 0; V {v}, "
          f"T {t_total}, K {k_budget}, M {cfg.dup ** 2 * v} keys per view, {nv} views")
    res, dev_ms = {}, {}

    def timed(name, fn, args, reps=(10, 40)):
        res[name] = slope_time(fn, args, *reps, fetch, trials)
        if dev.type == "cuda":
            # the sleep covers 1.5x the host's time for the r1 calls
            dev_ms[name] = queued_ms(lambda: fn(*args), reps[0], trials,
                                     1.5 * reps[0] * res[name])

    # ---- A. single-view stages --------------------------------------------
    def stage_argsort(depth, valid):
        return torch.argsort(torch.where(valid, depth, torch.inf), dim=-1, stable=True)[..., :v]

    def stage_pack(g, order):
        return take(pack_surfels(g), order)

    def stage_bounds_v(g, order):
        return take(_pack_tile_bounds(g, cfg), order)

    def keys_of(g, order):
        # the bit-packed tile bounds of every surfel in depth order, expanded
        # to the dup² slot keys, as bin_view builds them (the JAX tool
        # gathers center, radius and validity and bounds them after)
        return slot_keys(stage_bounds_v(g, order), cfg)

    def keysort(keys):
        return torch.sort(keys, dim=-1).values

    def stage_starts(sk):
        return tile_ranges(sk, cfg)[0]

    def win_dynslice(sk, starts):
        padded = torch.cat([sk, sk.new_full((*sk.shape[:-1], k_budget), INT32_MAX)], dim=-1)
        return take(padded.unfold(-1, k_budget, 1), starts)           # [..., M+1, K] views

    def win_flatgather(sk, starts):
        return tile_windows_reference(sk, starts, k_budget)

    def win_kernel(sk, starts):
        return tile_windows(sk, starts, k_budget)

    def stage_rows(packed, win):
        gidx = torch.clamp(win & ((1 << _GIDX_BITS) - 1), max=packed.shape[-2] - 1)
        return take(packed, gidx.flatten(-2)).reshape(*win.shape, packed.shape[-1])

    order0 = stage_argsort(g0.depth, g0.valid)
    timed("argsort_1", stage_argsort, (g0.depth, g0.valid))
    packed0 = stage_pack(g0, order0)
    timed("pack_gather_1", stage_pack, (g0, order0))
    keys0 = keys_of(g0, order0)
    timed("keybuild_1", keys_of, (g0, order0))
    skeys0 = keysort(keys0)
    timed("keysort_1", keysort, (keys0,))
    starts0 = stage_starts(skeys0)
    timed("searchsorted_1", stage_starts, (skeys0,))
    w0 = win_dynslice(skeys0, starts0)
    timed("win_dynslice_1", win_dynslice, (skeys0, starts0))
    if not torch.equal(win_flatgather(skeys0, starts0), w0):
        raise RuntimeError("flat-gather windows differ from the per-tile slices")
    timed("win_flatgather_1", win_flatgather, (skeys0, starts0))
    if not torch.equal(win_kernel(skeys0, starts0), w0):
        raise RuntimeError(f"{win_label}: tile_windows differs from the per-tile slices")
    timed(win_label, win_kernel, (skeys0, starts0))
    timed("row_gather_1", stage_rows, (packed0, w0))

    # ---- B. batched over NV views -----------------------------------------
    b = f"b{nv}"
    order_b = stage_argsort(g_b.depth, g_b.valid)
    timed(f"argsort_{b}", stage_argsort, (g_b.depth, g_b.valid), (5, 20))
    packed_b = stage_pack(g_b, order_b)
    timed(f"pack_gather_{b}", stage_pack, (g_b, order_b), (5, 20))
    keys_b = keys_of(g_b, order_b)
    timed(f"keybuild_{b}", keys_of, (g_b, order_b), (5, 20))
    skeys_b = keysort(keys_b)
    timed(f"keysort_{b}", keysort, (keys_b,), (5, 20))
    starts_b = stage_starts(skeys_b)
    timed(f"searchsorted_{b}", stage_starts, (skeys_b,), (5, 20))
    win_b = win_dynslice(skeys_b, starts_b)
    timed(f"win_dynslice_{b}", win_dynslice, (skeys_b, starts_b), (5, 20))
    timed(f"win_flatgather_{b}", win_flatgather, (skeys_b, starts_b), (5, 20))
    timed(f"row_gather_{b}", stage_rows, (packed_b, win_b), (5, 20))

    def fused_binning(g, windows):
        order = stage_argsort(g.depth, g.valid)
        packed = stage_pack(g, order)
        sk = keysort(keys_of(g, order))
        starts = stage_starts(sk)
        return stage_rows(packed, windows(sk, starts)), starts

    timed(f"fused_binning_{b}", fused_binning, (g_b, win_flatgather), (5, 20))
    timed("fused_binning_1", fused_binning, (g0, win_dynslice))

    # ---- C. sort vs counting-sort window construction ---------------------
    def wsort(bv):
        return _windows_sort(bv, cfg)

    def wcount(bv):
        return _windows_count(bv, cfg)

    bv0 = stage_bounds_v(g0, order0)
    ws0, wc0 = wsort(bv0), wcount(bv0)
    ev = ws0[1]
    if not (torch.equal(ws0[1], wc0[1]) and torch.equal(ws0[2], wc0[2])
            and torch.equal(ws0[0][ev], wc0[0][ev])):
        raise RuntimeError("count-mode windows diverge from sort-mode")
    timed("windows_sort_1", wsort, (bv0,))
    timed("windows_count_1", wcount, (bv0,))

    loop = f"loop{nv}"
    bv_b = list(stage_bounds_v(g_b, order_b))
    timed(f"windows_sort_{loop}", lambda bvs: [wsort(x) for x in bvs], (bv_b,), (5, 20))
    timed(f"windows_count_{loop}", lambda bvs: [wcount(x) for x in bvs], (bv_b,), (5, 20))

    for mode, kw in (("sort", {}), ("count", {"bin_mode": "count"}),
                     ("fused", {"pack_mode": "fused"})):
        cfg_m = dataclasses.replace(cfg, **kw)
        timed(f"bin_view_{mode}_1", lambda c, cm=cfg_m: bin_view(preprocess(c, cm), cm),
              (cam_at[0],))

    print(f"{'stage':24s} {'ms':>9s} {'ms/view':>9s}"
          + (f" {'dev ms':>9s} {'dev/view':>9s}" if dev_ms else ""))
    for name, sec in res.items():
        views = nv if name.endswith((f"_{b}", f"_{loop}")) else 1
        cols = [sec * 1e3] + ([dev_ms[name]] if dev_ms else [])
        print(f"{name:24s} " + " ".join(
            f"{c:9.3f} " + (f"{c / views:9.3f}" if views > 1 else " " * 9) for c in cols))
    if dev.type == "cuda":
        print(nvidia_smi_line())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time every stage of the binning")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.views, a.trials, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
