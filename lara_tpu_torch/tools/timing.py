"""The shared harness of the rasterizer tools, the counterpart of
`tools/ab_kernels_common.py`: the timers, the bench scene and camera, the
production raster configuration, and `timed`, which times one render's
forward and forward + backward.

  - `slope_time`: host-clock seconds per call by the JAX tools' slope
    method, each run ended by `fetch` (a synchronise on the card);
  - `queued_ms`: device ms per call on the card, the calls queued behind a
    sleep kernel so the events time device work, not the host's dispatch;
  - `bench_camera`: the camera of `bench.py:bench_rasterizer` (c2w
    translation z = -1.8, field of view 0.69 rad, near 1, far 2.6), which
    the tools point at `tools/workload.py:lara_workload` (N = 524,288
    surfels with a trained scene's statistics) on a white background;
  - `production_config`: the RasterizeConfig that `LaRaNet._render_cfg`
    builds from `RenderConfig()` at the train or the eval budgets;
  - `timed`: ms of one render's forward and of its forward + backward of
    mean(image) + mean(rend_dist) (`bench.py:124-128`) through
    `ops/renderer.py:render_view`.

Every tool runs on the card unless it is given `--device cpu` (the plain
versions, for a rehearsal: its times are the CPU's); asked for the card
where there is none, it raises.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from lara_tpu_torch.config import RenderConfig
from lara_tpu_torch.models.lara import make_cameras
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.ops.renderer import (opacity_activation, render_view,
                                         rotation_activation, scaling_activation)
from lara_tpu_torch.utils.camera import Camera

SIZE = 512
N_SURFELS = 64 ** 3 * 2
BENCH_DISTANCE, BENCH_FOV, BENCH_NEAR, BENCH_FAR = 1.8, 0.69, 1.0, 2.6
# (r1, r2) calls of the slope timer: full, and with --quick
FWD_REPS, FWDBWD_REPS, QUICK_REPS = (10, 40), (5, 20), (2, 4)
# calls queued behind the sleep kernel by `time_call`: a render's forward +
# backward launches hundreds of kernels, and the host blocks once the
# card's launch queue (~1,000 entries) is full, which lets host time into
# a longer queue's reading
QUEUED_CALLS = 3


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


def tool_device(name: str) -> torch.device:
    """The device a tool measures; "cuda" without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tool measures the card "
                           "(--device cpu runs the plain versions for a rehearsal)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the tools run on cuda or cpu, not {dev}")
    return dev


def banner(dev: torch.device) -> str:
    """Print and return the first line of a tool's output: the card's name
    and power limit (`nvidia-smi`), or what a CPU run's numbers are."""
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi_line
        line = nvidia_smi_line()
    else:
        line = f"[device] {dev}: plain versions; the times are this CPU's"
    print(line, flush=True)
    return line


def fetcher(dev: torch.device):
    """What ends a timed run: a synchronise on the card, nothing on the CPU."""
    if dev.type == "cuda":
        return lambda _: torch.cuda.synchronize(dev)
    return lambda _: None


def bench_camera(dev, angle: float = 0.0) -> Camera:
    """The bench camera at distance 1.8 looking at the origin, turned by
    `angle` radians about the y axis (angle 0: `bench.py`'s c2w, identity
    rotation at z = -1.8)."""
    c, s = math.cos(angle), math.sin(angle)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    c2w[:3, 3] = -c2w[:3, :3] @ np.array([0.0, 0.0, BENCH_DISTANCE])

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return make_cameras(torch.from_numpy(c2w).to(dev), scalar(BENCH_FOV), scalar(BENCH_FOV),
                        scalar(BENCH_NEAR), scalar(BENCH_FAR))


def activated(scene: tuple) -> tuple:
    """The raw scene through the renderer's activations: what `rasterize`
    takes."""
    means, shs, op_raw, sc_raw, quats = scene
    return (means, shs, opacity_activation(op_raw), scaling_activation(sc_raw),
            rotation_activation(quats))


def production_config(size: int = SIZE, train: bool = True, **overrides) -> RasterizeConfig:
    """The raster config `LaRaNet._render_cfg` builds from `RenderConfig()`
    at `size`², at the train (tile 128, visible 131,072) or the eval (512,
    262,144) budgets, chunk 64, with `overrides` replaced."""
    r = RenderConfig()
    budget = r.tile_budget if train else r.eval_tile_budget
    cfg = RasterizeConfig(
        height=size, width=size, tile=r.tile, dup=r.dup, tile_budget=budget, sh_degree=1,
        visible_budget=r.visible_budget if train else r.eval_visible_budget,
        pallas_chunk=min(r.pallas_chunk, budget), stash_carries=r.pallas_stash_carries,
        bin_mode=r.bin_mode, pack_mode=r.pack_mode)
    return dataclasses.replace(cfg, **overrides)


def psnr(img: torch.Tensor, ref: torch.Tensor):
    """PSNR (dB, peak 1) of `img` against `ref`; None where they are equal
    bit for bit (JSON has no infinity)."""
    mse = float(torch.mean((img.float() - ref.float()) ** 2))
    return None if mse == 0.0 else -10.0 * math.log10(mse)


def time_call(fn, dev, reps=FWD_REPS, quick: bool = False, trials: int = 3) -> dict:
    """{"ms": host-clock ms per call of `fn` (a slope ended by a
    synchronise), "dev_ms": on the card the device ms per call, QUEUED_CALLS
    calls queued behind a sleep kernel that covers 1.5x the host's time for
    them, median of `trials` (None on the CPU)}. `quick`: QUICK_REPS and
    one trial."""
    reps, trials = (QUICK_REPS, 1) if quick else (reps, trials)
    row = {"ms": 1e3 * slope_time(fn, (), *reps, fetcher(dev), trials), "dev_ms": None}
    if dev.type == "cuda":
        row["dev_ms"] = queued_ms(fn, QUEUED_CALLS, trials,
                                  1.5e-3 * QUEUED_CALLS * row["ms"])
    return row


def timed(cfg: RasterizeConfig, scene: tuple, cam: Camera, dev, quick: bool = False,
          trials: int = 3) -> dict:
    """ms of one render of the raw `scene` through `render_view` at `cfg`:
    forward, and forward + backward of mean(image) + mean(rend_dist) to
    all five parameter tensors. `fwd_ms` / `fwdbwd_ms` are host-clock
    slopes ended by a synchronise (the JAX tools' numbers); on the card
    `fwd_dev_ms` / `fwdbwd_dev_ms` are the same calls' device time, queued
    behind a sleep kernel (None on the CPU)."""
    bg = torch.ones(3, device=dev)
    leaves = [p.detach().requires_grad_(True) for p in scene]

    def fwd():
        with torch.no_grad():
            return render_view(cam, None, *scene, bg, cfg)["image"]

    def fwdbwd():
        f = render_view(cam, None, *leaves, bg, cfg)
        return torch.autograd.grad(torch.mean(f["image"]) + torch.mean(f["rend_dist"]), leaves)

    f = time_call(fwd, dev, FWD_REPS, quick, trials)
    fb = time_call(fwdbwd, dev, FWDBWD_REPS, quick, trials)
    return {"fwd_ms": f["ms"], "fwdbwd_ms": fb["ms"],
            "fwd_dev_ms": f["dev_ms"], "fwdbwd_dev_ms": fb["dev_ms"]}
