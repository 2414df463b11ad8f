"""The general generator of the benchmark's traffic. A traffic file
(`benchmark/traffic/<mix>.json`) holds a mix's parameters and names its
`kind`: the module `benchmark/kinds/<kind>.py`, found by name, that makes
the inputs from the seed and drives one entry of the program with them
(`run(ctx)`), and that works out the same requests again with the plain
reference (`control(ctx, fp8)`). A mix of a kind that is there is a data
file alone; a new kind of traffic is a new module beside the others.

Every kind is a closed loop: one caller waits for each step, as the
trainer and `evaluate` call the program. Set-up makes the weights and the
scenes from the seed, builds the program's step and runs the warm-up
steps. The window runs steps until `seconds` have passed on the host
clock, then synchronises. A traced run measures the same window, then
runs `trace_steps` steps under a device-only profile (the device's busy
time a step) and as many under the full profile with the benchmark's
spans (which layer owns each device operation).

Parameters every kind reads:

  kind             the module that drives the program
  scenes_per_step  scenes of one micro-step or request
  pool             seeded scenes made at set-up and drawn in turn
  size, fov, radius  the views: size² pixels, field of view, orbit radius
  checked          the steps the reference works out again
  trace_steps      steps under each profile in a traced run
  keep_blend       blend calls of the span phase whose inputs are kept for
                   the blend kernels' work
"""

from __future__ import annotations

import gc
import importlib.util
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from benchmark import scenes, weights
from benchmark.reference import net as ref_net

ROOT = Path(__file__).resolve().parents[1]


def from_file(path: Path, prefix: str):
    """The module in `path`, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{prefix}_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, root: Path = ROOT):
    """The module of the traffic kind `name` (`benchmark/kinds/<name>.py`)."""
    return from_file(root / "benchmark" / "kinds" / f"{name}.py", "kind")


class Context:
    """One run of one cell: its configuration and traffic entries, the seed,
    the window's length, whether it is traced, the device, optional hooks
    that replace the program's step or forward (the fault tests), and the
    rank whose scenes it makes (0 on one card)."""

    def __init__(self, entry: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
                 device, wrap: Optional[Callable] = None, rank: int = 0):
        self.entry, self.traffic, self.seed = entry, traffic, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.wrap = wrap or (lambda fn, **_: fn)
        self.rank = rank


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    """Frees what set-up or the window left for the next phase of the run."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def make_weights(ctx: Context):
    meta = ref_net.LaRa(ctx.entry)
    return weights.make(meta, ctx.entry["model"], ctx.seed, ctx.device)


def make_pool(ctx: Context) -> Dict:
    t = ctx.traffic
    return scenes.make_pool(t["pool"], ctx.entry["n_views"], t["size"], t["fov"], t["radius"],
                            ctx.seed * 4 + ctx.rank, ctx.device)


def batches(ctx: Context, pool: Dict) -> Callable[[int], Dict]:
    """Step i's scenes: the pool's scenes in turn, `scenes_per_step` a step."""
    per = ctx.traffic["scenes_per_step"]
    cycle = ctx.traffic["pool"] // per
    return lambda i: scenes.take(pool, (i % cycle) * per, per)


class Window:
    """What a window ran: `steps` and `seconds` of the measured window, the
    step indices it ran, the host clock at each step's end, the device's
    memory peak over it, and in a traced run the two profiles, the device-
    only phase's steps and seconds, and the spans."""

    def __init__(self):
        self.steps, self.seconds, self.ends, self.peak = 0, 0.0, [], 0
        self.indices = range(0)
        self.traced_steps, self.traced_seconds = 0, 0.0
        self.device_prof = self.span_prof = self.spans = None


def _run(ctx, run_step, first: int, count: int, seconds: float, span: bool) -> tuple:
    """Steps first, first+1, ... until `count` ran or `seconds` passed;
    (steps, seconds, host clock at each step's end)."""
    sync(ctx.device)
    t0 = time.perf_counter()
    ends = []
    for k in range(count):
        if span:
            with torch.autograd.profiler.record_function("step"):
                run_step(first + k)
        else:
            run_step(first + k)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    sync(ctx.device)
    return len(ends), time.perf_counter() - t0, [e - t0 for e in ends]


def window(ctx: Context, run_step: Callable[[int], None], first: int,
           spans: Callable = None) -> Window:
    """The measured window: steps first, first+1, ... until the window's
    seconds have passed. Traced, then `trace_steps` steps under a
    device-only profile and as many under the full profile with the spans
    `spans()` installs, whose host ops own the device's work."""
    w = Window()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    w.steps, w.seconds, w.ends = _run(ctx, run_step, first, 1 << 30, ctx.seconds, False)
    w.indices = range(first, first + w.steps)
    w.peak = peak(ctx.device)
    if not ctx.trace:
        return w
    n = ctx.traffic["trace_steps"]
    nxt = first + w.steps
    dev_acts = [torch.profiler.ProfilerActivity.CUDA] if ctx.device.type == "cuda" else []
    with torch.profiler.profile(activities=dev_acts or
                                [torch.profiler.ProfilerActivity.CPU]) as prof:
        w.traced_steps, w.traced_seconds, _ = _run(ctx, run_step, nxt, n, float("inf"), False)
    w.device_prof = prof
    w.spans = spans()
    acts = [torch.profiler.ProfilerActivity.CPU] + dev_acts
    with torch.profiler.profile(activities=acts) as prof:
        _run(ctx, run_step, nxt + n, n, float("inf"), True)
    w.span_prof = prof
    w.spans.remove()
    return w


def step_seconds(w: Window) -> str:
    """The host seconds between the window's step ends."""
    gaps = [b - a for a, b in zip([0.0] + w.ends, w.ends)]
    return (f"host seconds a step: min {min(gaps):.4f} median {statistics.median(gaps):.4f} "
            f"max {max(gaps):.4f}") if gaps else ""
