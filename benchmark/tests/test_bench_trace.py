"""The readers of the program's own tracing on hand-made traces, and the
program's spans against what `benchmark/trace.py` reads:

  - `raster_idle_ms`, `window_fill` and `tile_overflow` read their layer and
    read nothing where the trace, or the program, has nothing for them;
  - a kernel whose owner moves from `raster.render` to a span inside it
    leaves `raster_ms` as it was;
  - the program opens the benchmark's layer-boundary spans and neither
    `step` nor `raster.blend`; its other spans are host ops' ranges, not
    annotations, so `trace.read` takes no range of theirs for a kernel.
"""

import sys

import pytest
import torch

from benchmark.program import SPANS
from benchmark.run import metric_reader
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace
from lara_tpu_torch.utils import trace as program_trace

STAGES = {"raster.preprocess", "raster.bin", "raster.gather", "raster.post"}


def _trace(busy_s=0.6, gaps=None):
    # 2 steps under each profile, 0.5 s a step untraced, busy_s under the
    # device-only profile: 0.2 s idle a step untraced at the default
    tr = Trace(steps=2, window_s=1.2, wall_step_s=0.5, step_flops=1.0)
    tr.busy_s = busy_s
    tr.gaps = {"raster.render": 0.3, "raster.rerender": 0.1, "raster.blend": 0.1,
               "backward": 0.4, "network": 0.1} if gaps is None else gaps
    return tr


@pytest.fixture
def counted(monkeypatch):
    def set_counts(entries, slots, overflow):
        monkeypatch.setattr(program_trace, "counters", lambda: {
            "entries": entries, "slots": slots, "overflow": overflow})
    return set_counts


@pytest.mark.parametrize("name", ["raster_idle_ms.train", "raster_idle_ms.serve"])
def test_raster_idle_ms(name):
    # half the span phase's idle is under raster.*: half of 200 ms a step
    assert metric_reader(name, REPO)(_trace()) == pytest.approx(100.0)
    assert metric_reader(name, REPO)(_trace(gaps={})) is None
    assert metric_reader(name, REPO)(_trace(gaps={"backward": 0.4})) == 0.0


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_binning_counters(counted, kind):
    counted(entries=300, slots=1000, overflow=100)
    assert metric_reader(f"window_fill.{kind}", REPO)(_trace()) == pytest.approx(30.0)
    assert metric_reader(f"tile_overflow.{kind}", REPO)(_trace()) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["window_fill.train", "tile_overflow.serve"])
def test_binning_counters_find_nothing(counted, monkeypatch, name):
    read = metric_reader(name, REPO)
    counted(entries=300, slots=1000, overflow=100)
    assert read(_trace(busy_s=0.0)) is None          # no operation ran on a device
    counted(entries=0, slots=0, overflow=0)
    assert read(_trace()) is None                    # no binning was traced
    # a program without the counters (the parent of this change)
    monkeypatch.setitem(sys.modules, "lara_tpu_torch.utils.trace", None)
    counted(entries=300, slots=1000, overflow=100)
    assert read(_trace()) is None


def test_moving_an_owner_inside_a_render_keeps_raster_ms():
    read = metric_reader("raster_ms.train", REPO)
    tr = _trace()
    tr.kernels = [("gemm_f32", 30_000.0, "raster.render", 1), ("sort", 5_000.0, "raster.render", 1),
                  ("blend_fwd_kernel", 8_000.0, "raster.blend", 2), ("mm", 1_000.0, "network", 3)]
    want = read(tr)
    tr.kernels = [("gemm_f32", 30_000.0, "raster.preprocess", 4),
                  ("sort", 5_000.0, "raster.bin", 5)] + tr.kernels[2:]
    assert read(tr) == pytest.approx(want) == pytest.approx(17.5)


def test_program_spans_against_the_benchmark():
    program = set(program_trace.SPANS)
    assert program - set(SPANS) == STAGES
    assert not {"step", "raster.blend"} & program
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in program_trace.SPANS:
            with program_trace.span(name):
                torch.ones(2).sum()
    events = [e for e in prof.events() if e.name in program]
    assert {e.name for e in events} == program
    assert not any(getattr(e, "is_user_annotation", False) for e in events)
