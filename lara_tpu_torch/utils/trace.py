"""The port's spans and counters, the counterpart of the JAX package's
`lara_tpu/utils/profiling.py:annotate`.

`span(name)` opens a `torch.profiler` range while a torch profiler is
running, and is one shared null context otherwise, so a span costs one C
call when nobody profiles; `@spanned(name)` runs each call of a function
under one. There is no switch: the spans are on exactly when someone runs
`torch.profiler` around a step, `train` or `evaluate`, and the profiler
puts them on the device kernels' clock, each kernel under the host ops
that launched it. A span is an op's range (`_RecordFunctionFast`), not a
`record_function` annotation: cheaper, and it adds no range of its own to
the device timeline, where a reader of device operations would have to
tell it from a kernel. `SPANS` names every span the program opens:

  network, network.*   `models/lara.py`: the forward and its stages;
  raster.render        `ops/renderer.py:render_view`, a first render;
  raster.rerender      `ops/renderer.py:render_view_rebind`, a re-render;
  raster.preprocess    inside both: the activations and `preprocess_surfels`;
  raster.bin           `tiled.bin_view` (first renders only);
  raster.gather        the window gather, and a re-render's repack;
  raster.post          the accumulators to images, the auxiliary maps;
  loss, backward, optimizer   `train/step.py`;
  allreduce            `train/state.py`, the gradients' all-reduce.

The blend call sits directly under `raster.render` / `raster.rerender`.

The counters are the tile binning's (`ops/rasterizer/tiled.py`), summed on
the device while a profiler runs, once per binning (a re-render reuses its
first render's):

  entries   Σ per-tile counts clamped to the tile budget K;
  slots     T·K;
  overflow  Σ max(raw count − K, 0), the entries the budget drops.

`counters()` reads them (a synchronise), `reset()` zeroes them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

SPANS = ("network", "network.vit", "network.modln", "network.feat_vol", "network.volume",
         "network.coarse_decoder", "network.fine_stage", "raster.render", "raster.rerender",
         "raster.preprocess", "raster.bin", "raster.gather", "raster.post",
         "loss", "backward", "optimizer", "allreduce")

_NULL = contextlib.nullcontext()
_slots = 0
_sums: Optional[torch.Tensor] = None   # int64 [entries, overflow], on the binning's device


def span(name: str):
    """A profiler range named `name` while a torch profiler runs, else a
    shared null context."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NULL


def spanned(name: str):
    """Decorator: the function's calls run under `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned_fn
    return wrap


def count_binning(raw: torch.Tensor, clamped: torch.Tensor, k_budget: int) -> None:
    """Adds one binning's per-tile counts [T] (raw, and clamped to
    `k_budget`) to the counters while a profiler runs; no synchronise."""
    global _slots, _sums
    if not torch.autograd._profiler_enabled():
        return
    _slots += clamped.numel() * k_budget
    sums = torch.stack([clamped.sum(dtype=torch.int64), (raw - clamped).sum(dtype=torch.int64)])
    _sums = sums if _sums is None else _sums + sums


def counters() -> Dict[str, int]:
    """{"entries", "slots", "overflow"} since the last `reset()`."""
    entries, overflow = (0, 0) if _sums is None else _sums.tolist()
    return {"entries": entries, "slots": _slots, "overflow": overflow}


def reset() -> None:
    global _slots, _sums
    _slots, _sums = 0, None
