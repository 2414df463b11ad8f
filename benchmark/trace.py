"""What a traced window holds, read from `torch.profiler`: every device
operation with its time and the benchmark's span it belongs to, the
device's busy time (the union of the operations' intervals), the idle gaps
by the span the host had open, and the blend kernels' work.

A device operation belongs to the innermost span around the host op that
launched it. A backward op has no span around it: it belongs to the span of
the forward op that made its autograd node (the profiler's sequence number
and forward thread), and so does a layer's recomputation under remat.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Optional

import torch

from benchmark.program import SPANS, blend_config

BLEND = re.compile(r"blend_(fwd|bwd)|fill_stash|sum_parts")
EVAL = "autograd::engine::evaluate_function"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# operations per processed entry-pixel of the blend (the forward's hit,
# decisions and sums; the backward walks forward again, then back with
# the derivatives and the per-entry reduction)
BLEND_OPS = {"fwd": 41, "bwd": 142}
SPAN_SET = frozenset(SPANS)


class Trace:
    """Of the untraced window: `wall_step_s`, its host seconds a step. Of
    the device-only phase: `steps`, `window_s`, `busy_s` (the union of the
    device operations' intervals). Of the span phase: `kernels`, (name,
    device µs, span name, span id) of every device operation a host op
    launched; `intervals`, (start µs, end µs) of every device operation;
    `gaps`, {span name: idle seconds}; `blend`, [(bound s, device s)] of
    the blend calls whose inputs were kept. `step_flops`: the model FLOPs
    of a step."""

    def __init__(self, steps: int, window_s: float, wall_step_s: float, step_flops: float):
        self.steps, self.window_s = steps, window_s
        self.wall_step_s, self.step_flops = wall_step_s, step_flops
        self.kernels: List[tuple] = []
        self.intervals: List[tuple] = []
        self.busy_s = 0.0
        self.gaps: Dict[str, float] = {}
        self.blend: List[tuple] = []
        self.unattributed_s = 0.0

    def device_s(self, prefix: str, blend: Optional[bool] = None) -> float:
        """Device seconds of the operations under spans named `prefix` or
        `prefix.*`; blend True / False keeps only / leaves out the blend
        kernels."""
        total = 0.0
        for name, us, span, _ in self.kernels:
            if span is None or not (span == prefix or span.startswith(prefix + ".")):
                continue
            if blend is not None and bool(BLEND.search(name)) != blend:
                continue
            total += us
        return total / 1e6

    def breakdown(self) -> Dict:
        ops = collections.Counter()
        for name, us, span, _ in self.kernels:
            ops[f"{span or 'none'}: {name[:120]}"] += us / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in
                              sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]]}


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _device_ops(prof):
    # the device timeline also carries the host's record_function ranges
    cpu_t = torch.autograd.DeviceType.CPU
    return [e for e in prof.events() if e.device_type != cpu_t and e.name not in SPAN_SET
            and not getattr(e, "is_user_annotation", False)]


def read(w, step_flops: float) -> Trace:
    """The Trace of a traced window (`benchmark/load.py:Window`): its
    device-only profile gives the busy time, its span profile (host and
    device) which span owns each device operation, the idle gaps by host
    span and the blend calls' kernels."""
    trace = Trace(w.traced_steps, w.traced_seconds, w.seconds / w.steps, step_flops)
    device_prof, span_prof, blend_calls = w.device_prof, w.span_prof, w.spans.blend_calls
    cpu_t = torch.autograd.DeviceType.CPU
    events = span_prof.events()
    cpu = [e for e in events if e.device_type == cpu_t]
    dev = _device_ops(span_prof)
    span_cache: Dict[int, object] = {}

    def span_of(e):
        chain, x, found = [], e, None
        while x is not None:
            if x.id in span_cache:
                found = span_cache[x.id]
                break
            if x.name in SPAN_SET:
                found = x
                break
            chain.append(x)
            x = x.cpu_parent
        for c in chain:
            span_cache[c.id] = found
        return found

    fwd_map = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(EVAL):
            key = (e.thread, e.sequence_nr)
            if key not in fwd_map:
                s = span_of(e)
                if s is not None:
                    fwd_map[key] = s

    def owner(op):
        s = span_of(op)
        if s is not None:
            return s
        x = op
        while x is not None and not x.name.startswith(EVAL):
            x = x.cpu_parent
        if x is None:
            return None
        return fwd_map.get((x.fwd_thread, x.sequence_nr))

    for op in cpu:
        # a span's own range on the device timeline is listed as its kernel
        ks = [k for k in op.kernels if k.name not in SPAN_SET]
        s = owner(op) if ks else None
        for k in ks:
            trace.kernels.append((k.name, k.duration, None if s is None else s.name,
                                  None if s is None else s.id))
    # device operations no host op owns (a ctypes launch under a bare span
    # in inference) stay in the breakdown as the span-less rest of their name
    rest = collections.Counter()
    for d in dev:
        rest[d.name] += d.time_range.end - d.time_range.start
    for name, us, _, _ in trace.kernels:
        rest[name] -= us
    trace.kernels += [(name, us, None, None) for name, us in rest.items() if us > 0.5]
    trace.intervals = [(d.time_range.start, d.time_range.end) for d in dev]
    blend_dev = sorted((d.time_range.start, d.time_range.end - d.time_range.start, d.name)
                       for d in dev if BLEND.search(d.name))
    trace.busy_s = _union((d.time_range.start, d.time_range.end)
                          for d in _device_ops(device_prof)) / 1e6
    linked = sum(k[1] for k in trace.kernels if k[2] is not None) / 1e6
    trace.unattributed_s = sum(e - s for s, e in trace.intervals) / 1e6 - linked
    _gaps(trace, [e for e in cpu if e.name in SPAN_SET])
    _blend(trace, [e for e in cpu if e.name == "raster.blend"], blend_calls, blend_dev)
    return trace


def _gaps(trace: Trace, spans) -> None:
    """Idle device time between operations, by the innermost span the host
    had open when the gap began."""
    iv = sorted(trace.intervals)
    steps = [e for e in spans if e.name == "step"]
    if not iv or not steps:
        return
    lo = min(e.time_range.start for e in steps)
    hi = max(e.time_range.end for e in steps)
    spans = sorted(spans, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    gaps = collections.Counter()
    end = lo
    for s, e in iv + [(hi, hi)]:
        if s > end and end < hi:
            g1 = min(s, hi)
            name = "harness"
            j = bisect.bisect_right(starts, end) - 1
            for k in range(j, max(j - 400, -1), -1):
                if spans[k].time_range.end >= end:
                    name = spans[k].name
                    break
            gaps[name] += (g1 - end) / 1e6
        end = max(end, e)
    trace.gaps = dict(gaps)


def entry_pixels(entries, counts, scalars, rcfg) -> int:
    """Entry-pixels the blend of these inputs needs: each tile's entries up
    to the chunk at which its pixels saturate, as the plain blend walks
    them (the reference's walk: nothing of the kernels)."""
    from benchmark.reference.raster import Cam, blend_blocks
    cfg = blend_config(rcfg)
    n = torch.clamp(counts.long(), max=cfg.tile_budget)
    cam = Cam(None, None, scalars[0].float(), scalars[1].float())
    with torch.no_grad():
        _, ndone = blend_blocks(entries.float(), n, cam, cfg)
    return int(torch.minimum(n, ndone * cfg.chunk).sum()) * cfg.tile * cfg.tile


def blend_bound_s(entries, counts, scalars, rcfg, backward: bool) -> float:
    """The least time of one blend call: the larger of its bytes (inputs
    read once, outputs written once) over HBM and its operations over the
    float32 peak."""
    t, k = entries.shape[0], entries.shape[1]
    p = rcfg.tile * rcfg.tile
    base = t * k * 13 * 4 + t * 4 + 8 + t * 10 * p * 4
    ep = entry_pixels(entries, counts, scalars, rcfg)
    fwd = max(base / HBM_BYTES_PER_S, BLEND_OPS["fwd"] * ep / F32_FLOPS)
    if not backward:
        return fwd
    return fwd + max((base + t * k * 13 * 4) / HBM_BYTES_PER_S, BLEND_OPS["bwd"] * ep / F32_FLOPS)


def _blend(trace: Trace, spans, calls, blend_dev) -> None:
    """Each kept blend call's bound beside its kernels' device time: the
    kernels its span owns, forward and backward; where a forward launched
    from a bare span is linked to no host op (inference), the blend kernels
    in device order, one forward launch per call."""
    spans = sorted(spans, key=lambda e: e.time_range.start)[:len(calls)]
    per_span = collections.defaultdict(lambda: [0.0, False])
    for name, us, _, sid in trace.kernels:
        if sid is not None and BLEND.search(name):
            per_span[sid][0] += us / 1e6
            per_span[sid][1] |= "bwd" in name or "sum_parts" in name
    if not per_span and all("fwd" in name for _, _, name in blend_dev[:len(spans)]):
        per_span = {span.id: [us / 1e6, False] for span, (_, us, _) in zip(spans, blend_dev)}
    for span, (entries, counts, scalars, rcfg) in zip(spans, calls):
        secs, backward = per_span.get(span.id, (0.0, False))
        if secs > 0.0:
            trace.blend.append((blend_bound_s(entries, counts, scalars, rcfg, backward), secs))
