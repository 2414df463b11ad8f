"""Tensor parallelism, the counterpart of `lara_tpu/parallel/tp.py`.

The tp ranks of one dp index (`parallel/mesh.py:Layout`, its `tp_group`)
hold the same scenes and split three stages of the forward between them,
as the JAX package's sharding constraints do over its `tp` mesh axis:

1. the per-view encode prefix (ViT, direction modulation, feature-volume
   sampling) over the [B·V] view rows (`shard_views`), gathered back
   before the volume transformer (`shard_batch_dim`);
2. each volume-transformer layer's group attention and MLP over the [B·G]
   group rows (`shard_groups`), gathered before the cross-group conv;
3. the render loop over the target views (`view_shard`): each rank renders
   N/tp of every scene's views, coarse and fine, and the maps of a stage
   are gathered in one flat buffer (`gather_views`) before the fine stage
   and the loss, which read every view (MS-SSIM runs its windows over the
   views tiled side by side, so a loss over a rank's views is another
   loss). When N does not divide by tp every rank renders all N views,
   with a warning, once, in the JAX package's words.

XLA puts the JAX package's collectives in; here a rank is a process, so
each is written out with its backward, under one convention.

**Gradient convention.** As on the dp axis (`parallel/mesh.py`), a rank
holds a *partial* contribution to every gradient:

- for a tensor replicated over tp, its true gradient is the SUM over the
  tp ranks of what each rank holds;
- for a tensor split over tp, each rank holds the true gradient of its
  own rows.

Two conjugate operations then carry tensors between the layouts:

| op | forward | backward |
| --- | --- | --- |
| `split` (replicated → split) | this rank's rows | the cotangent in zeros of the full shape; no collective |
| `gather` (split → replicated) | all-gather along the axis | the cotangent summed over tp, this rank's rows taken (a reduce-scatter) |

and the loss needs nothing new: `parallel/mesh.py:global_mean` divides by
the world size W and sums over all W ranks with an identity backward, so on
an input replicated over tp it is the dp mean, and it seeds each rank's
copy with 1/W, each rank's 1/tp share of the dp mean's 1/dp. Every
parameter is replicated, so every parameter gradient is a partial
contribution, and the existing single all-reduce over the world once per
optimizer step (`train/state.py`) makes it the true gradient: no second
gradient collective exists.

`split` is slicing (`narrow`), whose autograd is the table's. `gather` is
`_Gather`: NCCL's all-gather and reduce-scatter, or under gloo (which has
neither for a CUDA tensor) an all-reduce of a zero-padded buffer, exact
for the gather (x + 0 = x). Rows that do not divide by tp split as
`torch.tensor_split` does, each shard padded to the largest for the
collective; fewer rows than ranks stay replicated (no split, no gather).
Each collective adds to `COUNTS`.

The tp ranks of a dp index must hold the same batch, bit for bit: the
same scenes (each rank's loader slices the global batch by the dp index)
and the same draws of their random views and backgrounds, which a loader
takes from its dataset's one generator in whatever order its threads
reach it. `broadcast_batch` makes it so by construction: the trainer puts
the tp group's first rank's batch on every tp rank, one broadcast per
dtype and one of `meta`, per batch.

With tp off (`enable(None)` or a layout with tp=1) every function is the
identity and launches no collective. Like `tp.enable` in the JAX package,
the switch is global: the trainer sets it for its fit
(`train/loop.py`), so validation runs the split forward too; evaluation
stays dp-only, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from lara_tpu_torch.parallel.mesh import Layout

_LAYOUT: Optional[Layout] = None
_WARNED_FALLBACK = False
# collectives since `reset_counts`: gathers (forward, recomputations
# included), reductions (their backward), and the bytes each moved as the
# full gathered buffer; batch broadcasts and their bytes; under
# `timed_collectives` the seconds of the gathers and reductions
COUNTS = {"gather": 0, "reduce": 0, "gather_bytes": 0, "reduce_bytes": 0, "broadcast": 0,
          "broadcast_bytes": 0, "gather_s": 0.0, "reduce_s": 0.0}
# the device that `timed_collectives` synchronises, or None
_TIMED: Optional[torch.device] = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def enable(layout: Optional[Layout]) -> None:
    """Split over `layout`'s tp group from now on (no-op unless tp > 1);
    None disables."""
    global _LAYOUT
    _LAYOUT = layout if layout is not None and layout.tp > 1 else None


def enabled() -> bool:
    return _LAYOUT is not None


@contextlib.contextmanager
def enabled_for(layout: Optional[Layout]):
    """`enable(layout)` for the length of the block, then the previous
    state."""
    global _LAYOUT
    previous = _LAYOUT
    enable(layout)
    try:
        yield
    finally:
        _LAYOUT = previous


@contextlib.contextmanager
def timed_collectives(device):
    """In the block, synchronise `device` before and after every gather and
    reduce-scatter and add their seconds to COUNTS["gather_s"] /
    COUNTS["reduce_s"]: a reading of the collectives' own time (the
    synchronisation stalls whatever would overlap them)."""
    global _TIMED
    previous, _TIMED = _TIMED, torch.device(device)
    try:
        yield
    finally:
        _TIMED = previous


@contextlib.contextmanager
def _timed(key: str):
    device = _TIMED
    if device is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    COUNTS[key] += time.perf_counter() - t0


def broadcast_batch(batch: dict) -> dict:
    """`batch` (tensors and `meta`, as `data/loader.py:to_device` gives it)
    overwritten in place with the tp group's first rank's, one broadcast
    per dtype; the identity when tp is off."""
    if _LAYOUT is None:
        return batch
    group, src = _LAYOUT.tp_group, _LAYOUT.dp_index * _LAYOUT.tp
    tensors = [v for v in batch.values() if isinstance(v, torch.Tensor)]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        dist.broadcast(flat, src, group=group)
        for t, f in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(f)
        COUNTS["broadcast"] += 1
        COUNTS["broadcast_bytes"] += flat.numel() * flat.element_size()
    if "meta" in batch:
        meta = [batch["meta"]]
        dist.broadcast_object_list(meta, src, group=group)
        batch["meta"] = meta[0]
    return batch


def dp_group():
    """The process group of this rank's tp index (the ranks that hold other
    scenes) while tp is on; None (the whole world) when it is off."""
    return None if _LAYOUT is None else _LAYOUT.dp_group


def row_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each part of `n` rows, as `torch.tensor_split`
    splits them (the first n % parts parts one row longer)."""
    q, r = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + q + (i < r)
        bounds.append((start, stop))
        start = stop
    return bounds


def _splits(n: int) -> bool:
    return _LAYOUT is not None and n >= _LAYOUT.tp


def split(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of the replicated `x` along `dim` (all of them when
    tp is off or `x` has fewer rows than tp ranks)."""
    n = x.shape[dim]
    if not _splits(n):
        return x
    start, stop = row_bounds(n, _LAYOUT.tp)[_LAYOUT.tp_index]
    return x.narrow(dim, start, stop - start)


def gather(xs: Sequence[torch.Tensor], n: int, dim: int = 0) -> List[torch.Tensor]:
    """Each of `xs` (this rank's rows along `dim` of tensors of `n` rows,
    as `split` cut them) gathered to all `n` rows on every tp rank, in one
    collective; the identity where `split` left the rows whole."""
    if not _splits(n):
        return list(xs)
    return list(_Gather.apply(dim, n, *xs))


def shard_views(x: torch.Tensor) -> torch.Tensor:
    """A [B·V, ...] per-view tensor: this rank's view rows (the encode
    prefix is per view until the volume transformer groups them)."""
    return split(x)


def shard_groups(x: torch.Tensor) -> torch.Tensor:
    """A [B·G, ...] group-token block: this rank's group rows (the group
    attention is independent per group)."""
    return split(x)


def shard_batch_dim(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's rows of an [n, ...] tensor gathered back to all n rows:
    the layout the cross-group conv and the rasterizer consume."""
    return gather([x], n)[0]


def view_shard(n: int) -> range:
    """This rank's target views of every scene: N/tp consecutive views, or
    all N (with a warning, once) when N does not divide by tp."""
    if _LAYOUT is None:
        return range(n)
    tp = _LAYOUT.tp
    if n % tp:
        global _WARNED_FALLBACK
        if not _WARNED_FALLBACK:
            _WARNED_FALLBACK = True
            warnings.warn(
                f"tp.shard_map_render: {n} views not divisible by tp={tp}; "
                "rendering UNSHARDED on every tp rank. Pick n_views divisible "
                "by the mesh's tp axis to shard the render loop.",
                RuntimeWarning, stacklevel=2)
        return range(n)
    k = n // tp
    return range(_LAYOUT.tp_index * k, (_LAYOUT.tp_index + 1) * k)


def gather_views(maps: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """A render stage's [B, len(view_shard(n)), ...] maps gathered to all
    `n` views, every key in one collective."""
    if _LAYOUT is None or n % _LAYOUT.tp:
        return maps
    keys = list(maps)
    return dict(zip(keys, gather([maps[k] for k in keys], n, dim=1)))


class _Gather(torch.autograd.Function):
    """All-gather of row shards along `dim` over the tp group (forward) and
    reduce-scatter of the cotangents (backward), for several tensors of
    one dtype in one flat buffer: row block j of the buffer holds rank j's
    rows of every tensor, each padded to the longest shard."""

    @staticmethod
    def forward(ctx, dim: int, n: int, *xs):
        layout = _LAYOUT
        dtypes = {x.dtype for x in xs}
        if len(dtypes) != 1:
            raise TypeError(f"tp.gather takes tensors of one dtype, got {sorted(map(str, dtypes))}")
        bounds = row_bounds(n, layout.tp)
        cap = max(b - a for a, b in bounds)
        mine = bounds[layout.tp_index][1] - bounds[layout.tp_index][0]
        for x in xs:
            if x.shape[dim] != mine:
                raise ValueError(f"tp.gather: rank {layout.tp_index} holds {x.shape[dim]} rows "
                                 f"of {n} along dim {dim}, expected {mine}")
        rests = [tuple(x.movedim(dim, 0).shape[1:]) for x in xs]
        ctx.layout, ctx.dim, ctx.bounds, ctx.cap, ctx.rests = layout, dim, bounds, cap, rests
        block = torch.cat([_pad_rows(x.movedim(dim, 0), cap).reshape(-1) for x in xs])
        full = _all_gather(block, layout)                       # [tp, F]
        return tuple(o.movedim(0, dim) for o in _unpack(full, bounds, cap, rests))

    @staticmethod
    def backward(ctx, *gs):
        layout, dim, bounds, cap = ctx.layout, ctx.dim, ctx.bounds, ctx.cap
        rows = [g.movedim(dim, 0) for g in gs]
        full = torch.stack([torch.cat([_pad_rows(r[a:b], cap).reshape(-1) for r in rows])
                            for a, b in bounds])                # [tp, F]
        block = _reduce_scatter(full, layout)                   # [F]
        a, b = bounds[layout.tp_index]
        outs, off = [], 0
        for rest in ctx.rests:
            size = cap * math.prod(rest)
            outs.append(block[off:off + size].reshape(cap, *rest)[:b - a].movedim(0, dim))
            off += size
        return (None, None, *[o if need else None
                              for o, need in zip(outs, ctx.needs_input_grad[2:])])


def _pad_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    if x.shape[0] == cap:
        return x.contiguous()
    out = x.new_zeros((cap, *x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def _unpack(full: torch.Tensor, bounds, cap: int, rests) -> List[torch.Tensor]:
    """[tp, F] blocks → each tensor's [n, ...] rows in rank order."""
    outs, off = [], 0
    for rest in rests:
        size = cap * math.prod(rest)
        blocks = full[:, off:off + size].reshape(len(bounds), cap, *rest)
        outs.append(torch.cat([blocks[j, :b - a] for j, (a, b) in enumerate(bounds)]))
        off += size
    return outs


def _all_gather(block: torch.Tensor, layout: Layout) -> torch.Tensor:
    tp, group = layout.tp, layout.tp_group
    COUNTS["gather"] += 1
    COUNTS["gather_bytes"] += tp * block.numel() * block.element_size()
    with _timed("gather_s"):
        if layout.backend == "nccl":
            out = block.new_empty(tp * block.numel())
            dist.all_gather_into_tensor(out, block, group=group)
            return out.reshape(tp, -1)
        out = block.new_zeros((tp, block.numel()))
        out[layout.tp_index] = block
        dist.all_reduce(out, group=group)
        return out


def _reduce_scatter(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    group = layout.tp_group
    COUNTS["reduce"] += 1
    COUNTS["reduce_bytes"] += full.numel() * full.element_size()
    with _timed("reduce_s"):
        if layout.backend == "nccl":
            out = full.new_empty(full.shape[1])
            dist.reduce_scatter_tensor(out, full.reshape(-1), group=group)
            return out
        dist.all_reduce(full, group=group)
        return full[layout.tp_index]
