"""The (dp, tp) layout and the dp axis, the counterpart of
`lara_tpu/parallel/mesh.py`.

The JAX train step is one program over a `dp` mesh: the global batch is
sharded over dp (`P("dp")`), its loss is the loss of the global batch, and
jit puts in the gradient all-reduce. Here each rank is a process that holds
a contiguous slice of the global batch, and these pieces make the same step:

- `shard_batch` / `rank_slice`: rank r's slice [r·B/W, (r+1)·B/W) of a
  global batch of B scenes over W ranks; B must divide by W.
- `global_mean`: every batch mean of the loss (MSE, each scale's mean of
  MS-SSIM's `cs` and `ssim_map`, distortion, normal) is the global batch's:
  the rank's mean over its slice, divided by W, summed over the ranks
  inside autograd. MS-SSIM is a product of powers of those means, so it is
  not linear in the batch split: per-rank losses with averaged gradients
  (DDP, the Lightning reference) optimise another objective than the JAX
  package does. The sum's backward is the identity, so each rank's
  gradient is its slice's part of the global loss's gradient, and the
  gradients are **summed** over the ranks (`all_reduce_grads_`), once per
  optimizer step. (`torch.distributed.nn.functional.all_reduce` instead
  all-reduces the cotangent too, which multiplies each rank's gradient by
  W and needs a mean there.) The slices are equal, so the rank's mean over
  W is its sum over the global count.
- `all_reduce_grads_`: one all-reduce of every `.grad` buffer, flattened
  into one (`all_reduce_sum_`).
- `replicate_state`: rank 0's parameters and optimizer state on every rank.
- `make_layout`: the ranks as a (dp, tp) grid, rank r at dp index
  r // tp and tp index r % tp (JAX's `devices.reshape(n_dp, n_tp)`), with
  a process group for each row (the tp ranks of one dp index, which hold
  the same scenes) and each column (the dp ranks of one tp index). The
  batch is sliced by the dp index over the dp size; `parallel/tp.py`
  splits work over the tp group. The loss and the gradient all-reduce stay
  over the whole world (see `parallel/tp.py` for why that is right).

Without a process group each of them is the one-process computation with
no collective (`global_mean` is `torch.mean`); with a group of one rank
each gives the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from lara_tpu_torch.parallel.distributed import (broadcast_, broadcast_module_,
                                                 is_initialized, rank, world_size)


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the (dp, tp) grid. `tp_group` holds the ranks of
    its dp index, `dp_group` those of its tp index; both are None at tp=1
    (the dp group is then the whole world, and there is no tp group).
    `backend` is the tp group's ("nccl" or "gloo"), which picks the
    collectives of `parallel/tp.py`."""

    dp: int = 1
    tp: int = 1
    dp_index: int = 0
    tp_index: int = 0
    tp_group: Any = None
    dp_group: Any = None
    backend: Optional[str] = None


def make_layout(tp: int = 1) -> Layout:
    """The layout of the current world (one rank without a process group)
    at `tp` ranks per dp index. Raises unless the world size divides by
    `tp` (the JAX package drops the leftover devices). At tp > 1 every rank
    makes every row and column group, in one order, as `dist.new_group`
    requires; at tp=1 none is made."""
    world, r = world_size(), rank()
    if tp < 1 or world % tp:
        raise ValueError(f"train.tp={tp} does not divide the world size {world}: the ranks "
                         f"are arranged as (dp = world / tp, tp)")
    layout = Layout(dp=world // tp, tp=tp, dp_index=r // tp, tp_index=r % tp)
    if tp == 1:
        return layout
    rows = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(layout.dp)]
    cols = [dist.new_group(list(range(t, world, tp))) for t in range(tp)]
    return dataclasses.replace(layout, tp_group=rows[layout.dp_index],
                               dp_group=cols[layout.tp_index],
                               backend=dist.get_backend(rows[layout.dp_index]))


def check_divides(n: int, world: int, key: str, what: str = "the world size") -> None:
    """Raise unless the global batch `n` (config key `key`) divides by
    `world`, the number of ranks that split it (`what`)."""
    if n % world:
        raise ValueError(f"{key}={n} does not divide by {what} {world}: the global "
                         f"batch is split into equal slices, one per rank")


def rank_slice(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous slice of `n` items over `world` ranks (under
    tensor parallelism: the dp index over the dp size)."""
    check_divides(n, world, "the batch size")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """Rank `rank`'s slice of every entry's leading axis, `meta` too."""
    s = rank_slice(len(next(iter(batch.values()))), rank, world)
    return {k: v[s] for k, v in batch.items()}


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch, `x` being this rank's slice
    (every rank's of one shape), on every rank, differentiable."""
    m = torch.mean(x)
    if not is_initialized():
        return m
    return _SumOverRanks.apply(m / world_size())


def gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along the leading axis in rank order,
    over `group` (default: the world; under tensor parallelism the dp
    group, whose ranks hold different scenes). gloo gathers through the
    host; it has no CUDA all-gather."""
    if not is_initialized():
        return x
    src = x.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, in one all-reduce of one
    flat buffer."""
    if not is_initialized():
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    for t, s in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(s)


def all_reduce_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's `.grad` over the ranks in place (one
    all-reduce). Every `.grad` must exist."""
    all_reduce_sum_([p.grad for p in params])


def replicate_state(state) -> None:
    """Rank 0's parameters, buffers and AdamW state on every rank (a
    `train/state.py:TrainState`), in place."""
    if not is_initialized():
        return
    broadcast_module_(state.net)
    opt = state.optimizer.state
    broadcast_(opt[p][k] for p in state.params if p in opt for k in sorted(opt[p])
               if isinstance(opt[p][k], torch.Tensor))
