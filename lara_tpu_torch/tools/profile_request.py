"""Where the time of one flagship serving request goes, on one CUDA GPU.

    python -m lara_tpu_torch.tools.profile_request [--flash]

Run from the repository root (it takes its request builder from
`chip_smoke.py`). The flagship `Config()` with seeded random weights serves
B=1 requests of 4+4 views at 512² through `make_forward`: two warm-up
requests, then REQUESTS for each measurement. `--flash` sets
`model.flash_attn` (the flash-attention kernels in the ViT); the other
training knobs (`--replay`, `--remat-policy` of `profile_train`) change
nothing in serving, which has no backward. It prints:
  1. the `nvidia-smi` name and power limit of the card;
  2. the host wall time per request, unsynchronised inside the request;
  3. `torch.profiler` over the same requests: the ops by device time, the
     device kernels per request, their summed time, and the busy share
     (union of kernel intervals / wall time of the profiled requests);
  4. from the same profile, the device ms a request under each of the
     program's spans (`lara_tpu_torch/utils/trace.py`), each kernel under
     the innermost span around the host op that launched it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import time

import torch

from lara_tpu_torch.utils import trace

REQUESTS = 5
_EVAL = "autograd::engine::evaluate_function"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _kernel_intervals(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cuda]


def span_device_ms(prof, steps: int) -> dict:
    """Device ms a step by the program's innermost span (`trace.SPANS`)
    around the host op that launched each kernel; a backward kernel counts
    under its forward op's span (the profiler's sequence number and forward
    thread), "(no span)" where no span holds the op."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def span_of(e):
        while e is not None and e.name not in trace.SPANS:
            e = e.cpu_parent
        return None if e is None else e.name

    fwd = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(_EVAL):
            fwd.setdefault((e.thread, e.sequence_nr), span_of(e))

    def owner(op):
        name, x = span_of(op), op
        if name is None:
            while x is not None and not x.name.startswith(_EVAL):
                x = x.cpu_parent
            name = None if x is None else fwd.get((x.fwd_thread, x.sequence_nr))
        return name or "(no span)"

    ms = collections.Counter()
    for op in cpu:
        for k in op.kernels:
            ms[owner(op)] += k.duration / 1e3 / steps
    return dict(ms.most_common())


def print_spans(prof, steps: int, per: str) -> None:
    ms = span_device_ms(prof, steps)
    print(f"[spans] device ms a {per} by the program's spans (Σ {sum(ms.values()):.3f}):")
    for name, v in ms.items():
        print(f"[spans] {name:<24s} {v:9.3f}")


def main(argv=None) -> int:
    from chip_smoke import make_batch, nvidia_smi_line
    from lara_tpu_torch.config import Config
    from lara_tpu_torch.models import LaRaNet
    from lara_tpu_torch.train.step import make_forward

    ap = argparse.ArgumentParser(description="profile one flagship serving request")
    ap.add_argument("--flash", action="store_true", help="model.flash_attn=True")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: no CUDA device")
    dev = torch.device("cuda", 0)
    print(nvidia_smi_line())
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, flash_attn=args.flash))
    print(f"[config] flash_attn={args.flash}")
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    fwd = make_forward(net, with_fine=True)
    batch = make_batch(0, cfg.n_views, dev)
    for _ in range(2):
        fwd(batch)
    torch.cuda.synchronize()

    r = REQUESTS
    wall = []
    for _ in range(r):
        t0 = time.perf_counter()
        fwd(batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    print(f"[wall] ms per request (unsynchronised inside): "
          f"{' '.join(f'{w:.3f}' for w in wall)}; median {statistics.median(wall):.3f}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(r):
            fwd(batch)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                    max_name_column_width=70))
    kernels = _kernel_intervals(prof)
    busy_us = _union_us(kernels)
    print(f"[profile] device events per request: {len(kernels) / r:.1f}")
    print(f"[profile] device busy time per request {busy_us / r / 1e3:.3f} ms of "
          f"{prof_wall_us / r / 1e3:.3f} ms wall under the profiler: busy share "
          f"{busy_us / prof_wall_us:.4f}")

    print_spans(prof, r, "request")
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
