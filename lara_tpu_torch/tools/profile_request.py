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
  4. a stage breakdown with `torch.cuda.synchronize()` around every stage,
     which serialises host and device and so adds up to more than (2).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import statistics
import time
from contextlib import contextmanager

import torch

REQUESTS = 5


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


@contextmanager
def _stage_timers(net, times):
    """Patch the path's stage functions with synchronised timers; undo on exit."""
    from lara_tpu_torch.models import vit
    from lara_tpu_torch.ops import renderer
    from lara_tpu_torch.ops.rasterizer import api, cuda, cuda_blend

    def timed(name, fn):
        @functools.wraps(fn)
        def w(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return r
        return w

    patches = [
        (net, "encode_images", "encode_images (ViT + ModLN)"),
        (net, "build_feat_vol", "build_feat_vol"),
        (net.vol_decoder, "forward", "vol_decoder"),
        (net.decoder, "forward_coarse", "coarse decoder"),
        (net, "_fine_stage", "fine_stage (top-M + grid_sample + decoder)"),
        (cuda, "preprocess_surfels", "preprocess (coarse)"),
        (api, "preprocess_surfels", "preprocess (fine rebind)"),
        (cuda, "bin_view", "bin_view (sort + windows)"),
        (api, "repack_from_binned", "repack (fine rebind)"),
        (cuda, "window_gather", "window_gather"),
        (cuda_blend, "blend_tiles", "blend kernel"),
        (vit, "flash_mha", "flash attention forward (with --flash)"),
        (renderer, "_postprocess", "postprocess (normals)"),
    ]
    saved = []
    for obj, attr, name in patches:
        had_own = attr in vars(obj)
        orig = getattr(obj, attr)
        saved.append((obj, attr, had_own, orig))
        setattr(obj, attr, timed(name, orig))
    try:
        yield
    finally:
        for obj, attr, had_own, orig in reversed(saved):
            if had_own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)


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

    times = collections.defaultdict(float)
    with _stage_timers(net, times):
        fwd(batch)                       # warm the patched path
        times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(r):
            fwd(batch)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) * 1e3 / r
    print(f"[stages] synchronised request {synced:.3f} ms; stages in ms per request:")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"[stages] {name:<45s} {ms / r:9.3f}")
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
