"""Where the time of one flagship training micro-step goes, on one CUDA GPU.

    python -m lara_tpu_torch.tools.profile_train [--flash] [--replay]
                                                 [--remat-policy full|dots]

Run from the repository root (it takes `make_batch` from
`chip_smoke.py`). The flagship `Config()` with seeded random weights takes
fine micro-steps (B=3 scenes of 4+4 views at 512², train raster budgets,
bf16 autocast, grad_accum 2) through `make_train_step`, from micro-step
2002 (loss gates on): two warm-up micro-steps, then MICRO_STEPS for each
measurement. `--flash` sets `model.flash_attn` (the flash-attention
kernels in the ViT), `--replay` sets `render.pallas_stash_carries=False`
(the replay blend backward), `--remat-policy` the per-layer remat policy.
It prints:
  1. the `nvidia-smi` name and power limit of the card;
  2. the host wall time per micro-step and per optimizer step;
  3. `torch.profiler` over the same micro-steps: the ops by device time,
     the device events per micro-step, their summed time and the busy
     share (union of kernel intervals / wall time under the profiler);
  4. from the same profile, the device ms a micro-step under each of the
     program's spans (as `profile_request`; a backward kernel under its
     forward op's span);
  5. peak device memory of an optimizer step (grad_accum micro-steps, so
     that every reading spans both micro-steps of a pair) with
     `model.remat` on and off, and with the blend's stash on and off (the
     replay backward).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from lara_tpu_torch.tools.profile_request import _kernel_intervals, _union_us, print_spans

MICRO_STEPS = 4


def _set_remat(net, on: bool):
    net.img_encoder.model.remat = on
    net.vol_decoder.remat = on


def _with_stash(cfg, on: bool):
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, pallas_stash_carries=on))


def main(argv=None) -> int:
    from chip_smoke import make_batch, nvidia_smi_line
    from lara_tpu_torch.config import Config
    from lara_tpu_torch.models import LaRaNet
    from lara_tpu_torch.train.state import TrainState
    from lara_tpu_torch.train.step import make_train_step

    ap = argparse.ArgumentParser(description="profile one flagship train micro-step")
    ap.add_argument("--flash", action="store_true", help="model.flash_attn=True")
    ap.add_argument("--replay", action="store_true", help="render.pallas_stash_carries=False")
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda", 0)
    print(nvidia_smi_line())
    cfg = Config()
    cfg = _with_stash(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, flash_attn=args.flash, remat_policy=args.remat_policy)), not args.replay)
    print(f"[config] flash_attn={args.flash} pallas_stash_carries={not args.replay} "
          f"remat_policy={args.remat_policy}")
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch = make_batch(11, cfg.n_views, dev, scenes=cfg.train.batch_size)
    k = cfg.train.grad_accum
    state = TrainState(net, cfg.train, max_iters=30000, step=2002)
    step = make_train_step(net, state, with_fine=True, grad_accum=k)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()

    r = MICRO_STEPS
    wall = []
    for _ in range(r):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    per_opt = [sum(wall[i:i + k]) for i in range(0, r - k + 1, k)]
    print(f"[wall] ms per fine micro-step: {' '.join(f'{w:.3f}' for w in wall)}; "
          f"median {statistics.median(wall):.3f}; ms per optimizer step "
          f"({k} micro-steps): {' '.join(f'{w:.3f}' for w in per_opt)}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(r):
            step(batch)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20,
                                    max_name_column_width=70))
    kernels = _kernel_intervals(prof)
    busy_us = _union_us(kernels)
    print(f"[profile] device events per micro-step: {len(kernels) / r:.1f}")
    print(f"[profile] device busy time per micro-step {busy_us / r / 1e3:.3f} ms of "
          f"{prof_wall_us / r / 1e3:.3f} ms wall under the profiler: busy share "
          f"{busy_us / prof_wall_us:.4f}")

    print_spans(prof, r, "micro-step")

    def peak(what):
        while state.step % k:            # start at the first micro-step of a pair
            step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            step(batch)
        torch.cuda.synchronize()
        print(f"[memory] {what}: peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB, optimizer step "
              f"({k} micro-steps) {(time.perf_counter() - t0) * 1e3:.3f} ms")

    for on in (True, False):
        _set_remat(net, on)
        peak(f"remat {'on ' if on else 'off'}")
    _set_remat(net, True)
    for on in (True, False):
        net.cfg = _with_stash(cfg, on)
        peak(f"stash {'on ' if on else 'off'} (remat on)")
    net.cfg = cfg
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
