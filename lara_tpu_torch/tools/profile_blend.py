"""Where the time of the blend kernels goes, on one CUDA GPU.

    python -m lara_tpu_torch.tools.profile_blend [--reps 50]

Run from the repository root. On two scenes of 524,288 surfels at 512²,
the random one of the coarse decoder at init (`chip_smoke.random_scene`)
and `tools/workload.py:lara_workload` (the statistics of a trained scene),
each binned at the train (K 128, V 131,072) and eval (K 512, V 262,144)
raster configs with chunk 64, it prints:
  1. the `nvidia-smi` name and power limit of the card;
  2. per kernel (the forward, the stash forward, the backward from the
     stash, the replay backward) the device ms per call queued behind a
     sleep kernel (`queued_ms`, so the wrapper's host cost is not in it),
     the processed entry-pixels, the bound (the larger of the bytes over
     3.35 TB/s and the operations per processed entry-pixel of
     `chip_smoke.BLEND_OPS` over 67 TFLOP/s f32) and the share of it;
  3. the forward on a serving request's own windows: the 16 launches (8
     coarse, 8 fine re-render views) of one flagship request through
     `make_forward` (seeded random weights), captured and replayed queued;
  4. each blend kernel's registers and spills (from the build log), its
     threads and shared memory per block at chunk 64, and the blocks per
     SM they allow.
"""

from __future__ import annotations

import argparse

import torch

from lara_tpu_torch.ops import _build
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.tools.profile_binning import queued_ms

CONFIGS = {"train": (128, 131072), "eval": (512, 262144)}
CHUNK = 64


def profile_windows(entries, counts, scalars, cfg, reps: int) -> dict:
    """{kernel: (queued ms, bound ms, bound_by)} and the processed
    entry-pixels of the four blend launches on one view's windows."""
    from chip_smoke import BLEND_OPS, F32_FLOPS, blend_pairs, bound, nbytes

    out, carries, ndone = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)
    gen = torch.Generator().manual_seed(0)
    cot = torch.randn(out.shape, generator=gen).to(entries.device)
    grad = cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone, cot, cfg)
    pairs = blend_pairs(counts, ndone, cfg)
    calls = {
        "blend_fwd": (lambda: cuda_blend.blend_fwd(entries, counts, scalars, cfg),
                      nbytes(entries, counts, scalars, out), BLEND_OPS["fwd"]),
        "blend_fwd_stash": (lambda: cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True),
                            nbytes(entries, counts, scalars, out, carries, ndone),
                            BLEND_OPS["fwd"]),
        "blend_bwd": (lambda: cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone,
                                                   cot, cfg),
                      nbytes(entries, counts, scalars, carries, ndone, cot, grad),
                      BLEND_OPS["bwd"]),
        "blend_bwd_replay": (lambda: cuda_blend.blend_bwd_replay(entries, counts, scalars,
                                                                 cot, cfg),
                             nbytes(entries, counts, scalars, cot, grad), BLEND_OPS["replay"]),
    }
    res = {}
    for name, (fn, moved, ops) in calls.items():
        res[name] = (queued_ms(fn, reps), *bound(moved, ops * pairs, F32_FLOPS))
    return res, pairs


def request_windows(dev) -> list:
    """The (entries, counts, scalars, cfg) of every forward launch of one
    flagship serving request (`make_forward`, seeded random weights)."""
    from chip_smoke import make_batch
    from lara_tpu_torch.config import Config
    from lara_tpu_torch.models import LaRaNet
    from lara_tpu_torch.train.step import make_forward

    cfg = Config()
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    launched, blend_fwd = [], cuda_blend.blend_fwd

    def record(entries, counts, scalars, rcfg, stash=False):
        launched.append((entries.clone(), counts.clone(), scalars.clone(), rcfg))
        return blend_fwd(entries, counts, scalars, rcfg, stash)

    cuda_blend.blend_fwd = record
    try:
        make_forward(net, with_fine=True)(make_batch(0, cfg.n_views, dev))
    finally:
        cuda_blend.blend_fwd = blend_fwd
    return launched


def run(reps: int = 50) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_blend needs a CUDA device")
    from chip_smoke import (H, N_SURFELS, W, blend_occupancy, camera, nvidia_smi_line,
                            random_scene, windows, workload_scene)

    print(nvidia_smi_line())
    dev = torch.device("cuda", 0)
    _build.build_library()
    cam = camera(dev)
    scenes = {"random": random_scene(N_SURFELS, 0, dev), "lara_workload": workload_scene(dev)}
    res = {}
    for scene_name, scene in scenes.items():
        for cfg_name, (budget, visible) in CONFIGS.items():
            cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                                  visible_budget=visible, pallas_chunk=CHUNK)
            entries, counts, scalars = windows(scene, cfg, cam)
            times, pairs = profile_windows(entries, counts, scalars, cfg, reps)
            res[(scene_name, cfg_name)] = {"pairs": pairs, "kernels": times}
            for name, (ms, bnd, by) in times.items():
                print(f"[blend] {scene_name} {cfg_name} {name}: {ms:.4f} ms queued; {pairs} "
                      f"processed entry-pixels; bound {bnd:.4f} ms ({by}), {bnd / ms:.3f} of it")
    from chip_smoke import BLEND_OPS, F32_FLOPS, blend_pairs, bound, nbytes

    launched = request_windows(dev)
    pairs = sum(blend_pairs(c, cuda_blend.blend_fwd(e, c, s, cfg, stash=True)[2], cfg)
                for e, c, s, cfg in launched)
    moved = sum(nbytes(e, c, s) + 4 * cuda_blend.NUM_CHANNELS * e.shape[0] * 256
                for e, c, s, _ in launched)
    ms = queued_ms(lambda: [cuda_blend.blend_fwd(*x) for x in launched], 10)
    bnd, by = bound(moved, BLEND_OPS["fwd"] * pairs, F32_FLOPS)
    res["request"] = {"pairs": pairs, "ms": ms, "bound": (bnd, by)}
    print(f"[blend] request blend_fwd x{len(launched)}: {ms:.4f} ms queued in all, "
          f"{ms / len(launched):.4f} per launch; {pairs} processed entry-pixels; bound "
          f"{bnd:.4f} ms ({by}), {bnd / ms:.3f} of it")
    resources = _build.kernel_resources(_build.build_log)
    occupancy = blend_occupancy(resources, CHUNK)
    for name, (threads, smem, regs, blocks) in occupancy.items():
        r = resources[name]
        print(f"[blend] {name}: {regs} registers, spill stores {r['spill_stores']} B, loads "
              f"{r['spill_loads']} B; {threads} threads, {smem} B shared memory per block at "
              f"chunk {CHUNK}: {blocks} blocks per SM")
    res["occupancy"] = occupancy
    print(nvidia_smi_line())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time the blend kernels")
    ap.add_argument("--reps", type=int, default=50)
    run(ap.parse_args(argv).reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
