"""Where the time of the blend kernels goes, on one CUDA GPU.

    python -m lara_tpu_torch.tools.profile_blend [--reps 50] [--parent DIR]

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
  4. the backward on a training micro-step's own windows: the 48 replay
     launches of one flagship fine micro-step with flash attention and
     `pallas_stash_carries=False` (`make_train_step` from micro-step 2002,
     B=3, seeded random weights), captured and replayed queued, beside the
     stash forward and the backward from the stash on the same windows,
     whose gradients the replay must equal bit for bit;
  5. the window kernel on `lara_workload`'s sorted keys at K 128 and 512,
     beside a kernel that does nothing (`torch.cuda._sleep(0)`, the floor
     of any queued launch) and the bound;
  6. each blend kernel's registers and spills (from the build log), its
     threads and shared memory per block at chunk 64 (budgets 128 and 512),
     and the blocks per SM they allow.
With `--parent DIR`, the root of another checkout of the repository (for
example the parent commit unpacked by `git archive`), the kernels are also
built from its `lara_tpu_torch/csrc`: every time above is taken for both
versions in turns (parent, change, change, parent, in one process, on the
same inputs), and each kernel's outputs of the two versions are compared
bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import torch

from lara_tpu_torch.ops import _build
from lara_tpu_torch.ops.rasterizer import cuda_blend, cuda_windows
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.tools.timing import queued_ms

CONFIGS = {"train": (128, 131072), "eval": (512, 262144)}
CHUNK = 64


@contextlib.contextmanager
def kernels_of(libs):
    """Run the wrappers on the libraries `libs` ({name: CDLL}, from
    `_build.build_other`); None keeps the port's own."""
    if libs is None:
        yield
        return
    saved = dict(_build.build_library())
    _build._libs.update(libs)
    try:
        yield
    finally:
        _build._libs.update(saved)


def in_turns(fn, versions, reps: int) -> dict:
    """{version: [queued ms, ...]} of `fn` under each of `versions`
    ([(name, libs)]); two versions are timed a, b, b, a."""
    order = versions if len(versions) == 1 else [versions[0], versions[1], versions[1],
                                                  versions[0]]
    times = {name: [] for name, _ in versions}
    for name, libs in order:
        with kernels_of(libs):
            times[name].append(queued_ms(fn, reps))
    return times


def same_across(fn, versions) -> bool:
    """Whether `fn` (returning a tensor or a tuple of them) gives the same
    bits under every version."""
    outs = []
    for _, libs in versions:
        with kernels_of(libs):
            r = fn()
        outs.append(r if isinstance(r, (tuple, list)) else (r,))
    torch.cuda.synchronize()
    return all(len(o) == len(outs[0]) and all(torch.equal(a, b) for a, b in zip(o, outs[0]))
               for o in outs[1:])


def report(what: str, times: dict, pairs: int, bnd: tuple, same=None) -> None:
    ms = {name: " ".join(f"{t:.4f}" for t in ts) for name, ts in times.items()}
    first = next(iter(times.values()))[0]
    print(f"[blend] {what}: " + "; ".join(f"{name} {v}" for name, v in ms.items())
          + f" ms queued; {pairs} processed entry-pixels; bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"{bnd[0] / first:.3f} of the first"
          + ("" if same is None else f"; outputs equal across versions: {same}"))


def carries_used(carries, ndone):
    """The written slots of the stash (0..ndone), the rest zeroed."""
    slot = torch.arange(carries.shape[1], device=carries.device)
    return torch.where((slot[None, :] <= ndone[:, None])[:, :, None, None], carries, 0.0)


def profile_windows(entries, counts, scalars, cfg, reps: int, versions) -> dict:
    """{kernel: ({version: [ms]}, bound ms, bound_by, outputs equal)} and
    the processed entry-pixels of the four blend launches on one view's
    windows."""
    from chip_smoke import BLEND_OPS, F32_FLOPS, blend_pairs, bound, nbytes

    out, carries, ndone = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)
    gen = torch.Generator().manual_seed(0)
    cot = torch.randn(out.shape, generator=gen).to(entries.device)
    grad = cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone, cot, cfg)
    pairs = blend_pairs(counts, ndone, cfg)

    def stash_fwd():
        o, c, nd = cuda_blend.blend_fwd(entries, counts, scalars, cfg, stash=True)
        return o, carries_used(c, nd), nd

    # name: (timed call, the outputs compared across versions, bytes, operations)
    calls = {
        "blend_fwd": (lambda: cuda_blend.blend_fwd(entries, counts, scalars, cfg), None,
                      nbytes(entries, counts, scalars, out), BLEND_OPS["fwd"]),
        "blend_fwd_stash": (lambda: cuda_blend.blend_fwd(entries, counts, scalars, cfg,
                                                         stash=True),
                            stash_fwd, nbytes(entries, counts, scalars, out, carries, ndone),
                            BLEND_OPS["fwd"]),
        "blend_bwd": (lambda: cuda_blend.blend_bwd(entries, counts, scalars, carries, ndone,
                                                   cot, cfg), None,
                      nbytes(entries, counts, scalars, carries, ndone, cot, grad),
                      BLEND_OPS["bwd"]),
        "blend_bwd_replay": (lambda: cuda_blend.blend_bwd_replay(entries, counts, scalars,
                                                                 cot, cfg), None,
                             nbytes(entries, counts, scalars, cot, grad), BLEND_OPS["replay"]),
    }
    if not torch.equal(calls["blend_bwd_replay"][0](), grad):
        raise AssertionError("the replay differs from the stash path")
    res = {}
    for name, (fn, outputs, moved, ops) in calls.items():
        same = same_across(outputs or fn, versions) if len(versions) > 1 else None
        res[name] = (in_turns(fn, versions, reps), *bound(moved, ops * pairs, F32_FLOPS), same)
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


def train_windows(dev) -> list:
    """The (entries, counts, scalars, cot, cfg) of every replay-backward
    launch of one flagship fine micro-step with flash attention and the
    replay backward (`make_train_step` from micro-step 2002, B=3, seeded
    random weights): 24 coarse and 24 fine renders."""
    from chip_smoke import make_batch, with_knobs
    from lara_tpu_torch.config import Config
    from lara_tpu_torch.models import LaRaNet
    from lara_tpu_torch.train.state import TrainState
    from lara_tpu_torch.train.step import make_train_step

    cfg = with_knobs(Config())
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batch = make_batch(11, cfg.n_views, dev, scenes=cfg.train.batch_size)
    state = TrainState(net, cfg.train, max_iters=30000, step=2002)
    step = make_train_step(net, state, True, cfg.train.grad_accum)
    launched, replay = [], cuda_blend.blend_bwd_replay

    def record(entries, counts, scalars, cot, rcfg, return_carries=False):
        launched.append((entries.clone(), counts.clone(), scalars.clone(),
                         cot.to(torch.float32).contiguous(), rcfg))
        return replay(entries, counts, scalars, cot, rcfg, return_carries)

    cuda_blend.blend_bwd_replay = record
    try:
        step(batch)
    finally:
        cuda_blend.blend_bwd_replay = replay
    return launched


def profile_train_windows(dev, versions) -> dict:
    """The replay backward, and the stash forward + backward, on a training
    micro-step's own 48 windows, queued in all; the replay's gradients
    equal the stash path's bit for bit."""
    from chip_smoke import BLEND_OPS, F32_FLOPS, blend_pairs, bound, nbytes

    launched = train_windows(dev)
    torch.cuda.empty_cache()
    stash = [cuda_blend.blend_fwd(e, c, s, cfg, stash=True) for e, c, s, _, cfg in launched]
    grads = [cuda_blend.blend_bwd(e, c, s, st[1], st[2], cot, cfg)
             for (e, c, s, cot, cfg), st in zip(launched, stash)]
    replayed = [cuda_blend.blend_bwd_replay(*x) for x in launched]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(replayed, grads)):
        raise AssertionError("train windows: the replay differs from the stash path")
    del replayed
    pairs = sum(blend_pairs(c, st[2], cfg) for (_, c, _, _, cfg), st in zip(launched, stash))
    moved = sum(nbytes(e, c, s, cot, g) for (e, c, s, cot, _), g in zip(launched, grads))
    stash_moved = moved + sum(nbytes(st[1], st[2]) for st in stash)

    def replay_all():
        return [cuda_blend.blend_bwd_replay(*x) for x in launched]

    def stash_all():
        return [cuda_blend.blend_bwd(e, c, s, st[1], st[2], cot, cfg)
                for (e, c, s, cot, cfg), st in zip(launched, stash)]

    res = {"launches": len(launched), "pairs": pairs}
    for name, fn, nb in (("blend_bwd_replay", replay_all, moved),
                         ("blend_bwd", stash_all, stash_moved)):
        same = same_across(fn, versions) if len(versions) > 1 else None
        times = in_turns(fn, versions, 5)
        res[name] = (times, bound(nb, BLEND_OPS["replay" if "replay" in name else "bwd"] * pairs,
                                  F32_FLOPS), same)
        report(f"train micro-step {name} x{len(launched)} (in all)", times, pairs, res[name][1],
               same)
    fwd = in_turns(lambda: [cuda_blend.blend_fwd(e, c, s, cfg, stash=True)
                            for e, c, s, _, cfg in launched], versions, 5)
    res["blend_fwd_stash"] = fwd
    print("[blend] train micro-step blend_fwd_stash x48 (in all): "
          + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in fwd.items())
          + " ms queued")
    return res


def profile_window_kernel(dev, versions) -> dict:
    """The window kernel on `lara_workload`'s sorted keys at the train and
    eval configs beside an empty kernel's queued time and the bound."""
    from chip_smoke import (F32_FLOPS, H, W, bound, camera, sorted_slot_keys, window_bytes,
                            workload_scene)
    from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels

    cam, scene, res = camera(dev), workload_scene(dev), {}
    for name, (budget, visible) in CONFIGS.items():
        cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                              visible_budget=visible, pallas_chunk=CHUNK)
        keys, starts = sorted_slot_keys(preprocess_surfels(*scene, cam, cfg), cfg)

        def fn():
            return cuda_windows.tile_windows(keys, starts, budget)

        if not torch.equal(fn(), cuda_windows.tile_windows_reference(keys, starts, budget)):
            raise AssertionError(f"{name}: tile_windows differs from its plain version")
        same = same_across(fn, versions) if len(versions) > 1 else None
        times = in_turns(fn, versions, 50)
        floor = queued_ms(lambda: torch.cuda._sleep(0))
        bnd = bound(window_bytes(starts, keys.numel(), budget), 0, F32_FLOPS)
        res[name] = (times, floor, bnd, same)
        print(f"[windows] {name} K {budget}: "
              + "; ".join(f"{k} " + " ".join(f"{t:.5f}" for t in v) for k, v in times.items())
              + f" ms queued; empty kernel {floor:.5f} ms; bound {bnd[0]:.5f} ms ({bnd[1]})"
              + ("" if same is None else f"; outputs equal across versions: {same}"))
    return res


def run(reps: int = 50, parent: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_blend needs a CUDA device")
    from chip_smoke import (BLEND_OPS, F32_FLOPS, H, N_SURFELS, W, blend_occupancy, blend_pairs,
                            bound, camera, nbytes, nvidia_smi_line, random_scene, windows,
                            workload_scene)

    print(nvidia_smi_line())
    dev = torch.device("cuda", 0)
    _build.build_library()
    versions = [("change", None)]
    if parent is not None:
        versions = [("parent", _build.build_other(Path(parent) / "lara_tpu_torch" / "csrc")),
                    ("change", None)]
    cam = camera(dev)
    scenes = {"random": random_scene(N_SURFELS, 0, dev), "lara_workload": workload_scene(dev)}
    res = {}
    for scene_name, scene in scenes.items():
        for cfg_name, (budget, visible) in CONFIGS.items():
            cfg = RasterizeConfig(height=H, width=W, tile=16, dup=3, tile_budget=budget,
                                  visible_budget=visible, pallas_chunk=CHUNK)
            entries, counts, scalars = windows(scene, cfg, cam)
            times, pairs = profile_windows(entries, counts, scalars, cfg, reps, versions)
            res[(scene_name, cfg_name)] = {"pairs": pairs, "kernels": times}
            for name, (ts, bnd, by, same) in times.items():
                report(f"{scene_name} {cfg_name} {name}", ts, pairs, (bnd, by), same)
    del scenes

    launched = request_windows(dev)
    pairs = sum(blend_pairs(c, cuda_blend.blend_fwd(e, c, s, cfg, stash=True)[2], cfg)
                for e, c, s, cfg in launched)
    moved = sum(nbytes(e, c, s) + 4 * cuda_blend.NUM_CHANNELS * e.shape[0] * 256
                for e, c, s, _ in launched)

    def request_all():
        return [cuda_blend.blend_fwd(*x) for x in launched]

    same = same_across(request_all, versions) if len(versions) > 1 else None
    times = in_turns(request_all, versions, 10)
    bnd = bound(moved, BLEND_OPS["fwd"] * pairs, F32_FLOPS)
    res["request"] = {"pairs": pairs, "ms": times, "bound": bnd, "same": same}
    report(f"request blend_fwd x{len(launched)} (in all)", times, pairs, bnd, same)
    del launched
    torch.cuda.empty_cache()

    res["train"] = profile_train_windows(dev, versions)
    torch.cuda.empty_cache()
    res["windows"] = profile_window_kernel(dev, versions)

    resources = _build.kernel_resources(_build.build_log)
    for budget in CONFIGS.values():
        occupancy = blend_occupancy(resources, CHUNK, budget[0])
        for name, (threads, smem, regs, blocks) in occupancy.items():
            r = resources[name]
            print(f"[blend] {name}: {regs} registers, spill stores {r['spill_stores']} B, loads "
                  f"{r['spill_loads']} B; {threads} threads, {smem} B shared memory per block "
                  f"at budget {budget[0]} chunk {CHUNK}: {blocks} blocks per SM")
        res[("occupancy", budget[0])] = occupancy
    print(nvidia_smi_line())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time the blend kernels")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernels are timed in turns with these")
    args = ap.parse_args(argv)
    run(args.reps, args.parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
