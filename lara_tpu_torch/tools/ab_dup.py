"""The rasterizer's dup fan-out, 3 against 2: the port of `tools/ab_dup.py`.

    python -m lara_tpu_torch.tools.ab_dup [--device cuda] [--size 512] [--n 524288] [--quick]

dup 3 lets a surfel claim a 3×3 ring of tiles (a 16 px radius clamp at
16² tiles) and sorts 9·V keys; dup 2 claims 2×2 (8 px) and sorts 4·V, but
truncates more large surfels. At the production train raster config on
`lara_workload` from the bench camera, for each dup: the forward and
forward + backward ms of one render (`timing.timed`), and the share of
valid surfels whose unclamped footprint exceeds the clamp
(`preprocess_surfels(..., return_overflow=True)`); then dup 2's image
against dup 3's: max |Δ| and PSNR.
"""

from __future__ import annotations

import argparse
import json

import torch

from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.renderer import render_view
from lara_tpu_torch.tools.timing import (N_SURFELS, SIZE, activated, banner, bench_camera,
                                         production_config, psnr, timed,
                                         tool_device)
from lara_tpu_torch.tools.workload import lara_workload

DUPS = (3, 2)


def radius_overflow(scene: tuple, cam, cfg) -> float:
    """Share of the valid surfels whose footprint exceeds cfg.max_radius."""
    with torch.no_grad():
        _, overflow = preprocess_surfels(*activated(scene), cam, cfg, return_overflow=True)
    return float(overflow)


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, quick: bool = False) -> dict:
    dev = tool_device(device)
    banner(dev)
    scene = lara_workload(n, 0, dev)
    cam, bg = bench_camera(dev), torch.ones(3, device=dev)
    rows, images = {}, {}
    for dup in DUPS:
        cfg = production_config(size, dup=dup)
        rows[str(dup)] = {**timed(cfg, scene, cam, dev, quick),
                          "radius_overflow": radius_overflow(scene, cam, cfg)}
        with torch.no_grad():
            images[dup] = render_view(cam, None, *scene, bg, cfg)["image"]
        print(f"dup {dup}: {rows[str(dup)]}", flush=True)
    delta = {"max_abs": float(torch.max(torch.abs(images[2] - images[3]))),
             "psnr": psnr(images[2], images[3])}
    print(f"dup 2 against dup 3: {delta}")
    return {"tool": "ab_dup", "device": str(dev), "size": size, "n": n, "dup": rows,
            "dup2_vs_dup3": delta}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--n", type=int, default=N_SURFELS)
    ap.add_argument("--quick", action="store_true", help="few repetitions, one trial")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.size, a.n, a.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
