"""The serving raster budgets: time per render and PSNR against the
current eval budgets, the port of `tools/sweep_eval_budgets.py`.

    python -m lara_tpu_torch.tools.sweep_eval_budgets [--device cuda] [--size 512] [--n 524288] [--quick]

`evaluate` and `make_forward` render at `RenderConfig.eval_tile_budget` /
`eval_visible_budget` (512 / 262,144). For the JAX tool's grid of (tile
budget, visible budget) the tool renders `lara_workload` from the bench
camera (forward only, through `rasterize`) and reports ms per render (a
host-clock slope ended by a synchronise; on the card also the queued
device ms) and the PSNR against the current eval budgets' render (null
where equal bit for bit).
"""

from __future__ import annotations

import argparse
import json

import torch

from lara_tpu_torch.config import RenderConfig
from lara_tpu_torch.ops.rasterizer import rasterize
from lara_tpu_torch.tools.timing import (N_SURFELS, SIZE, activated, banner, bench_camera,
                                         production_config, psnr, time_call,
                                         tool_device)
from lara_tpu_torch.tools.workload import lara_workload

GRID = ((512, 262144), (256, 262144), (256, 131072), (128, 131072))


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, quick: bool = False,
        grid=GRID) -> dict:
    dev = tool_device(device)
    banner(dev)
    args = activated(lara_workload(n, 0, dev))
    cam, bg = bench_camera(dev), torch.ones(3, device=dev)
    r = RenderConfig()

    def cfg_for(tile_budget, visible):
        return production_config(size, train=False, tile_budget=tile_budget,
                                 visible_budget=visible,
                                 pallas_chunk=min(r.pallas_chunk, tile_budget))

    def render(cfg):
        with torch.no_grad():
            return rasterize(*args, cam, bg, cfg).image

    ref = render(cfg_for(r.eval_tile_budget, r.eval_visible_budget))
    rows = []
    for tk, vk in grid:
        cfg = cfg_for(tk, vk)
        img = render(cfg)
        row = {"tile_budget": tk, "visible_budget": vk,
               **time_call(lambda c=cfg: render(c), dev, quick=quick),
               "psnr_vs_eval": psnr(img, ref)}
        rows.append(row)
        print(f"tile {tk:4d} visible {vk:7d}: {row['ms']:8.3f} ms (device "
              f"{row['dev_ms']}), PSNR vs eval {row['psnr_vs_eval']}", flush=True)
    return {"tool": "sweep_eval_budgets", "device": str(dev), "size": size, "n": n,
            "eval": [r.eval_tile_budget, r.eval_visible_budget], "rows": rows}


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
