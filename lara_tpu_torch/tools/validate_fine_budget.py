"""The static fine-stage surfel budget against the reference's dynamic mask:
the port of `tools/validate_fine_budget.py` and `tools/fine_budget_sweep.py`
(the two compute the same thing over two lists of M; this tool sweeps the
union).

    python -m lara_tpu_torch.tools.validate_fine_budget [--device cuda] [--size 512] [--n 524288]

The reference's fine stage renders every surfel with coarse opacity > 0.005
(lightning/network.py:381-388, 504-511: a dynamic mask); the port, as the
JAX package, keeps static shapes with the top `fine_budget` surfels by
opacity (`models/lara.py:_fine_stage`). On `lara_workload` (a trained
scene's statistics) the tool reports the census of surfels with opacity >
0.005 and, over 3 views of the bench camera turned about the y axis (0,
2.1, 4.2 rad) at the eval budgets with nothing truncated by the visible
budget (`visible_budget=0`), the PSNR of each top-M render against the
mask render and the kept fraction of the census, for M in BUDGETS.
Deselected surfels get the reference's -1e4 opacity logit. The top-M set
breaks opacity ties by the lower index, as `jax.lax.top_k` does (the
shell surfels of `lara_workload` share one opacity), and is compared as a
set. Where a top-M render equals the mask render bit for bit its PSNR is
null and `identical` true: at M at or above the census it must.
"""

from __future__ import annotations

import argparse
import json

import torch

from lara_tpu_torch.ops.renderer import render_view
from lara_tpu_torch.tools.timing import (N_SURFELS, SIZE, banner, bench_camera,
                                         production_config, psnr, tool_device)
from lara_tpu_torch.tools.workload import lara_workload

BUDGETS = (32768, 49152, 65536, 98304, 131072, 262144)
ANGLES = (0.0, 2.1, 4.2)
THRESHOLD = 0.005          # lightning/network.py:381: opacity > 0.005 is active
DISABLED_LOGIT = -1e4


def census_mask(op_raw: torch.Tensor) -> torch.Tensor:
    """The reference's dynamic mask: activated opacity > 0.005."""
    return torch.sigmoid(op_raw) > THRESHOLD


def top_m_mask(op_raw: torch.Tensor, m: int) -> torch.Tensor:
    """The fine stage's static selection: the `m` surfels of largest score
    (activated opacity where active, else -1), ties to the lower index as
    `jax.lax.top_k` breaks them, and of those the active ones."""
    active = census_mask(op_raw)
    score = torch.where(active, torch.sigmoid(op_raw), -1.0)
    keep = torch.zeros_like(active)
    keep[torch.argsort(score, descending=True, stable=True)[:m]] = True
    return keep & active


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, budgets=BUDGETS,
        seed: int = 0) -> dict:
    dev = tool_device(device)
    banner(dev)
    means, shs, op_raw, sc_raw, quats = lara_workload(n, seed, dev)
    cfg = production_config(size, train=False, visible_budget=0)
    bg = torch.ones(3, device=dev)
    cams = [bench_camera(dev, a) for a in ANGLES]
    active = census_mask(op_raw)
    census = int(active.sum())
    print(f"[census] opacity > {THRESHOLD}: {census} of {n} ({100 * census / n:.2f} %)")

    def render(keep, cam):
        with torch.no_grad():
            op = torch.where(keep, op_raw, DISABLED_LOGIT)
            return render_view(cam, None, means, shs, op, sc_raw, quats, bg, cfg)["image"]

    refs = [render(active, c) for c in cams]
    rows = {}
    for m in budgets:
        keep = top_m_mask(op_raw, m)
        imgs = [render(keep, c) for c in cams]
        rows[str(m)] = {
            "psnr_vs_mask": [psnr(i, r) for i, r in zip(imgs, refs)],
            "identical": all(torch.equal(i, r) for i, r in zip(imgs, refs)),
            "kept": int(keep.sum()),
            "kept_fraction_of_census": min(m, census) / census,
        }
        print(f"M={m:7d}: PSNR vs the mask render {rows[str(m)]['psnr_vs_mask']}, "
              f"identical {rows[str(m)]['identical']}", flush=True)
    return {"tool": "validate_fine_budget", "device": str(dev), "size": size, "n": n,
            "census_op_gt_0.005": census, "angles": list(ANGLES),
            "raster": {"tile_budget": cfg.tile_budget, "visible_budget": cfg.visible_budget},
            "budgets": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--n", type=int, default=N_SURFELS)
    ap.add_argument("--budgets", type=int, nargs="*", default=list(BUDGETS))
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.size, a.n, a.budgets)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
