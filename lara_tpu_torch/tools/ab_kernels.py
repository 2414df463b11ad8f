"""The port's rasterizer switches against each other: the port of
`tools/ab_kernels.py`.

    python -m lara_tpu_torch.tools.ab_kernels [--device cuda] [--size 512] [--n 524288] [--quick]

At the production train raster config on `lara_workload` from the bench
camera, every combination of `bin_mode` (sort | count),
`pallas_stash_carries` (True: the stash forward + `blend_bwd`; False: the
replay backward) and `pack_mode` (gather | fused; with count binning the
pack is in depth order either way): the forward and forward + backward ms
of one render (`timing.timed`). The JAX tool's `pallas_cumsum` and
`pallas_tiles_per_step` are TPU kernel switches, not ported.
"""

from __future__ import annotations

import argparse
import itertools
import json

from lara_tpu_torch.tools.timing import (N_SURFELS, SIZE, banner, bench_camera,
                                         production_config, timed, tool_device)
from lara_tpu_torch.tools.workload import lara_workload

BIN_MODES, STASH, PACK_MODES = ("sort", "count"), (True, False), ("gather", "fused")


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, quick: bool = False) -> dict:
    dev = tool_device(device)
    banner(dev)
    scene, cam = lara_workload(n, 0, dev), bench_camera(dev)
    rows = []
    for bin_mode, stash, pack_mode in itertools.product(BIN_MODES, STASH, PACK_MODES):
        cfg = production_config(size, bin_mode=bin_mode, stash_carries=stash,
                                pack_mode=pack_mode)
        rows.append({"bin_mode": bin_mode, "stash_carries": stash, "pack_mode": pack_mode,
                     **timed(cfg, scene, cam, dev, quick)})
        print(rows[-1], flush=True)
    return {"tool": "ab_kernels", "device": str(dev), "size": size, "n": n, "rows": rows}


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
