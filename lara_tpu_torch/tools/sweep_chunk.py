"""The blend kernels' chunk (entries staged per step) with the stash and
the replay backward: the port of `tools/sweep_chunk.py`.

    python -m lara_tpu_torch.tools.sweep_chunk [--device cuda] [--size 512] [--n 524288] [--chunks 32 64 128] [--quick]

At the production train raster config on `lara_workload` from the bench
camera, for each `pallas_chunk` and each backward (`stash`:
`pallas_stash_carries=True`, the stash forward + `blend_bwd`; `replay`:
the forward + `blend_bwd_replay`): the forward and forward + backward ms
of one render (`timing.timed`). A chunk that does not divide the tile
budget, or that the replay refuses (its shared memory past 232,448 B,
`cuda_blend.kernel_smem`), gets the refusal's message as its row's result.
"""

from __future__ import annotations

import argparse
import json

from lara_tpu_torch.tools.timing import (N_SURFELS, SIZE, banner, bench_camera,
                                         production_config, timed, tool_device)
from lara_tpu_torch.tools.workload import lara_workload

CHUNKS = (32, 64, 128)
BACKWARDS = {"stash": True, "replay": False}


def run(device="cuda", size: int = SIZE, n: int = N_SURFELS, chunks=CHUNKS,
        quick: bool = False) -> dict:
    dev = tool_device(device)
    banner(dev)
    scene, cam = lara_workload(n, 0, dev), bench_camera(dev)
    rows = []
    for chunk in chunks:
        for name, stash in BACKWARDS.items():
            row = {"chunk": chunk, "backward": name}
            try:
                row.update(timed(production_config(size, pallas_chunk=chunk,
                                                   stash_carries=stash), scene, cam, dev, quick))
            except ValueError as e:            # the config or the kernel refuses the chunk
                row["refused"] = str(e)
            rows.append(row)
            print(row, flush=True)
    return {"tool": "sweep_chunk", "device": str(dev), "size": size, "n": n, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--n", type=int, default=N_SURFELS)
    ap.add_argument("--chunks", type=int, nargs="*", default=list(CHUNKS))
    ap.add_argument("--quick", action="store_true", help="few repetitions, one trial")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.size, a.n, a.chunks, a.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
