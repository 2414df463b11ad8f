"""The host input pipeline's throughput over a sweep of loader threads: the
port of `tools/profile_input_pipeline.py`.

    python -m lara_tpu_torch.tools.profile_input_pipeline [--workers 1 2 4 8] [--size 512]

Writes a store of 24 synthetic sphere scenes (12 views each, `--size`²,
`data/synthetic.py:write_synthetic_store`; the port's `.npy` store, where
the JAX tool reads a gzip'd HDF5 shard) into a temporary directory, then
for each thread count runs `data/loader.py:DataLoader` over
`data/gobjverse.py:GObjaverseDataset` at the training batch (3 scenes ×
8 views with normals, shuffled) for two passes and reports the
scenes per second delivered. The first `prefetch + 1` batches are left out
of the clock: they were decoded while the threads spun up and sit ready in
the queue, so counting them measures the queue's drain, not the
pipeline's throughput (in the JAX tool, with a 24-scene shard and one
epoch, that inflated the rate ~1000×). The loader runs on the host: the
`--device` only names the machine whose card the banner reads.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.gobjverse import GObjaverseDataset
from lara_tpu_torch.data.loader import DataLoader
from lara_tpu_torch.data.synthetic import write_synthetic_store
from lara_tpu_torch.tools.timing import SIZE, banner, tool_device

WORKERS = (1, 2, 4, 8)
BATCH, N_GROUP, PREFETCH = 3, 4, 4
# 21 training scenes (every 10th is held out): 7 batches a pass, 9 of the
# two passes' 14 on the clock
SCENES, EPOCHS = 24, 2


def measure(root: str, workers: int, size: int) -> float:
    """Scenes per second over EPOCHS passes, past the first prefetch + 1
    batches."""
    cfg = DatasetConfig(data_root=root, split="train", n_group=N_GROUP, img_size=(size, size),
                        load_normal=True, n_scenes=10 ** 6)
    loader = DataLoader(GObjaverseDataset(cfg), batch_size=BATCH, shuffle=True,
                        num_workers=workers, prefetch=PREFETCH)
    n_scenes, skip, t0 = 0, PREFETCH + 1, None
    for epoch in range(EPOCHS):
        loader.set_epoch(epoch)
        for batch in loader:
            if skip:                      # spin-up: already sitting in the queue
                skip -= 1
                t0 = time.perf_counter()
                continue
            n_scenes += batch["tar_rgb"].shape[0]
    return n_scenes / (time.perf_counter() - t0)


def run(device="cuda", workers=WORKERS, size: int = SIZE) -> dict:
    dev = tool_device(device)
    banner(dev)
    rows = {}
    with tempfile.TemporaryDirectory(prefix="lara_input_") as tmp:
        root = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        write_synthetic_store(root, n_scenes=SCENES, n_views=12, img_size=(size, size))
        write_s = time.perf_counter() - t0
        store_mb = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(root) for f in fs) / 1e6
        print(f"[store] {SCENES} scenes × 12 views at {size}², {store_mb:.1f} MB, written in "
              f"{write_s:.2f} s; batch {BATCH} × {2 * N_GROUP} views with normals", flush=True)
        for w in workers:
            rows[str(w)] = measure(root, w, size)
            print(f"workers={w:3d}  {rows[str(w)]:8.2f} scenes/s", flush=True)
    return {"tool": "profile_input_pipeline", "device": str(dev), "size": size,
            "scenes": SCENES, "epochs": EPOCHS, "batch": BATCH, "views": 2 * N_GROUP,
            "store_mb": store_mb, "write_s": write_s, "scenes_per_s": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, nargs="*", default=list(WORKERS))
    ap.add_argument("--size", type=int, default=SIZE)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.workers, a.size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
