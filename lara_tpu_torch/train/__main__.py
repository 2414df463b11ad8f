"""Training entry point of the port, the counterpart of `train.py`:

    python -m lara_tpu_torch.train [config.yaml ...] [key.sub=value ...] [--device DEV]

Configs merge left to right on top of `configs/base.yaml`; trailing
key=value pairs are dotlist overrides (train_lightning.py:96-103). The run
is on the CUDA device (`--device cuda`, the default) and raises without
one; `--device cpu` runs it on the CPU with the kernels' plain versions.

Data parallelism, one process per GPU:

    python -m torch.distributed.run --nproc_per_node=N -m lara_tpu_torch.train cfg.yaml ...

Each process trains on `cuda:LOCAL_RANK` over NCCL (`--device cpu`: gloo)
on its slice of every global batch (`train/loop.py`). With `train.tp=K`
the N processes form a (dp = N / K, K) grid: K processes share each slice
and split its encode, volume-transformer groups and render loop, e.g.
dp=2×tp=2:

    python -m torch.distributed.run --nproc_per_node=4 -m lara_tpu_torch.train cfg.yaml train.tp=2
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from lara_tpu_torch.config import load_config, parse_cli
from lara_tpu_torch.parallel.distributed import is_main, process_group
from lara_tpu_torch.train.loop import Trainer

BASE_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "base.yaml"


def split_device(argv: List[str]):
    """(argv without `--device X` / `--device=X`, X or None)."""
    rest, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> Trainer:
    """Train as the command line asks; `device` (when given) overrides
    `--device`. Returns the Trainer after its fit. A process group that
    the run made from a launcher's environment is destroyed at its end."""
    rest, flag = split_device(list(sys.argv[1:] if argv is None else argv))
    device = device or flag or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lara_tpu_torch.train runs on the CUDA device, and none is "
                           "available; pass --device cpu to train on the CPU")
    paths, overrides = parse_cli(rest)
    cfg = load_config(str(BASE_CONFIG), *paths, overrides=overrides)
    if cfg.train.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)   # train_lightning.py:30
    with process_group(device):
        trainer = Trainer(cfg, device=device)
        t0 = time.time()
        stats = trainer.fit()
        dt = time.time() - t0
        if is_main():
            print(f"training finished in {dt / 3600:.2f} h; final stats: {stats}")
    return trainer


if __name__ == "__main__":
    main()
