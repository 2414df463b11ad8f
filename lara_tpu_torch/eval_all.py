"""Benchmark suite runner of the port, the counterpart of `eval_all.py`:

    python -m lara_tpu_torch.eval_all [CKPT] [--device DEV]

runs `python -m lara_tpu_torch.evaluate` over the standard benchmark
configs (GSO, gobjaverse-test, Co3D teddybear and hydrant) as
subprocesses, one JSON per benchmark in outputs/metrics/<name>/. A run that
fails is reported and the next one starts.

Under a launcher (`python -m torch.distributed.run --nproc_per_node=N -m
lara_tpu_torch.eval_all ...`) every rank runs the benchmarks through
`evaluate.main` in its own process instead, in one process group (the
distributed evaluation; a subprocess cannot join the launcher's rendezvous
a second time), and rank 0 alone prints."""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import traceback
from typing import List, Optional

from lara_tpu_torch import evaluate
from lara_tpu_torch.parallel.distributed import is_main, process_group
from lara_tpu_torch.train.__main__ import split_device

RUNS = [
    # (name, extra overrides): eval_all.py:13-33
    ("GSO", [
        "infer_dataset.dataset_name=GSO",
        "infer_dataset.data_root=dataset/google_scanned_objects",
        "infer.eval_depth=[0.005,0.01,0.02]",
    ]),
    ("gobjeverse", [
        "infer_dataset.dataset_name=gobjeverse",
        "infer_dataset.data_root=dataset/gobjaverse/gobjaverse.h5",
        "infer_dataset.split=test",
    ]),
    ("co3d_teddybear", [
        "infer_dataset.dataset_name=gobjeverse",
        "infer_dataset.data_root=dataset/co3d_teddybear.h5",
    ]),
    ("co3d_hydrant", [
        "infer_dataset.dataset_name=gobjeverse",
        "infer_dataset.data_root=dataset/co3d_hydrant.h5",
    ]),
]


def main(argv: Optional[List[str]] = None) -> List[int]:
    """Run every benchmark with 4 input views (eval_all.py:36-49); returns
    their exit codes (1 for a run that raised under a launcher)."""
    rest, device = split_device(list(sys.argv[1:] if argv is None else argv))
    ckpt = rest[0] if rest else "ckpts/latest"
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    codes = []
    with process_group(device) if launched else contextlib.nullcontext():
        for name, overrides in RUNS:
            args = ["n_views=4", f"infer.ckpt_path={ckpt}",
                    f"infer.metric_path=outputs/metrics/{name}", *overrides,
                    *([f"--device={device}"] if device else [])]
            cmd = [sys.executable, "-m", "lara_tpu_torch.evaluate", *args]
            if is_main():
                print("+", " ".join(cmd), flush=True)
            ret = _evaluate_here(args) if launched else subprocess.call(cmd)
            if ret != 0 and is_main():
                print(f"[eval_all] {name} failed with code {ret}", flush=True)
            codes.append(ret)
    return codes


def _evaluate_here(args: List[str]) -> int:
    try:
        evaluate.main(args)
    except Exception:       # reported, and the next benchmark starts
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    main()
