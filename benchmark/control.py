"""The readings that set a cell's limits, apart from the benchmark's runs.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] [--fault <name>]

Without `--fault`: the control. The reference with the network's products
rounded to float8 e4m3 (one scale per tensor), the precision below the
bfloat16 the configuration states, takes the program's place and is
compared with the float32 reference on the cell's inputs at its own sizes,
by the numbers the cell compares. A limit has to fail it.

With `--fault <name>`: one run of the cell with a two-second window per
seed, the program's step or forward broken underneath by one of `FAULTS`
(a fault of another kind of cell leaves it as it is), printing the
compared numbers.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from benchmark import load
from benchmark.run import ROOT, load_cell


def unchanged_state(fn, kind, state=None, **_):
    """A training step whose optimizer leaves the parameters as they were."""
    if kind != "train":
        return fn
    state.apply_gradients = lambda: (setattr(state, "step", state.step + 1), (False, {}))[1]
    return fn


def half_batch(fn, kind, **_):
    """A training step that takes the first ⌈B/2⌉ scenes of each batch and
    its mean over them."""
    if kind != "train":
        return fn

    def step(batch):
        b = next(iter(batch.values())).shape[0]
        return fn({k: v[:math.ceil(b / 2)] for k, v in batch.items()})
    return step


def altered_answer(fn, kind, **_):
    """A served request whose fine image is altered where it is produced."""
    if kind != "serve":
        return fn

    def fwd(batch):
        out = fn(batch)
        out["image_fine"] = 1.0 - out["image_fine"]
        return out
    return fwd


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


def control(workload: str, seed: int, device, root=None) -> dict:
    """The cell's compared numbers with the float8 reference in the
    program's place (its kind's `control`)."""
    root = root or ROOT
    _, _, entry, traffic, _ = load_cell(workload, root)
    ctx = load.Context(entry, traffic, seed, 0.0, False, device)
    return load.kind(traffic["kind"], root).control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's control or fault readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        if args.fault:
            from benchmark.run import run_cell
            ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=2.0, trace=0)
            line = run_cell(ns, device=device, wrap=FAULTS[args.fault])
            nums = {k: v["value"] for k, v in line["check"].items()}
        else:
            nums = control(args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": args.fault or "control_fp8", "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
