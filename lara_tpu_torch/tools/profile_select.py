"""The fine stage's top-M selection: `models/lara.py:select_top_m` (one
stable descending sort, `jax.lax.top_k`'s tie order) beside `torch.topk`,
which the fine stage called before and which breaks ties otherwise.

    python -m lara_tpu_torch.tools.profile_select [--device cuda] [--n 524288]

The scores are those of `_fine_stage`: opacity logits drawn from N(-2, σ²)
with numpy from seed 0 and rounded to bf16 (the coarse decoder's output
type), their sigmoid where it passes 0.005, else -1. For each σ and each
M of BUDGETS (131,072, the model's `fine_budget` on every path; 262,144,
the eval visible budget) the tool prints the scores tied at
the M-th value, how many of `torch.topk`'s indices are not in the exact
set, whether `select_top_m` on the device equals it on the CPU (the index
sequence and the value bits; it raises where not), and ms per call of
both: on the card queued device time (`timing.queued_ms`), on the CPU the
host's. Last line: one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from lara_tpu_torch.models.lara import select_top_m
from lara_tpu_torch.tools.timing import N_SURFELS, banner, queued_ms, tool_device

# the model's fine_budget (serving and training), and the eval visible budget
BUDGETS = (131072, 262144)
SIGMAS = (1.0, 3.0)


def fine_scores(n: int, sigma: float, device) -> torch.Tensor:
    """`_fine_stage`'s score of bf16-rounded logits from N(-2, sigma²),
    drawn with numpy from seed 0."""
    logits = np.random.default_rng(0).normal(-2.0, sigma, n).astype(np.float32)
    op = torch.sigmoid(torch.from_numpy(logits).bfloat16().float())
    return torch.where(op > 0.005, op, -1.0).to(device)


def same_selection(got, want) -> bool:
    """Equal index sequences and equal value bits."""
    (gv, gi), (wv, wi) = ((v.cpu(), i.cpu()) for v, i in (got, want))
    return torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def time_ms(fn, dev: torch.device) -> float:
    """ms per call: queued device time on the card, host time on the CPU."""
    if dev.type == "cuda":
        return queued_ms(fn, reps=20, rounds=5)
    fn()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare(score: torch.Tensor, m: int) -> dict:
    """One budget on one score vector: the ties at the M-th value, the
    indices `torch.topk` selects outside the exact set, `select_top_m`
    against itself on the CPU (raises where they differ), and the ms per
    call of `torch.topk` and `select_top_m`."""
    dev = score.device
    vals, idx = select_top_m(score, m)
    if not same_selection((vals, idx), select_top_m(score.cpu(), m)):
        raise AssertionError(f"top-M at M={m}: select_top_m on {dev} differs from the CPU's")
    old = torch.topk(score, m).indices
    exact_set = torch.zeros(score.shape[0], dtype=torch.bool, device=dev)
    exact_set[idx] = True
    return {"m": m, "tied_at_mth": int((score == vals[-1]).sum()),
            "topk_outside_exact_set": int((~exact_set[old]).sum()),
            "ms": {"torch.topk": time_ms(lambda: torch.topk(score, m), dev),
                   "select_top_m": time_ms(lambda: select_top_m(score, m), dev)}}


def run(device="cuda", n: int = N_SURFELS, budgets=BUDGETS, sigmas=SIGMAS) -> dict:
    dev = tool_device(device)
    smi = banner(dev)
    rows = []
    for sigma in sigmas:
        score = fine_scores(n, sigma, dev)
        for m in budgets:
            row = {"sigma": sigma, **compare(score, min(m, n))}
            rows.append(row)
            ms = row["ms"]
            print(f"[select] N={n} M={row['m']} sigma={sigma}: {row['tied_at_mth']} tied at "
                  f"the M-th score, torch.topk {row['topk_outside_exact_set']} indices "
                  f"outside the exact set; ms torch.topk {ms['torch.topk']:.5f}, select_top_m "
                  f"{ms['select_top_m']:.5f}", flush=True)
    return {"tool": "profile_select", "device": str(dev), "smi": smi, "n": n, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_SURFELS)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
