"""Reads a quality run of `configs/synthetic256_long.yaml` beside the JAX
package's record of the same config, and holds it to the bar of PERF.md §6:

    python -m lara_tpu_torch.tools.quality_report OUT

OUT is the folder that `lara_tpu_torch/tools/quality_run.sh OUT` fills: the
run's `scalars.jsonl` and the evaluate metrics `<dataset_name>.json` are
needed; `card.txt`, `times.txt` and `memory.csv` are read where present.
Prints one JSON object:

- `val`: `val/psnr_fine` and `val/ssim_fine` by epoch beside the record
  (`docs/training_quality.md`, round 5);
- `steps`: the median and 90th-percentile seconds per coarse and fine
  micro-step on the host clock, each from one logging interval of
  10·grad_accum micro-steps (the loader's wait, panels, validation and
  checkpoints included), recovered from the trainer's cumulative
  `train/steps_per_sec`;
- `evaluate`: the mean PSNR and SSIM beside the record's
  (`docs/assets/metrics256L_synthetic.json`), and per scene the range of
  the differences and the correlation with the record;
- `complete`: whether the last epoch was validated (the schedule's end);
- `bar`: each bar true, false, or null where the run lacks what it reads;
- the card, the commands' seconds and exit codes, and the most device
  memory in use, where OUT holds them.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CONFIG = REPO / "configs" / "synthetic256_long.yaml"

# the JAX package's run of configs/synthetic256_long.yaml, one val pass every 5 epochs
RECORD_VAL_PSNR_FINE = (13.38, 13.60, 15.19, 15.46, 15.32, 15.77, 16.11, 16.16, 16.18, 15.88)
RECORD_VAL_SSIM_FINE = (0.601, 0.635, 0.709, 0.733, 0.744, 0.751, 0.769, 0.763, 0.764, 0.756)
RECORD_METRICS = REPO / "docs" / "assets" / "metrics256L_synthetic.json"

# the bar (PERF.md §6), fixed before the run on the card
BAR_EVAL_PSNR = 12.5
BAR_EVAL_SSIM = 0.75
BAR_VAL_PSNR_LATE = 15.1        # mean val psnr_fine over passes 7-10
BAR_VAL_SSIM_RISE = 0.10        # val ssim_fine at pass 10 minus pass 1


def read_scalars(path: str) -> dict:
    """{tag: [(step, value), ...]} in step order, the last write of a step
    kept (a resumed run appends to the same file)."""
    by_tag: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            by_tag.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return {tag: sorted(d.items()) for tag, d in by_tag.items()}


def step_seconds(steps_per_sec: list, grad_accum: int, start_fine: int) -> dict:
    """Seconds per coarse and fine micro-step, one value per logging interval.

    The trainer logs after each 10·grad_accum micro-steps, at global step
    `micro // grad_accum - 1`; from its second log on, `steps_per_sec` is
    (micro − micro_w) / (t − t_w), micro_w and t_w those of its first log.
    A process's first interval is the one whose predecessor is missing."""
    n = 10 * grad_accum
    per: dict = {"coarse": [], "fine": []}
    prev_micro, prev_t, micro_w = None, 0.0, None
    for step, sps in steps_per_sec:
        micro = (step + 1) * grad_accum
        if prev_micro != micro - n:
            micro_w, prev_t = micro - n, 0.0
        t = (micro - micro_w) / sps
        # micro-steps micro - n .. micro - 1 run fine iff their global step > start_fine
        if (micro - 1) // grad_accum <= start_fine:
            per["coarse"].append((t - prev_t) / n)
        elif (micro - n) // grad_accum > start_fine:
            per["fine"].append((t - prev_t) / n)
        prev_micro, prev_t = micro, t
    return {k: {"intervals": len(s),
                "median_s": float(np.median(s)) if s else None,
                "p90_s": float(np.percentile(s, 90)) if s else None}
            for k, s in per.items()}


def bar_verdict(psnr_fine: list, ssim_fine: list, metrics: dict | None, complete: bool) -> dict:
    """Each bar true / false, or null where the run has not the passes (or,
    for evaluate, the whole schedule) it reads."""
    n = len(RECORD_VAL_PSNR_FINE)
    late = psnr_fine[6:n]
    out = {"val_psnr_fine_passes_7_10_mean": float(np.mean(late)) if len(late) == 4 else None,
           "val_ssim_fine_rise_pass_1_to_10":
               ssim_fine[n - 1] - ssim_fine[0] if len(ssim_fine) >= n else None}
    out["val_psnr_fine_ok"] = (None if out["val_psnr_fine_passes_7_10_mean"] is None
                               else out["val_psnr_fine_passes_7_10_mean"] >= BAR_VAL_PSNR_LATE)
    out["val_ssim_fine_ok"] = (None if out["val_ssim_fine_rise_pass_1_to_10"] is None
                               else out["val_ssim_fine_rise_pass_1_to_10"] >= BAR_VAL_SSIM_RISE)
    use_eval = complete and metrics is not None and metrics.get("mean_psnr") is not None
    out["eval_psnr_ok"] = metrics["mean_psnr"] >= BAR_EVAL_PSNR if use_eval else None
    out["eval_ssim_ok"] = metrics["mean_ssim"] >= BAR_EVAL_SSIM if use_eval else None
    return out


def per_scene(metrics: dict, record: dict) -> dict:
    """Per-scene PSNR and SSIM differences from the record (min, max) and
    the correlation with it, over the scenes both evaluated."""
    common = [s for s in metrics["scenes"] if s in record["scenes"]]
    out = {"scenes": len(common)}
    for key in ("psnr", "ssim"):
        a = np.array([metrics[key][metrics["scenes"].index(s)] for s in common])
        b = np.array([record[key][record["scenes"].index(s)] for s in common])
        out[f"{key}_delta_min"], out[f"{key}_delta_max"] = float((a - b).min()), float((a - b).max())
        out[f"{key}_corr"] = float(np.corrcoef(a, b)[0, 1])
    return out


def report(out_dir: str) -> dict:
    from lara_tpu_torch.config import load_config

    cfg = load_config(str(REPO / "configs" / "base.yaml"), str(CONFIG))
    t = cfg.train
    scalars = read_scalars(os.path.join(out_dir, "scalars.jsonl"))
    val = {k: scalars.get(f"val/{k}", []) for k in ("psnr_fine", "ssim_fine")}
    psnr_fine = [v for _, v in val["psnr_fine"]]
    ssim_fine = [v for _, v in val["ssim_fine"]]
    epochs = [e for e, _ in val["psnr_fine"]]
    complete = (t.n_epoch - 1) in epochs
    rep = {"complete": complete,
           "val": {"epochs": epochs, "psnr_fine": psnr_fine, "ssim_fine": ssim_fine,
                   "record_psnr_fine": RECORD_VAL_PSNR_FINE,
                   "record_ssim_fine": RECORD_VAL_SSIM_FINE},
           "steps": step_seconds(scalars.get("train/steps_per_sec", []), t.grad_accum,
                                 t.start_fine)}
    metrics = None
    metrics_path = os.path.join(out_dir, f"{cfg.test_dataset.dataset_name}.json")
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)
        with open(RECORD_METRICS) as f:
            record = json.load(f)
        rep["evaluate"] = {"mean_psnr": metrics["mean_psnr"], "mean_ssim": metrics["mean_ssim"],
                           "record_mean_psnr": record["mean_psnr"],
                           "record_mean_ssim": record["mean_ssim"],
                           **per_scene(metrics, record)}
    rep["bar"] = bar_verdict(psnr_fine, ssim_fine, metrics, complete)
    path = os.path.join(out_dir, "card.txt")
    if os.path.exists(path):
        rep["card"] = open(path).read().strip()
    path = os.path.join(out_dir, "times.txt")
    if os.path.exists(path):
        for line in open(path):
            name, t0, t1, rc = line.split()
            rep[f"{name}_s"], rep[f"{name}_rc"] = float(t1) - float(t0), int(rc)
    path = os.path.join(out_dir, "memory.csv")
    if os.path.exists(path):
        mib = [int(s) for s in open(path).read().split()]
        rep["device_memory_used_max_gb"] = max(mib) * 2 ** 20 / 1e9 if mib else None
    return rep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    rep = report(ap.parse_args(argv).out_dir)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
