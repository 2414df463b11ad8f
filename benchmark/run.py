"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. `BENCHMARK.json` names the cell's
configuration (`benchmark/configs/<config>.json`) and traffic
(`benchmark/traffic/<traffic>.json`, whose `kind` names the module that
drives the program, `benchmark/kinds/<kind>.py`); the limits of its
comparison with the reference are in `benchmark/limits/<workload>.json`,
and a per-layer metric's reader is `benchmark/layer_metrics/<metric>.py`
or, failing that, the file of the metric's name before its first dot
(`network_ms.py` reads `network_ms.train` and `network_ms.serve`). With
`--trace 0` the last line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics.

A run needs as many CUDA devices as the cell asks for, and fails when it
finds fewer, when the program or its kernels are missing, or when a module
of JAX or of the JAX package has been loaded. The program builds its
kernels under `build/` of the checkout, once per checkout. The program
runs as it ships: the benchmark sets none of its host threads, memory or
garbage collection.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return min(time.perf_counter() - age, _T_IMPORT)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def load_cell(workload: str, root: Path = ROOT):
    """(the BENCHMARK.json dict, the cell, its configuration file's dict,
    its traffic file's dict, its limits)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    entry = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
    return bench, cell, entry, traffic, limits


def metric_reader(name: str, root: Path = ROOT):
    from benchmark.load import from_file
    folder = root / "benchmark" / "layer_metrics"
    path = folder / f"{name}.py"
    if not path.is_file():
        path = folder / f"{name.split('.', 1)[0]}.py"
    return from_file(path, "layer_metric").read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def judge(res: dict, limits: dict):
    """(correct, [(name, value, limit)]): every compared number within its
    limit, every step attempted finished and finite."""
    rows = [(k, res["check"].get(k, math.inf), lim) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and res["failed"] == 0 and res["attempted"] > 0, rows


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(args, device=None, wrap=None, root: Path = ROOT) -> dict:
    """One run of one cell in this process: the result's dict (the last
    line's keys) and the compared numbers. `device` and `wrap` are for
    tests: a run on the CPU, the program's step or forward replaced."""
    t_start = process_start()
    bench, cell, entry, traffic, limits = load_cell(args.workload, root)
    import torch

    from benchmark import load
    from benchmark.reference import forbidden_modules

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RuntimeError(
                f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    ctx = load.Context(entry, traffic, args.seed, args.seconds, bool(args.trace), device, wrap)
    res = load.kind(traffic["kind"], root).run(ctx)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")
    correct, rows = judge(res, limits)
    metrics = {}
    if args.trace:
        tr = res["trace"]
        for m in bench["per_layer"]:
            if _applies(m, args.workload):
                v = metric_reader(m["name"], root)(tr)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(res["end_to_end"], setup_s=res["setup_end"] - t_start)
        for m in bench["end_to_end"]:
            if _applies(m, args.workload):
                metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    notes = list(res.get("notes", ()))
    if args.trace:
        tr = res["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
        notes += [f"[trace] device seconds outside every span: {tr.unattributed_s}",
                  f"[trace] host seconds a step: {tr.window_s / tr.steps} under the "
                  f"device-only profile, {tr.wall_step_s} untraced"]
    other = {k: v for k, v in res["check"].items() if k not in limits}
    if other:
        notes.append("[check] readings without a limit: "
                     + " ".join(f"{k} {v}" for k, v in other.items()))
    line["_notes"] = notes
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line = run_cell(args)
    except Exception:  # noqa: BLE001 - any failure is a run without a result
        traceback.print_exc()
        return 1
    print(f"[card] {nvidia_smi()}", file=sys.stderr)
    for note in line.pop("_notes"):
        print(note, file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
