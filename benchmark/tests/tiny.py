"""A temporary checkout of the benchmark with tiny cells added the way a
later change adds them: new files (a configuration, traffic mixes of the
two kinds there and of a new kind, limits, per-layer metrics) and new
entries in `BENCHMARK.json`, no file that is there edited. The cells run
on the CPU, where the program's blend is its plain version.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345
# the tiny network of the program's CPU tests (tests/test_model.py:tiny_config)
TINY_MODEL = dict(encoder_dim=48, encoder_depth=2, encoder_heads=4, n_groups=[4], num_layers=2,
                  num_heads=4, view_embed_dim=8, embedding_dim=64, vol_feat_reso=8,
                  vol_embedding_reso=8, vol_embedding_out_dim=32, n_offset_groups=16,
                  fine_budget=512)
# what the bf16 program reads against the f32 reference at this size, with
# room: the control and the faults read above them (test_bench_faults.py)
TINY_LIMITS = {"tiny.train": {"loss_gap": 0.02, "grad_gap": 0.6, "update_gap": 0.4},
               "tiny.serve": {"surfel_gap": 0.1, "select_gap": 0.15, "image_gap": 0.05},
               "tiny.coarse": {"nonfinite_share": 0.0}}
DUMMY_METRIC = '''"""Steps under the device-only profile (a test's metric)."""


def read(trace):
    return float(trace.steps) if trace.steps else None
'''
# a new kind of traffic: coarse-only requests through the serving forward
DUMMY_KIND = '''"""Coarse-only requests, one after the other (a test's kind)."""

import time

import torch

from benchmark import flops, load, program, trace as trace_mod


def run(ctx):
    from lara_tpu_torch.train.step import make_forward
    cfg = program.config(ctx.entry)
    net = program.network(cfg, load.make_weights(ctx), ctx.device)
    fwd = ctx.wrap(make_forward(net, with_fine=False), net=net, kind="coarse")
    batch = load.batches(ctx, load.make_pool(ctx))
    fwd(batch(0))
    ok = []

    def run_step(i):
        ok.append(bool(torch.isfinite(fwd(batch(i))["image"]).all()))

    setup_end = time.perf_counter()
    w = load.window(ctx, run_step, 1, lambda: program.Spans(net))
    out = {"setup_end": setup_end, "attempted": len(ok), "failed": ok.count(False),
           "peak": w.peak, "end_to_end": {"coarse_scenes_per_s": w.steps / w.seconds},
           "check": {"nonfinite_share": ok.count(False) / len(ok)}}
    if ctx.trace:
        out["trace"] = trace_mod.read(w, flops.serve_step(ctx.entry, 1, ctx.traffic["size"]))
    return out
'''


def make_checkout(root: Path) -> Path:
    """Copy BENCHMARK.json and benchmark/ to `root` and add the tiny cells."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    base = json.loads((bench / "configs" / "lara_base.json").read_text())
    base["model"].update(TINY_MODEL)
    base["render"].update(tile_budget=64, eval_tile_budget=64, visible_budget=0,
                          eval_visible_budget=0, pallas_chunk=32)
    base["n_views"] = 2
    (bench / "configs" / "tiny_lara.json").write_text(json.dumps(base))
    train = json.loads((bench / "traffic" / "train.json").read_text())
    train.update(scenes_per_step=2, pool=6, size=64, trace_steps=2, keep_blend=4)
    serve = json.loads((bench / "traffic" / "serve_closed.json").read_text())
    serve.update(pool=2, size=64, warmup=1, trace_steps=3, keep_blend=4)
    coarse = dict(serve, kind="tiny_coarse")
    for name, mix in (("train", train), ("serve", serve), ("coarse", coarse)):
        (bench / "traffic" / f"tiny_{name}.json").write_text(json.dumps(mix))
    for name, lim in TINY_LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps(lim))
    (bench / "layer_metrics" / "traced_steps.py").write_text(DUMMY_METRIC)
    (bench / "kinds" / "tiny_coarse.py").write_text(DUMMY_KIND)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_lara", "source": "tests/test_model.py",
                            "file": "benchmark/configs/tiny_lara.json",
                            "reduced": sorted(TINY_MODEL), "why": "a test's cell"})
    for kind in ("train", "serve", "coarse"):
        spec["workloads"].append({"name": f"tiny.{kind}", "config": "tiny_lara",
                                  "traffic": f"tiny_{kind}", "chips": 1, "why": "a test's cell"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) for w in m["workloads"]):
                m["workloads"].append(f"tiny.{kind}")
    spec["end_to_end"].append({"name": "coarse_scenes_per_s", "unit": "scenes/s",
                               "better": "higher", "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny.coarse"]})
    # traced_steps.py reads both; network_ms.coarse is read by network_ms.py
    spec["per_layer"] += [
        {"name": "traced_steps.tiny", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "blend kernels",
         "moves": "serve_scenes_per_s", "workloads": ["tiny.serve"]},
        {"name": "traced_steps.coarse", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "step entry",
         "moves": "coarse_scenes_per_s", "workloads": ["tiny.coarse"]},
        {"name": "network_ms.coarse", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "network",
         "moves": "coarse_scenes_per_s", "workloads": ["tiny.coarse"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root: Path, workload: str, trace: int = 0, wrap=None, seed: int = SEED,
        seconds: float = 1.0) -> dict:
    from benchmark.run import run_cell
    torch.set_num_threads(4)
    ns = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    return run_cell(ns, device=torch.device("cpu"), wrap=wrap, root=root)
