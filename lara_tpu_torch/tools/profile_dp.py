"""Data-parallel scaling of the training run and of evaluation over the
GPUs of one host, and with `--tp K` on a (dp = procs / K, K) layout:

    python -m lara_tpu_torch.tools.profile_dp [--procs 4] [--tp 1] [--device cuda]
        [--config configs/synthetic256.yaml] [--size 256] [--out DIR]

Writes a synthetic store of 84 scenes (75 to train, 9 held out) at
`--size`², then runs `python -m torch.distributed.run --standalone
--nproc_per_node=N -m lara_tpu_torch.train` with one scene per process (a
global batch of N) for 30 micro-steps at grad_accum 1, at N = 1 and N =
`--procs`; resumes the N-process run for one epoch more; and evaluates
that run's checkpoint on the held-out scenes at a batch of N over N
processes and at a batch of 1 in one process (the last batch of 9 scenes
does not divide, so rank 0 takes it alone). Prints one JSON line: each
run's median seconds per micro-step (the trainer's `step_time_p50_s`, over
intervals of 10 micro-steps after the first), its scenes per second, the
scaling efficiency, each evaluation's wall seconds, and the largest
PSNR / SSIM difference between the two evaluations. With `--device cpu`
(gloo) it is a rehearsal, and its times are the CPU's.

With `--tp K` the N-process runs train at `train.tp=K`: a global batch of
N / K scenes, each shared by K processes (evaluation stays dp-only, as in
the JAX package). It also runs the collectives' probe (`--probe`, under
the same launcher): `Trainer.fit` of 6 fine micro-steps on a global batch
of N scenes (one loader thread) at train.tp=K, with every tp gather and
reduce-scatter synchronised and timed (`tp.timed_collectives`), then the
same micro-steps at tp=1 (dp = N). Rank 0 writes to `<out>/tp_probe.json`
the medians of the last 4 tp=K micro-steps' seconds and `tp.COUNTS`
(collectives, their bytes and seconds, batch broadcasts), its peak
memory, and both fits' losses with their relative differences (a reading
of the collectives' own time: the synchronisation stalls the overlap a
real step would have).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from lara_tpu_torch.data import write_synthetic_store
from lara_tpu_torch.parallel import tp

MICRO = 30
PROBE_STEPS, PROBE_WARM = 6, 2


def _run(args: list, env: dict) -> float:
    """Run `args` to its end (raising on a failure); its wall seconds."""
    t0 = time.perf_counter()
    out = subprocess.run(args, env=env, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{' '.join(args[:8])} ... exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return time.perf_counter() - t0


def _launch(n: int, module: str) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}", "-m", module]


def _last(path: str, tag: str) -> float:
    with open(path) as f:
        values = [d["value"] for d in map(json.loads, f) if d["tag"] == tag]
    return values[-1]


def _data(store: str, device: str) -> list:
    return [f"train_dataset.data_root={store}", f"test_dataset.data_root={store}",
            "train_dataset.n_scenes=84", "test_dataset.n_scenes=84",
            "train_dataset.num_workers=2", "train.grad_accum=1", "train.vis_every_n_steps=0",
            f"--device={device}"]


def probe(a) -> None:
    """One process of the collectives' probe (see the module docstring):
    two `Trainer.fit`s of PROBE_STEPS fine micro-steps on the same global
    batches, at train.tp=K with the tp collectives timed, then at tp=1."""
    import statistics

    from lara_tpu_torch.config import load_config
    from lara_tpu_torch.parallel.distributed import is_main, process_group, resolve_device
    from lara_tpu_torch.train.__main__ import BASE_CONFIG
    from lara_tpu_torch.train.loop import Trainer

    device = resolve_device(a.device)
    cuda = device.type == "cuda"
    store = os.path.join(a.out, "store")
    overrides = [o for o in _data(store, a.device) if not o.startswith("--")] + [
        f"train_dataset.batch_size={a.procs}", f"train.batch_size={a.procs}",
        f"test_dataset.batch_size={a.procs}", "train_dataset.num_workers=1", "train.n_epoch=1",
        f"train.limit_train_batches={PROBE_STEPS / (75 // a.procs) + 1e-6}",
        "train.limit_val_batches=0.01", "train.start_fine=-1", "train.ckpt_every_n_epoch=0"]
    fits = {}
    with process_group(device):
        for k in (a.tp, 1):
            cfg = load_config(str(BASE_CONFIG), a.config, overrides=overrides + [
                f"train.tp={k}", f"logger.dir={os.path.join(a.out, f'probe_tp{k}')}"])
            trainer = Trainer(cfg, device)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            with tp.timed_collectives(device) if k > 1 else contextlib.nullcontext():
                trainer.fit()
            fits[k] = {"log": trainer.micro_log,
                       "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None}
            del trainer
            if cuda:
                torch.cuda.empty_cache()
    if not is_main():
        return
    log, ref = fits[a.tp]["log"], fits[1]["log"]
    keep = log[PROBE_WARM:]
    out = {"step_s": statistics.median(m["seconds"] for m in keep)}
    out.update({c: statistics.median(m["tp"][c] for m in keep) for c in keep[0]["tp"]})
    out.update(dp=a.procs // a.tp, tp=a.tp, scenes=a.procs, steps=len(keep),
               peak_gb=fits[a.tp]["peak_gb"], losses=[m["loss"] for m in log],
               losses_tp1=[m["loss"] for m in ref],
               loss_rel_diff=[abs(m["loss"] - r["loss"]) / max(1.0, abs(r["loss"]))
                              for m, r in zip(log, ref)])
    with open(os.path.join(a.out, "tp_probe.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="configs/synthetic256.yaml")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="outputs/profile_dp")
    p.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.probe:
        return probe(a)
    if a.procs % a.tp:
        raise SystemExit(f"--procs {a.procs} does not divide by --tp {a.tp}")
    store = os.path.join(a.out, "store")
    if not os.path.exists(store):
        write_synthetic_store(store, n_scenes=84, n_views=12, img_size=(a.size, a.size))
    env = dict(os.environ, OMP_NUM_THREADS="1") if a.device == "cpu" else dict(os.environ)
    data = _data(store, a.device)
    res = {"procs": a.procs, "tp": a.tp, "device": a.device, "runs": {}}
    for n in sorted({1, a.procs}):
        logdir = os.path.join(a.out, f"logs{n}")
        tp_n = a.tp if n == a.procs else 1
        scenes = n // tp_n                        # the global batch, one scene per dp index
        batches = 75 // scenes                    # global batches per epoch
        epochs = -(-MICRO // batches)
        common = [a.config, *data, f"train_dataset.batch_size={scenes}",
                  f"train.batch_size={scenes}", f"test_dataset.batch_size={scenes}",
                  f"logger.dir={logdir}", f"train.tp={tp_n}",
                  f"train.limit_train_batches={MICRO / epochs / batches + 1e-6}"]
        wall = _run(_launch(n, "lara_tpu_torch.train") + common + [f"train.n_epoch={epochs}"],
                    env)
        step_s = _last(os.path.join(logdir, "scalars.jsonl"), "train/step_time_p50_s")
        res["runs"][n] = {"wall_s": wall, "micro_steps": MICRO, "step_time_p50_s": step_s,
                          "scenes_per_s": scenes / step_s, "tp": tp_n}
        if n == a.procs:
            res["resume_wall_s"] = _run(_launch(n, "lara_tpu_torch.train") + common
                                        + [f"train.n_epoch={epochs + 1}"], env)
    one, many = res["runs"][1], res["runs"][a.procs]
    res["scaling_efficiency"] = many["scenes_per_s"] / (a.procs * one["scenes_per_s"])

    if a.tp > 1:
        _run(_launch(a.procs, "lara_tpu_torch.tools.profile_dp")
             + ["--probe", f"--tp={a.tp}", f"--device={a.device}", f"--config={a.config}",
                f"--out={a.out}"], env)
        with open(os.path.join(a.out, "tp_probe.json")) as f:
            res["tp_probe"] = json.load(f)

    metrics = {}
    for n, batch in ((a.procs, a.procs), (1, 1)):
        tag = f"eval{n}"
        res[f"{tag}_wall_s"] = _run(_launch(n, "lara_tpu_torch.evaluate") + [
            a.config, "infer_dataset.dataset_name=synthetic", f"infer_dataset.data_root={store}",
            f"infer_dataset.img_size=[{a.size},{a.size}]", "infer_dataset.n_scenes=84",
            f"infer_dataset.batch_size={batch}",
            f"infer.ckpt_path={os.path.join(a.out, f'logs{a.procs}', 'ckpts')}",
            f"infer.save_folder={os.path.join(a.out, tag)}",
            f"infer.metric_path={os.path.join(a.out, tag + '_m')}", f"--device={a.device}"], env)
        with open(os.path.join(a.out, tag + "_m", "synthetic.json")) as f:
            metrics[n] = json.load(f)
    if metrics[a.procs]["scenes"] != metrics[1]["scenes"]:
        raise AssertionError(f"scenes {metrics[a.procs]['scenes']} / {metrics[1]['scenes']}")
    res["eval_scenes"] = len(metrics[1]["scenes"])
    res["eval_max_diff"] = max(abs(x - y) for k in ("psnr", "ssim")
                               for x, y in zip(metrics[a.procs][k], metrics[1][k]))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
