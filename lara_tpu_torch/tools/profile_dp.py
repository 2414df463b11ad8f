"""Data-parallel scaling of the training run and of evaluation over the
GPUs of one host:

    python -m lara_tpu_torch.tools.profile_dp [--procs 4] [--device cuda]
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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from lara_tpu_torch.data import write_synthetic_store

MICRO = 30


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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="configs/synthetic256.yaml")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="outputs/profile_dp")
    a = p.parse_args(argv)
    store = os.path.join(a.out, "store")
    if not os.path.exists(store):
        write_synthetic_store(store, n_scenes=84, n_views=12, img_size=(a.size, a.size))
    env = dict(os.environ, OMP_NUM_THREADS="1") if a.device == "cpu" else dict(os.environ)
    data = [f"train_dataset.data_root={store}", f"test_dataset.data_root={store}",
            "train_dataset.n_scenes=84", "test_dataset.n_scenes=84",
            "train_dataset.num_workers=2", "train.grad_accum=1", "train.vis_every_n_steps=0",
            f"--device={a.device}"]
    res = {"procs": a.procs, "device": a.device, "runs": {}}
    for n in sorted({1, a.procs}):
        logdir = os.path.join(a.out, f"logs{n}")
        batches = 75 // n                         # global batches per epoch
        epochs = -(-MICRO // batches)
        common = [a.config, *data, f"train_dataset.batch_size={n}", f"train.batch_size={n}",
                  f"test_dataset.batch_size={n}", f"logger.dir={logdir}",
                  f"train.limit_train_batches={MICRO / epochs / batches + 1e-6}"]
        wall = _run(_launch(n, "lara_tpu_torch.train") + common + [f"train.n_epoch={epochs}"],
                    env)
        step_s = _last(os.path.join(logdir, "scalars.jsonl"), "train/step_time_p50_s")
        res["runs"][n] = {"wall_s": wall, "micro_steps": MICRO, "step_time_p50_s": step_s,
                          "scenes_per_s": n / step_s}
        if n == a.procs:
            res["resume_wall_s"] = _run(_launch(n, "lara_tpu_torch.train") + common
                                        + [f"train.n_epoch={epochs + 1}"], env)
    one, many = res["runs"][1], res["runs"][a.procs]
    res["scaling_efficiency"] = many["scenes_per_s"] / (a.procs * one["scenes_per_s"])

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
