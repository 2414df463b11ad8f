"""`lara_tpu_torch/tools/quality_report.py`: the bar holds the JAX record of
`configs/synthetic256_long.yaml` and refuses a run below it; the reader
recovers each logging interval's seconds from the trainer's cumulative
`train/steps_per_sec`, across a resume, and reads a run's folder whole or
cut short."""

import json
import shutil

import numpy as np
import pytest

from lara_tpu_torch.tools import quality_report as q


def test_bar_passes_the_jax_record():
    with open(q.RECORD_METRICS) as f:
        record = json.load(f)
    bar = q.bar_verdict(list(q.RECORD_VAL_PSNR_FINE), list(q.RECORD_VAL_SSIM_FINE), record,
                        complete=True)
    assert bar["val_psnr_fine_passes_7_10_mean"] == pytest.approx(16.0825)
    assert bar["val_ssim_fine_rise_pass_1_to_10"] == pytest.approx(0.155)
    assert all(bar[k] is True for k in ("val_psnr_fine_ok", "val_ssim_fine_ok", "eval_psnr_ok",
                                        "eval_ssim_ok"))


def test_bar_refuses_a_weaker_run_and_reads_nothing_it_lacks():
    psnr = [p - 1.5 for p in q.RECORD_VAL_PSNR_FINE]
    ssim = [q.RECORD_VAL_SSIM_FINE[0]] * 10
    bar = q.bar_verdict(psnr, ssim, {"mean_psnr": 12.0, "mean_ssim": 0.76}, complete=True)
    assert (bar["val_psnr_fine_ok"], bar["val_ssim_fine_ok"], bar["eval_psnr_ok"],
            bar["eval_ssim_ok"]) == (False, False, False, True)
    # a prefix: 6 passes, and evaluate's bar applies only to the whole schedule
    bar = q.bar_verdict(psnr[:6], ssim[:6], {"mean_psnr": 14.0, "mean_ssim": 0.8},
                        complete=False)
    assert all(bar[k] is None for k in bar)


def test_read_scalars_keeps_a_steps_last_write(tmp_path):
    path = tmp_path / "scalars.jsonl"
    recs = [("val/psnr_fine", 1.0, 4), ("train/loss", 0.5, 60), ("val/psnr_fine", 2.0, 9),
            ("val/psnr_fine", 3.0, 4)]
    path.write_text("".join(json.dumps({"tag": t, "value": v, "step": s}) + "\n"
                            for t, v, s in recs))
    assert q.read_scalars(str(path)) == {"val/psnr_fine": [(4, 3.0), (9, 2.0)],
                                         "train/loss": [(60, 0.5)]}


def trainer_log(seconds, grad_accum, first_micro=0):
    """The `train/steps_per_sec` records that `Trainer.fit` writes for one
    process whose micro-steps first_micro, first_micro + 1, ... take
    `seconds`, by its rule (train/loop.py)."""
    n, out = 10 * grad_accum, []
    clock, t_warm, micro_warm = 0.0, None, None
    for i, s in enumerate(seconds):
        micro = first_micro + i
        clock += s
        micro += 1
        if micro % n == 0:
            if t_warm is None:
                t_warm, micro_warm = clock, micro
            else:
                out.append((micro // grad_accum - 1, (micro - micro_warm) / (clock - t_warm)))
    return out


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_step_seconds_recovers_each_interval_across_a_resume(grad_accum):
    rng = np.random.default_rng(0)
    # one interval coarse, one mixed (not read), the rest fine
    n, start_fine = 10 * grad_accum, 24
    # process 1: micro-steps 0-72, cut; process 2 resumes at micro-step 95
    s1 = rng.uniform(0.5, 1.5, 73)
    s2 = rng.uniform(0.5, 1.5, 60)
    log = trainer_log(s1, grad_accum) + trainer_log(s2, grad_accum, first_micro=95)
    got = q.step_seconds(log, grad_accum, start_fine)
    # intervals from each process's second log on, by the micro-steps they hold
    want = {"coarse": [], "fine": []}
    for seconds, first in ((s1, 0), (s2, 95)):
        ends = [m for m in range(first + 1, first + len(seconds) + 1) if m % n == 0][1:]
        for m in ends:
            mean = float(np.mean(seconds[m - n - first:m - first]))
            if (m - 1) // grad_accum <= start_fine:
                want["coarse"].append(mean)
            elif (m - n) // grad_accum > start_fine:
                want["fine"].append(mean)
    assert len(want["coarse"]) == 1 and len(want["fine"]) >= 2
    for k in ("coarse", "fine"):
        assert got[k]["intervals"] == len(want[k])
        assert got[k]["median_s"] == pytest.approx(np.median(want[k]), rel=1e-12)
        assert got[k]["p90_s"] == pytest.approx(np.percentile(want[k], 90), rel=1e-12)


def write_run(out, val_epochs, metrics=None):
    """A run folder: val passes at `val_epochs` (the record's values),
    train logs every 10 micro-steps, the quality_run.sh side files."""
    recs = [{"tag": "train/steps_per_sec", "value": 1.0, "step": s}
            for s in range(19, 3000, 10)]
    for i, e in enumerate(val_epochs):
        recs += [{"tag": "val/psnr_fine", "value": q.RECORD_VAL_PSNR_FINE[i], "step": e},
                 {"tag": "val/ssim_fine", "value": q.RECORD_VAL_SSIM_FINE[i], "step": e}]
    out.mkdir()
    (out / "scalars.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    if metrics is not None:
        shutil.copy(metrics, out / "synthetic.json")
    (out / "card.txt").write_text("NVIDIA H100 80GB HBM3, 700.00 W\n")
    (out / "times.txt").write_text("train 100.5 3100.0 0\nevaluate 3100.5 3130.0 0\n")
    (out / "memory.csv").write_text("0\n12000\n11000\n")


def test_report_reads_a_whole_run(tmp_path):
    write_run(tmp_path / "run", list(range(4, 50, 5)), q.RECORD_METRICS)
    rep = q.report(str(tmp_path / "run"))
    assert rep["complete"] and rep["val"]["epochs"] == list(range(4, 50, 5))
    assert all(v is True for k, v in rep["bar"].items() if k.endswith("_ok"))
    ev = rep["evaluate"]
    assert ev["scenes"] == 20 and ev["mean_psnr"] == ev["record_mean_psnr"]
    assert ev["psnr_delta_min"] == ev["psnr_delta_max"] == 0 and ev["ssim_corr"] == pytest.approx(1)
    # constant 1 step/s: every interval reads 1 s a micro-step (start_fine 150)
    assert rep["steps"]["coarse"] == {"intervals": 14, "median_s": 1.0, "p90_s": 1.0}
    assert rep["steps"]["fine"]["intervals"] == 284 and rep["steps"]["fine"]["median_s"] == 1.0
    assert rep["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (rep["train_s"], rep["train_rc"], rep["evaluate_s"]) == (2999.5, 0, 29.5)
    assert rep["device_memory_used_max_gb"] == pytest.approx(12000 * 2 ** 20 / 1e9)


def test_report_reads_a_prefix(tmp_path):
    write_run(tmp_path / "run", list(range(4, 30, 5)))
    rep = q.report(str(tmp_path / "run"))
    assert not rep["complete"] and "evaluate" not in rep
    assert all(v is None for v in rep["bar"].values())
