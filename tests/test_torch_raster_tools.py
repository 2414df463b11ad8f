"""The port's raster validation and profiling tools (`lara_tpu_torch/tools/`:
`validate_fine_budget`, `sweep_eval_budgets`, `ab_dup`, `sweep_chunk`,
`ab_kernels`, `profile_rasterizer`, `profile_loss`,
`profile_input_pipeline`) and their shared harness `timing`.

(f) each tool's `main` with `--device cpu` at a small size prints its
    result as the last line, one JSON object with the tool's keys;
(g) the fine-budget census, the top-M selections (as sets, ties to the
    lower index as `jax.lax.top_k` breaks them) and the dup 2 / dup 3
    radius-overflow fractions equal a restatement of the JAX tools on the
    same numpy scene (a `lara_workload`-like scene: a shell of surfels
    sharing one opacity, and dust) at 64².
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models.lara import make_cameras as jax_make_cameras
from lara_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.renderer import (opacity_activation, rotation_activation,
                                   scaling_activation)
from lara_tpu_torch.tools import (ab_dup, ab_kernels, profile_input_pipeline, profile_loss,
                                  profile_rasterizer, sweep_chunk, sweep_eval_budgets, timing,
                                  validate_fine_budget)
from tests.test_torch_blend import one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--size", "32", "--n", "2048"]
TOOLS = {
    "validate_fine_budget": (validate_fine_budget, SMALL + ["--budgets", "256", "4096"],
                             {"census_op_gt_0.005", "budgets", "angles", "raster"}),
    "sweep_eval_budgets": (sweep_eval_budgets, SMALL + ["--quick"], {"rows", "eval"}),
    "ab_dup": (ab_dup, SMALL + ["--quick"], {"dup", "dup2_vs_dup3"}),
    "sweep_chunk": (sweep_chunk, SMALL + ["--quick", "--chunks", "32", "128"], {"rows"}),
    "ab_kernels": (ab_kernels, SMALL + ["--quick"], {"rows"}),
    "profile_rasterizer": (profile_rasterizer, SMALL + ["--quick"],
                           {"train", "eval", "reference"}),
    "profile_loss": (profile_loss, ["--device", "cpu", "--size", "32", "--quick"], {"terms"}),
    "profile_input_pipeline": (profile_input_pipeline,
                               ["--device", "cpu", "--size", "32", "--workers", "1"],
                               {"scenes_per_s", "store_mb", "write_s"}),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_on_cpu(name, capsys, one_torch_thread):  # noqa: F811
    mod, argv, keys = TOOLS[name]
    assert mod.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[device] cpu")
    res = json.loads(lines[-1])
    assert res["tool"] == name and res["device"] == "cpu"
    assert keys <= set(res), keys - set(res)
    if name == "validate_fine_budget":          # the census fits in 4,096
        assert res["budgets"]["4096"]["identical"]
        assert res["budgets"]["4096"]["psnr_vs_mask"] == [None] * 3
    if name == "profile_rasterizer":
        stages = res["train"]["stages"]
        assert {"preprocess", "depth_sort", "bin_view", "pack_gather", "window_gather",
                "blend_fwd", "blend_bwd", "render_fwd", "render_fwdbwd"} == set(stages)
        assert set(res["train"]["chain_fwdbwd"]) == {
            "preprocess", "preprocess_pack", "window_gather", "chain", "chain_live_binning"}
        bmm = res["train"]["bmm_per_render"]
        assert bmm["preprocess_fwd"]["calls"] >= 1 and bmm["preprocess_bwd"]["calls"] >= 1
        assert bmm["render_fwdbwd"]["device_ms"] is None          # no device time here
    if name == "sweep_chunk":
        assert [(r["chunk"], r["backward"]) for r in res["rows"]] == [
            (32, "stash"), (32, "replay"), (128, "stash"), (128, "replay")]


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_fine_budget.main(["--size", "32", "--n", "64"])


def workload_np(n, seed=0):
    """A numpy scene with `lara_workload`'s statistics: 15 % of the surfels
    on a shell with raw opacity 3.0 (one shared value), the rest dust with
    raw opacity in [-9, -5]. (means, shs, op_raw, scale_raw, quats) f32."""
    rng = np.random.default_rng(seed)
    r3 = rng.normal(size=(n, 3))
    shell = 0.28 * r3 / np.linalg.norm(r3, axis=-1, keepdims=True) + 0.01 * rng.normal(size=(n, 3))
    occupied = rng.uniform(size=n) < 0.15
    means = np.where(occupied[:, None], shell, rng.uniform(-0.5, 0.5, (n, 3)))
    op_raw = np.where(occupied, 3.0, rng.uniform(-9.0, -5.0, n))
    sc_raw = np.log(0.5 * (2.0 / 64) / 3.0) + 0.3 * rng.normal(size=(n, 2))
    return tuple(a.astype(np.float32) for a in (means, 0.3 * rng.normal(size=(n, 4, 3)),
                                                op_raw, sc_raw, rng.normal(size=(n, 4))))


def test_fine_budget_census_and_top_m_match_jax():
    """The JAX tool's census and `jax.lax.top_k` selection
    (tools/validate_fine_budget.py:62, :80-82) on the same scene: equal
    counts, equal sets, also where M cuts through the shell's tie."""
    _, _, op_raw, _, _ = workload_np(4096)
    op_act = jax.nn.sigmoid(jnp.asarray(op_raw))
    active = op_act > 0.005
    score = jnp.where(active, op_act, -1.0)
    census = int(jnp.sum(active))
    assert validate_fine_budget.census_mask(torch.from_numpy(op_raw)).sum() == census
    n_shell = int(np.sum(op_raw == 3.0))
    assert 0 < n_shell < census
    for m in (n_shell // 2, n_shell, (n_shell + census) // 2, census, 4096):
        _, idx = jax.lax.top_k(score, m)
        want = np.asarray(jnp.zeros((4096,), bool).at[idx].set(True) & active)
        got = validate_fine_budget.top_m_mask(torch.from_numpy(op_raw), m).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"M={m}")
        assert got.sum() == min(m, census)


def test_dup_overflow_matches_jax():
    """`ab_dup.radius_overflow` against the JAX tool's
    (tools/ab_dup.py:99-104) at dup 3 and 2, 64², the bench camera; the
    scales ×8, so that the footprints in pixels are those of 512²."""
    scene = workload_np(4096, seed=1)
    scene = scene[:3] + (scene[3] + np.float32(np.log(8.0)),) + scene[4:]
    c2w = jnp.eye(4).at[2, 3].set(-1.8)
    cam_j = jax_make_cameras(c2w, jnp.asarray(0.69), jnp.asarray(0.69), jnp.asarray(1.0),
                             jnp.asarray(2.6))
    means, shs, op_raw, sc_raw, quats = (jnp.asarray(a) for a in scene)
    cam_t = timing.bench_camera(torch.device("cpu"))
    for dup in (3, 2):
        cfg = JaxRasterizeConfig(height=64, width=64, tile=16, dup=dup, tile_budget=128,
                                 sh_degree=1, visible_budget=131072, backend="pallas")
        _, want = jax_preprocess(means, shs, opacity_activation(op_raw),
                                 scaling_activation(sc_raw), rotation_activation(quats),
                                 cam_j, cfg, return_overflow=True)
        got = ab_dup.radius_overflow(tuple(torch.from_numpy(a) for a in scene), cam_t,
                                     timing.production_config(64, dup=dup))
        assert got == float(want), (dup, got, float(want))
        assert got > 0.0
