"""The port's tensor parallelism against the JAX package's dp×tp mesh and
against the port at tp=1, on the CPU: gloo ranks spawned by
`torch.multiprocessing` as tests/test_torch_parallel.py spawns them (the
rank bodies are in tests/torch_parallel_workers.py, which imports no JAX);
`tests/test_model.py:tiny_config` in f32 (2 volume-transformer layers,
2 input + 2 supervision views, 64 voxel groups per scene).

Bars:
- dp=1×tp=2 against JAX `value_and_grad` of `compute_losses` on the global
  batch of 2 at step 2002 (tests/test_torch_parallel.py's `jax_side`): the
  loss at atol 1e-5, the all-reduced gradient within 5e-3 relative L2 per
  parameter;
- dp=2×tp=2 (four ranks) against the port at tp=1 on that batch: the loss
  within 5e-4 relative (tests/test_train.py:110), the gradient within 5e-3
  relative L2 per parameter, the four ranks' parameters bit for bit after
  one AdamW update;
- tp=3 on N=4 target views: the render split falls back with one warning
  in the JAX package's words, and the uneven splits of the 4 encode rows
  (2, 1, 1) and the 128 group rows (43, 43, 42) give tp=1's loss (5e-4);
- the collectives: at tp=1 none but the gradient all-reduce (one per
  optimizer step); at tp=2 the count reckoned from the code (below);
- the split / gather pair: the sum over the ranks of each rank's
  gradients is the one-process gradient (float64, 1e-12);
- `Trainer.fit` at train.tp=2 on two ranks against a tp=1 fit of the same
  micro-steps: the same batches on both ranks, rank 0 alone writing,
  equal parameters, each loss within 5e-4 relative;
- the same batches on both ranks also with 4 loader threads per rank and
  epochs stopped early (`tp.broadcast_batch`, also held alone).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from lara_tpu_torch.data import write_synthetic_store
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.parallel import tp
from lara_tpu_torch.parallel.mesh import make_layout
from lara_tpu_torch.train import checkpoint as ckpt
from lara_tpu_torch.train import loop
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_train_step
from tests import torch_parallel_workers as workers
from tests.test_torch_blend import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import GRAD_RTOL, STEP, TRAIN, _fit_config, jax_side  # noqa: F401

LOSS_RTOL = 5e-4
FALLBACK = ("tp.shard_map_render: 4 views not divisible by tp=3; rendering UNSHARDED on "
            "every tp rank. Pick n_views divisible by the mesh's tp axis to shard the "
            "render loop.")


def reckoned(cfg, fine: bool, views_split: bool = True) -> dict:
    """The collectives of one micro-step at tp=2 (grad_accum 1) from the
    code: forward gathers of the encode (1), of each volume-transformer
    layer (L) and of each render stage (coarse, fine); the backward's
    reduce-scatter of each; the recomputed gather of each layer under
    remat; then the one gradient all-reduce. Under gloo each gather and
    reduction is an all-reduce."""
    layers = cfg.model.num_layers
    forward = 1 + layers + (1 + fine) * views_split
    regathers = layers if cfg.model.remat else 0
    return {"forward": forward, "reduce": forward, "gather": forward + regathers,
            "all_reduces": 2 * forward + regathers + 1}


@pytest.fixture(scope="module")
def tp2(jax_side, tmp_path_factory):
    """tp_body on dp=1×tp=2, with the tp=1 counts and the split / gather
    pair."""
    cfg, weights, batch, _ = jax_side
    return workers.run_ranks(workers.tp_body, 2, str(tmp_path_factory.mktemp("tp2")), 2, cfg,
                             weights, batch, TRAIN, STEP, True)


@pytest.fixture(scope="module")
def tp1(jax_side):
    """The port at tp=1 in one process on the batch of 2: the fine
    micro-step's loss and its gradient before the clip."""
    cfg, weights, batch, _ = jax_side
    grads = []
    with workers._recording_clip(grads):
        net = workers._net(cfg, weights)
        stats = make_train_step(net, TrainState(net, TRAIN, max_iters=10 ** 6, step=STEP),
                                with_fine=True)(batch)
    names = [n for n, _ in net.named_parameters()]
    return stats["loss"].item(), dict(zip(names, grads[0]))


def _rel_l2(got, want) -> float:
    return (torch.linalg.vector_norm(got - want)
            / max(torch.linalg.vector_norm(want).item(), 1e-12)).item()


def _check_grads(grads: dict, want: dict, tag: str) -> float:
    assert set(grads) == set(want)
    worst = 0.0
    for name, g in grads.items():
        rel = _rel_l2(g, want[name])
        worst = max(worst, rel)
        assert rel <= GRAD_RTOL, f"{tag} {name}: relative L2 {rel:.3e}"
    return worst


def test_tp2_matches_jax(jax_side, tp2):
    """Case 1: dp=1×tp=2, the loss and all-reduced gradient against JAX's
    on the global batch."""
    _, _, _, ((want, _), want_g) = jax_side
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g["params"]))
    for r in tp2:
        assert r["layout"][:2] == (1, 2)
        np.testing.assert_allclose(r["fine"]["stats"]["loss"], float(want), atol=1e-5)
        worst = _check_grads(r["grads"], want_g, "tp=2 against JAX")
        assert any(g.abs().max() > 0 for n, g in r["grads"].items()
                   if n.startswith("decoder.mlp_fine."))
    print(f"tp=2 against JAX: loss {tp2[0]['fine']['stats']['loss']:.7f} / {float(want):.7f}, "
          f"largest relative L2 of a gradient {worst:.3e}")
    assert tp2[0]["layout"][2:] == (0, 0) and tp2[1]["layout"][2:] == (0, 1)


def test_tp2_ranks_agree_and_match_tp1(tp2, tp1):
    """Case 1 against the port at tp=1: the loss within 5e-4, the gradient
    within 5e-3; the two ranks' stats and updated parameters bit for bit."""
    want, want_g = tp1
    for r in tp2:
        assert abs(r["fine"]["stats"]["loss"] - want) <= LOSS_RTOL * max(1.0, abs(want))
        _check_grads(r["grads"], want_g, "tp=2 against tp=1")
    a, b = tp2
    assert a["fine"]["stats"] == b["fine"]["stats"] and a["coarse"]["stats"] == b["coarse"]["stats"]
    assert all(torch.equal(p, b["params"][n]) for n, p in a["params"].items())
    assert a["warnings"] == b["warnings"] == []


@pytest.mark.parametrize("kind", ["fine", "coarse"])
def test_tp2_collectives_match_the_reckoning(jax_side, tp2, kind):
    """Case 4 at tp=2: every gather, reduction and all-reduce of a
    micro-step is one the code accounts for, and the forward's are the
    forward's."""
    cfg = jax_side[0]
    want = reckoned(cfg, kind == "fine")
    for r in tp2:
        got = r[kind]
        assert got["forward"]["gather"] == want["forward"] and got["forward"]["reduce"] == 0
        assert got["forward_all_reduces"] == want["forward"]
        assert got["step"]["gather"] == want["gather"] and got["step"]["reduce"] == want["reduce"]
        assert got["all_reduces"] == want["all_reduces"], (got, want)


@pytest.mark.parametrize("kind", ["fine", "coarse"])
def test_tp1_launches_no_collective(tp2, kind):
    """Case 4 at tp=1 (dp=2 on the same two ranks): the gradient all-reduce
    alone, no tp collective, nothing in the forward."""
    for r in tp2:
        got = r["tp1"][kind]
        assert got["all_reduces"] == 1 and got["forward_all_reduces"] == 0
        assert set(got["step"].values()) == {0}


def test_split_gather_grads_sum_to_one_process(tp2):
    """Case 5: for a function replicated after a gather, the sum over the
    ranks of each rank's gradients is the one-process gradient."""
    tp.enable(None)
    want = workers.split_gather_grads(7)
    parts = [r["split_gather"] for r in tp2]
    assert all(p["loss"] == parts[0]["loss"] for p in parts)
    np.testing.assert_allclose(parts[0]["loss"], want["loss"], rtol=1e-12)
    for key in ("x", "w"):
        assert not torch.equal(parts[0][key], want[key])       # partial on each rank
        torch.testing.assert_close(sum(p[key] for p in parts), want[key], rtol=1e-12, atol=1e-12)


def test_broadcast_batch_gives_every_tp_rank_the_first_ones(tp2):
    """`tp.broadcast_batch`: both ranks end with rank 0's batch, bit for bit
    (each dtype in one broadcast), `meta` included."""
    want = workers.batch_of(0)
    for r in tp2:
        got = r["broadcast"]["batch"]
        assert got.keys() == want.keys() and got["meta"] == want["meta"]
        assert all(torch.equal(got[k], v) for k, v in want.items() if k != "meta")
        assert r["broadcast"]["counts"]["broadcast"] == 3          # float32, float64, int64
        assert r["broadcast"]["counts"]["gather"] == 0
    with tp.enabled_for(None):
        batch = workers.batch_of(1)
        assert tp.broadcast_batch(batch) is batch


def test_nccl_branch_matches_gloo_branch(tp2):
    """The NCCL branch of the gather (all-gather into a tensor forward,
    reduce-scatter backward), run on gloo's CPU collectives, gives the gloo
    branch's bits: the split / gather pair and a fine micro-step's loss and
    all-reduced gradient; its only all-reduce is the gradient's."""
    for r in tp2:
        got = r["nccl_branch"]
        for key in ("x", "w"):
            assert torch.equal(got["split_gather"][key], r["split_gather"][key])
        assert got["fine"]["stats"] == r["fine"]["stats"]
        assert all(torch.equal(g, r["grads"][n]) for n, g in got["grads"].items())
        assert got["fine"]["all_reduces"] == 1
        assert got["fine"]["step"] == r["fine"]["step"]


@pytest.fixture(scope="module")
def tp4(jax_side, tmp_path_factory):
    cfg, weights, batch, _ = jax_side
    return workers.run_ranks(workers.tp_body, 4, str(tmp_path_factory.mktemp("tp4")), 2, cfg,
                             weights, batch, TRAIN, STEP)


def test_dp2_tp2_matches_tp1(tp4, tp1):
    """Case 2: dp=2×tp=2 on four ranks against the port at tp=1: the loss,
    the gradient, and the four ranks' parameters after one AdamW update."""
    want, want_g = tp1
    assert [r["layout"] for r in tp4] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0),
                                          (2, 2, 1, 1)]
    worst = 0.0
    for r in tp4:
        assert abs(r["fine"]["stats"]["loss"] - want) <= LOSS_RTOL * max(1.0, abs(want))
        worst = max(worst, _check_grads(r["grads"], want_g, "dp=2×tp=2 against tp=1"))
    print(f"dp=2×tp=2 against tp=1: loss {tp4[0]['fine']['stats']['loss']:.7f} / {want:.7f}, "
          f"largest relative L2 of a gradient {worst:.3e}")
    for r in tp4[1:]:
        assert r["fine"]["stats"] == tp4[0]["fine"]["stats"]
        assert all(torch.equal(p, r["params"][n]) for n, p in tp4[0]["params"].items())


def test_dp2_tp2_collectives(jax_side, tp4):
    """Case 4 on the 2×2 grid: each scene's two tp ranks split it (the
    encode's 2 rows, the 64 groups, the 4 views), so the count is tp=2's."""
    want = reckoned(jax_side[0], True)
    for r in tp4:
        assert r["fine"]["all_reduces"] == want["all_reduces"]
        assert r["fine"]["step"]["gather"] == want["gather"]


@pytest.fixture(scope="module")
def tp3(jax_side, tmp_path_factory):
    cfg, weights, batch, _ = jax_side
    return workers.run_ranks(workers.tp_body, 3, str(tmp_path_factory.mktemp("tp3")), 3, cfg,
                             weights, batch, TRAIN, STEP)


def test_tp3_falls_back_and_splits_unevenly(jax_side, tp3, tp1):
    """Case 3: tp=3 on N=4 target views warns once, in the JAX package's
    words, and renders every view on every rank; the uneven encode and
    group splits give tp=1's loss."""
    want, want_g = tp1
    for r in tp3:
        assert r["warnings"] == [("RuntimeWarning", FALLBACK)]
        assert abs(r["fine"]["stats"]["loss"] - want) <= LOSS_RTOL * max(1.0, abs(want))
        _check_grads(r["grads"], want_g, "tp=3 against tp=1")
        # no render gather: the encode and the layers only
        assert r["fine"]["all_reduces"] == reckoned(jax_side[0], True, False)["all_reduces"]
    print(f"tp=3 loss {tp3[0]['fine']['stats']['loss']:.9f}, tp=1 {want:.9f}")


def test_layout_and_row_bounds(monkeypatch, tmp_path):
    """The layout of one process, the raise on a world that does not divide
    by tp (also from the trainer), and tensor_split's row bounds."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert make_layout(1) == make_layout()
    assert (make_layout().dp, make_layout().tp) == (1, 1)
    with pytest.raises(ValueError, match="train.tp=2 does not divide the world size 1"):
        make_layout(2)
    for n, parts in ((4, 3), (128, 3), (7, 2), (6, 2), (2, 3)):
        bounds = tp.row_bounds(n, parts)
        want = [(int(c[0]), int(c[-1]) + 1) if len(c) else None
                for c in torch.tensor_split(torch.arange(n), parts)]
        assert [b if b[1] > b[0] else None for b in bounds] == want
    cfg = _fit_config(str(tmp_path), str(tmp_path / "logs"), tp=2)
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        loop.Trainer(cfg, device="cpu")
    with tp.enabled_for(None):
        x = torch.arange(6.0)
        assert tp.split(x) is x and tp.view_shard(4) == range(4)
        assert tp.gather_views({"a": x}, 4)["a"] is x


def test_fit_tp2_matches_tp1(tmp_path, one_torch_thread):  # noqa: F811
    """`Trainer.fit` at train.tp=2 on two ranks (dp=1) against a tp=1 fit in
    one process: the same micro-steps and batches, rank 0 alone writing,
    the ranks' parameters equal, each loss within 5e-4 relative."""
    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=12, img_size=(32, 32))
    cfg2 = _fit_config(store, str(tmp_path / "tp2"), tp=2)
    res = workers.run_ranks(workers.fit_tp_body, 2, str(tmp_path / "ranks"), cfg2)
    one = workers.fit_recorded(_fit_config(store, str(tmp_path / "tp1")))
    a, b = res
    assert a["micro"] == b["micro"] == one["micro"] and len(one["micro"]) == 4
    assert {m[3] for m in one["micro"]} == {False, True}
    for x, y in zip(a["batches"], b["batches"]):
        assert all(torch.equal(v, y[k]) for k, v in x.items())
    assert all(torch.equal(p, b["params"][n]) for n, p in a["params"].items())
    for got, want in zip(a["losses"], one["losses"]):
        assert abs(got - want) <= LOSS_RTOL * max(1.0, abs(want)), (a["losses"], one["losses"])
    print(f"fit losses at tp=2 {a['losses']}, at tp=1 {one['losses']}")
    assert a["val_epochs"] == one["val_epochs"] == [0, 1]
    assert a["wrote"]["loggers"] == 1 and a["wrote"]["saves"] == 2 and a["wrote"]["images"] > 0
    assert b["wrote"] == {"loggers": 0, "images": 0, "saves": 0}
    scalars = [json.loads(x) for x in (tmp_path / "tp2" / "scalars.jsonl").read_text().splitlines()]
    assert {d["step"] for d in scalars if d["tag"] == "val/loss"} == {0, 1}
    assert ckpt.latest_step(str(tmp_path / "tp2" / "ckpts")) == 4
    assert not tp.enabled()


def test_fit_tp2_threaded_loader_same_batches(tmp_path, one_torch_thread):  # noqa: F811
    """`Trainer.fit` at train.tp=2 with 4 loader threads on each rank, 2 of
    5 batches per epoch over 3 epochs: each rank's loader draws views and
    backgrounds in its threads' order and runs ahead of the epoch's stop,
    yet both ranks train on the same batches (the first rank's, broadcast),
    and end with equal parameters."""
    store = write_synthetic_store(str(tmp_path / "store"), n_scenes=12, img_size=(32, 32))
    cfg = _fit_config(store, str(tmp_path / "tp2"), tp=2, vis_every_n_steps=0, n_epoch=3)
    cfg = dataclasses.replace(
        cfg, train_dataset=dataclasses.replace(cfg.train_dataset, num_workers=4),
        test_dataset=dataclasses.replace(cfg.test_dataset, num_workers=4))
    a, b = workers.run_ranks(workers.fit_tp_body, 2, str(tmp_path / "ranks"), cfg)
    assert a["micro"] == b["micro"] and [m[0] for m in a["micro"]] == [0, 0, 1, 1, 2, 2]
    assert len(a["batches"]) == len(b["batches"]) == 6
    for x, y in zip(a["batches"], b["batches"]):
        assert x.keys() == y.keys() and all(torch.equal(v, y[k]) for k, v in x.items())
    assert a["losses"] == b["losses"]
    assert all(torch.equal(p, b["params"][n]) for n, p in a["params"].items())
