"""The benchmark's plain reference against the program with its network in
float32 (no autocast) on the tiny configuration, on the CPU where the
program's blend is its plain version: the same weights and scenes give the
same surfels, selection, renders, losses, first gradient and update, to
float32 rounding. The benchmark's own comparison then measures only what
the program's bf16 and its kernels change."""

import json

import pytest
import torch

from benchmark import load, program
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tiny.make_checkout(tmp_path_factory.mktemp("bench"))
    entry = json.loads((root / "benchmark/configs/tiny_lara.json").read_text())
    torch.set_num_threads(4)
    return root, entry


train_kind, serve_kind = load.kind("train"), load.kind("serve")


def _ctx(root, entry, kind):
    traffic = json.loads((root / f"benchmark/traffic/tiny_{kind}.json").read_text())
    return load.Context(entry, traffic, tiny.SEED, 1.0, False, torch.device("cpu"))


def _net(ctx, cfg):
    from lara_tpu_torch.models import LaRaNet
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(load.make_weights(ctx))
    return net


def test_serving_matches_in_float32(setup):
    root, entry = setup
    ctx = _ctx(root, entry, "serve")
    cfg = program.config(entry)
    b = load.batches(ctx, load.make_pool(ctx))(1)
    got = program.served(program.forward(_net(ctx, cfg), cfg)(b))
    gaps = serve_kind.compare(got, serve_kind.reference(ctx, cfg, b))
    assert gaps.pop("select_gap") == 0.0
    assert max(gaps.values()) < 1e-4, gaps


def test_training_matches_in_float32(setup):
    root, entry = setup
    ctx = _ctx(root, entry, "train")
    cfg = program.config(entry)
    t = ctx.traffic
    net = _net(ctx, cfg)
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    step, state = program.train_step(net, cfg, t["start_step"], t["max_iters"])
    batch = load.batches(ctx, load.make_pool(ctx))

    losses = []
    for i in range(t["checked"]):
        losses.append(float(step(batch(i))["loss"]))
        if i == 1:
            g = {n: float(torch.linalg.vector_norm(state.optimizer.state[p]["exp_avg"])) / 0.1
                 for n, p in net.named_parameters()}
    d = {n: float(torch.linalg.vector_norm(p.detach() - p0[n]))
         for n, p in net.named_parameters()}
    ref_l, ref_g, ref_d = train_kind.reference(ctx, cfg, batch)
    nums = train_kind.numbers(losses, g, d, ref_l, ref_g, ref_d, cfg.train.grad_accum)
    assert nums["loss_gap"] < 1e-5 and nums["loss_gap_after"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-3 and nums["update_gap"] < 2e-3, nums
