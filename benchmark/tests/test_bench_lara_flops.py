"""The restated model FLOPs of `benchmark/flops.py` at lara_base: a B=3 fine
training micro-step (forward × 3) and a B=1 serving request (forward),
both of 512² input views."""

import json

import pytest

from benchmark import flops
from benchmark.tests.tiny import REPO


@pytest.fixture(scope="module")
def base():
    return json.loads((REPO / "benchmark" / "configs" / "lara_base.json").read_text())


def test_train_micro_step_flops(base):
    assert flops.train_step(base, 3, 512) / 1e12 == pytest.approx(34.190, abs=5e-4)


def test_serve_request_flops(base):
    assert flops.serve_step(base, 1, 512) / 1e12 == pytest.approx(3.799, abs=5e-4)


def test_render_scale_leaves_model_flops(base):
    # the reference's infer.render_img_scale 4: 2048² renders of 512² inputs
    big = dict(base, infer={"render_img_scale": 4.0},
               render=dict(base["render"], tile=64, eval_tile_budget=8192))
    assert flops.serve_step(big, 1, 512) == flops.serve_step(base, 1, 512)
