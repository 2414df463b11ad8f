"""The fine stage's top-M selection, `models/lara.py:select_top_m`, against
`jax.lax.top_k` (`lara_tpu/models/lara.py:_fine_stage`) on the scores the
fine stage builds: opacity logits from N(-2, σ²), made with numpy from a
seed and rounded to bf16 as the coarse decoder's output is, their sigmoid
where it passes 0.005, else -1. bf16 logits take a few thousand values, so
the scores tie at the budget; `lax.top_k` returns equal values in ascending
index order, and `select_top_m` must give the same index sequence (so
the same set: the lower indices where the scores tie at the M-th) and the
same value bits. The flagship shape (N = 524,288, M = 131,072) and small
ones, including an M that cuts through the -1 floor. Also: the fine stage
calls it (and not `torch.topk`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu_torch.config import config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models import lara as lara_model
from lara_tpu_torch.models.lara import select_top_m
from lara_tpu_torch.tools import profile_select
from lara_tpu_torch.train.step import make_forward
from tests.test_model import synthetic_batch, tiny_config

FLAGSHIP_N, FLAGSHIP_M = 64 ** 3 * 2, 131072


def scores_np(n: int, sigma: float) -> np.ndarray:
    """`_fine_stage`'s score in f32, from bf16-rounded logits."""
    return profile_select.fine_scores(n, sigma, "cpu").numpy()


def assert_as_lax_top_k(score: np.ndarray, m: int, got):
    want_v, want_i = jax.lax.top_k(jnp.asarray(score), m)
    vals, idx = got
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


@pytest.mark.parametrize("n,m,sigma", [
    (FLAGSHIP_N, FLAGSHIP_M, 1.0), (FLAGSHIP_N, FLAGSHIP_M, 3.0),
    (4096, 1024, 1.0), (4096, 1024, 3.0),
    (4096, 3900, 3.0),                       # M reaches into the -1 floor
    (4096, 4096, 1.0),                       # all of it
])
def test_select_top_m_is_lax_top_k(n, m, sigma):
    score = scores_np(n, sigma)
    top = np.sort(score)[::-1][:m]
    assert len(np.unique(top)) < m           # equal scores inside the selection
    if n == FLAGSHIP_N:
        assert np.sum(score == top[-1]) > 1  # and at the budget
    if m == 3900:
        assert np.sum(score > 0.0) < m       # ... here the floor's
    assert_as_lax_top_k(score, m, select_top_m(torch.from_numpy(score), m))


def test_profile_select_runs_on_cpu(capsys):
    out = profile_select.run(device="cpu", n=8192, budgets=(2048,), sigmas=(1.0,))
    (row,) = out["rows"]
    assert row["m"] == 2048 and row["tied_at_mth"] > 1
    assert set(row["ms"]) == {"torch.topk", "select_top_m"}
    assert "[select] N=8192 M=2048" in capsys.readouterr().out


def test_fine_stage_selects_with_select_top_m(monkeypatch):
    """A serving forward of the tiny config selects once per scene through
    `select_top_m` at M = fine_budget, and never through `torch.topk`."""
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0)).eval()
    calls = []

    def recorded(score, m):
        calls.append((tuple(score.shape), m))
        return select_top_m(score, m)

    def no_topk(*args, **kw):
        raise AssertionError("torch.topk on the fine stage's path")

    monkeypatch.setattr(lara_model, "select_top_m", recorded)
    monkeypatch.setattr(torch, "topk", no_topk)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(B=2).items()}
    make_forward(net, with_fine=True)(batch)
    n = cfg.model.K * (2 * cfg.model.vol_embedding_reso) ** 3
    assert calls == [((n,), min(cfg.model.fine_budget, n))] * 2
