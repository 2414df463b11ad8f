"""`lara_tpu_torch/ops/knn.py:knn_mean_dist` against
`lara_tpu/ops/knn.py:knn_mean_dist` on the CPU, on points drawn from a
numpy seed, at 1e-6 relative: N not a multiple of the chunk, k = 1 and 3,
and a cloud with duplicate points, where a point's self-match ties with its
duplicate at distance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.ops.knn import knn_mean_dist as jax_knn_mean_dist
from lara_tpu_torch.ops.knn import knn_mean_dist


def _cloud(n: int, duplicates: bool) -> np.ndarray:
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    if duplicates:
        # every 7th point repeats the point before it, one is there three times
        pts[1::7] = pts[0::7][:len(pts[1::7])]
        pts[2] = pts[0]
    return pts


@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "duplicates"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n,chunk", [(1000, 64), (256, 256)])
def test_knn_mean_dist_matches_jax(n, chunk, k, duplicates):
    pts = _cloud(n, duplicates)
    want = np.asarray(jax_knn_mean_dist(jnp.asarray(pts), k=k, chunk=chunk))
    got = knn_mean_dist(torch.from_numpy(pts), k=k, chunk=chunk)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if duplicates and k == 1:
        # the duplicate's distance 0 survives the dropped self-match
        assert (got.numpy()[[0, 1, 2]] == 0).all()


def test_knn_mean_dist_by_hand():
    """4 points on a unit segment (tests/test_eval.py:test_knn_mean_dist)."""
    pts = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]])
    d = knn_mean_dist(pts, k=3, chunk=3)
    torch.testing.assert_close(d, torch.tensor([14 / 3, 6 / 3, 6 / 3, 14 / 3]))
