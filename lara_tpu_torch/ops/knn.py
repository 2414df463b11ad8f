"""K-nearest-neighbour mean distances (replaces `simple_knn._C.distCUDA2`),
the counterpart of `lara_tpu/ops/knn.py`.

The reference's legacy 3DGS renderer sets per-point scales from the mean
squared distance to the 3 nearest neighbours (lightning/renderer.py:141).
A chunked brute force is plain torch on the points' own device: the JAX
function has no Pallas kernel, so this has no hand kernel and no plain
fallback either, only the one path."""

from __future__ import annotations

import torch


def knn_mean_dist(points: torch.Tensor, k: int = 3, chunk: int = 1024) -> torch.Tensor:
    """points [N, 3] → [N], each point's mean squared distance to its k
    nearest neighbours, itself left out (distCUDA2's semantics). Per chunk
    of queries: squared distances to every point, the k + 1 smallest, the
    first (the point itself, or a duplicate at the same distance 0)
    dropped. As in the JAX function the queries are padded with 1e9 to a
    multiple of `chunk` and the keys never are."""
    n = points.shape[0]
    pad = (-n) % chunk
    queries = torch.cat([points, points.new_full((pad, points.shape[1]), 1e9)])
    out = []
    for q in queries.split(chunk):
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)        # [chunk, N]
        nearest = torch.topk(d2, k + 1, dim=-1, largest=False).values
        out.append(nearest[:, 1:].mean(-1))
    return torch.cat(out)[:n]
