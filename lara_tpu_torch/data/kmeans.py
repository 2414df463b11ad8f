"""KMeans view clusters in NumPy, the port's copy of `kmeans_groups`
(lara_tpu/data/gso.py:23-28, dataLoader/utils.py:55-65 of the reference):
`sklearn.cluster.KMeans(n_clusters, n_init=10, random_state=20211202)
.fit(xyz)` with the labels sklearn gives.

The labels choose which views are an evaluation's inputs and which its
targets, so this follows scikit-learn 1.9's `KMeans` (dense input, the
"lloyd" algorithm, `sklearn/cluster/_kmeans.py` and `_k_means_*.pyx`) in
its order of operations and its dtypes:
  - the data is centred on its mean; float32 input stays float32;
  - one `np.random.RandomState(seed)` feeds all `n_init` initialisations;
  - greedy k-means++ with 2 + int(log k) local trials per centre, the
    squared distances upcast to float64 as ‖x‖² − 2x·c + ‖c‖²;
  - Lloyd's iterations (assignment by ‖c‖² − 2x·c in the input's dtype,
    centres summed in sample order and scaled by the reciprocal of their
    weight) until the labels stop changing or the squared centre shift is
    within mean(var(X)) · tol, then a last assignment;
  - a later run replaces the best only with a smaller inertia and a
    clustering that is not a relabelling of the best one.
The sums of Lloyd's centre update run in sample order, as sklearn's do for
up to 256 samples (one chunk); beyond that sklearn sums its chunks over
threads, in an order this does not reproduce.
"""

from __future__ import annotations

from typing import List

import numpy as np

SEED = 20211202       # dataLoader/utils.py's random_state
N_INIT = 10
MAX_ITER = 300        # sklearn's defaults
TOL = 1e-4


def _sq_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances [len(a), len(b)] of float32 rows, computed in
    float64 and stored as float32, clipped at 0
    (sklearn.metrics.pairwise._euclidean_distances_upcast)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += _sq_norms(a64)[:, None]
    d += _sq_norms(b64)[None, :]
    return np.maximum(d.astype(a.dtype), 0)


def _kmeans_plusplus(x: np.ndarray, k: int, weight: np.ndarray,
                     rs: np.random.RandomState) -> np.ndarray:
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, None], x)
    pot = closest @ weight
    for c in range(1, k):
        rand = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(x[cand], x)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weight.reshape(-1, 1)
        best = np.argmin(pots)
        pot, closest = pots[best], dist[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Labels by the first smallest ‖c‖² − 2x·c (the GEMM of sklearn's
    `_update_chunk_dense`)."""
    d = _sq_norms(centers)[None, :] + x.dtype.type(-2) * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _sq_dist_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise squared distance summed feature by feature in the rows'
    dtype (`_euclidean_dense_dense`)."""
    diff = a - b
    out = np.zeros(len(a), a.dtype)
    for f in range(a.shape[1]):
        out += diff[:, f] * diff[:, f]
    return out


def _lloyd_step(x, weight, centers, labels):
    """One E- and M-step; returns (new centres, squared-shift sum)."""
    k = len(centers)
    labels[:] = _assign(x, centers)
    new = np.zeros_like(centers)
    wsum = np.zeros(k, x.dtype)
    np.add.at(wsum, labels, weight)                  # in sample order
    np.add.at(new, labels, x * weight[:, None])
    empty = np.where(wsum == 0)[0]
    if len(empty):
        _relocate_empty(x, weight, centers, new, wsum, labels, empty)
    biggest = np.argmax(wsum)
    for j in range(k):
        if wsum[j] > 0:
            new[j] *= x.dtype.type(1.0) / wsum[j]
        else:
            new[j] = new[biggest]
    shift = np.sqrt(_sq_dist_rows(new, centers))
    return new, (shift ** 2).sum()


def _relocate_empty(x, weight, centers, new, wsum, labels, empty):
    """sklearn's `_relocate_empty_clusters_dense`: each empty cluster takes
    one of the samples farthest from their centres."""
    dist = ((x - centers[labels]) ** 2).sum(axis=1)
    n_empty = len(empty)
    far = np.argpartition(dist, -n_empty)[:-n_empty - 1:-1]
    if np.max(dist) == 0:
        return
    for new_id, idx in zip(empty, far):
        old_id = labels[idx]
        new[old_id] -= x[idx] * weight[idx]
        new[new_id] = x[idx] * weight[idx]
        wsum[new_id] = weight[idx]
        wsum[old_id] -= weight[idx]


def _inertia(x, weight, centers, labels):
    total = x.dtype.type(0)
    for d, w in zip(_sq_dist_rows(x, centers[labels]), weight):
        total += d * w
    return total


def _single_lloyd(x, weight, centers, tol):
    labels = np.full(len(x), -1, np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(MAX_ITER):
        new, shift = _lloyd_step(x, weight, centers, labels)
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _assign(x, centers)
    return labels, _inertia(x, weight, centers, labels)


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    mapping = np.full(k, -1, np.int64)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_labels(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """The `labels_` of `KMeans(n_clusters, n_init=10, random_state=20211202)
    .fit(x)` (int32 [n])."""
    x = np.array(x, dtype=np.float32 if np.asarray(x).dtype == np.float32 else np.float64,
                 order="C")
    if len(x) < n_clusters:
        raise ValueError(f"n_samples={len(x)} should be >= n_clusters={n_clusters}")
    tol = np.mean(np.var(x, axis=0)) * TOL
    rs = np.random.RandomState(SEED)
    weight = np.ones(len(x), x.dtype)
    x -= x.mean(axis=0)
    best_labels, best_inertia = None, None
    for _ in range(N_INIT):
        centers = _kmeans_plusplus(x, n_clusters, weight, rs)
        labels, inertia = _single_lloyd(x, weight, centers, tol)
        if best_inertia is None or (inertia < best_inertia and not _same_clustering(
                labels, best_labels, n_clusters)):
            best_labels, best_inertia = labels, inertia
    return best_labels


def kmeans_groups(xyz: np.ndarray, n_clusters: int) -> List[np.ndarray]:
    """View indices of each KMeans cluster, in label order (uint8), as the
    JAX package's `kmeans_groups` returns them."""
    labels = kmeans_labels(xyz, n_clusters)
    return [np.where(labels == i)[0].astype(np.uint8) for i in range(n_clusters)]
