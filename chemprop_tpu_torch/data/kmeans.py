"""k-means in numpy with scikit-learn's numerics, for the ``kmeans`` split.

The JAX package clusters Morgan bits with ``sklearn.cluster.KMeans(
n_clusters, random_state=seed, n_init=3).fit_predict`` (the Lloyd
algorithm, k-means++ seeding). The split then takes the clusters in label
order, so the port must number its clusters as scikit-learn numbers them,
not only find the same ones. This module reproduces scikit-learn 1.9's
steps with the same numpy and BLAS calls in the same order:

* ``fit``: the data centred on its column means, ``n_init`` runs seeded by
  one ``np.random.RandomState``, the run of least inertia kept unless it is
  the same clustering as the best so far (``_is_same_clustering``);
* k-means++: greedy, ``2 + int(log k)`` local trials, the squared distances
  formed as ``|x|^2 - 2 x.c + |c|^2`` on float64 copies of float32 chunks and
  rounded back to float32, as ``_euclidean_distances_upcast`` does;
* Lloyd: chunks of 256 rows, whose distances ``|c|^2 - 2 x.c`` come from
  one float32 ``sgemm`` with ``beta = 1`` (scipy's BLAS, the library that
  scikit-learn's Cython calls); the centres summed row by row in float32
  and scaled by a float32 reciprocal; strict convergence when the labels
  stop changing, else the tolerance on the centre shift and a final
  E-step;
* the float32 sums of the Cython loops (centre shift, inertia) in their
  order: groups of four, then a running sum; the inertia's OpenMP reduction
  over as many static blocks as there are usable cores, added in block
  order.

scikit-learn adds its threads' centre sums in the order the threads finish;
below 257 rows there is one chunk and the order is fixed. Here the blocks
are always added in order.
"""

from __future__ import annotations

import math
import os

import numpy as np

CHUNK_SIZE = 256


def _n_threads() -> int:
    """OpenMP's default thread count: the usable cores, or OMP_NUM_THREADS."""
    cores = len(os.sched_getaffinity(0))
    env = os.environ.get("OMP_NUM_THREADS", "").split(",")[0].strip()
    return max(1, min(int(env), cores)) if env.isdigit() else cores


def _row_norms(X: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", X, X)


def _sq_distances_upcast(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Squared distances of float32 rows, formed in float64 by chunks whose
    size follows scikit-learn's memory rule, returned in float32."""
    n_x, n_y, n_f = X.shape[0], Y.shape[0], X.shape[1]
    maxmem = max(((n_x + n_y) * n_f + n_x * n_y) / 10, 10 * 2**17)
    tmp = 2 * n_f
    batch = max(int((-tmp + math.sqrt(tmp**2 + 4 * maxmem)) / 2), 1)
    out = np.empty((n_x, n_y), dtype=np.float32)
    for xs in range(0, n_x, batch):
        Xc = X[xs : xs + batch].astype(np.float64)
        XX = _row_norms(Xc)[:, None]
        for ys in range(0, n_y, batch):
            Yc = Y[ys : ys + batch].astype(np.float64)
            d = -2 * (Xc @ Yc.T)
            d += XX
            d += _row_norms(Yc)[None, :]
            out[xs : xs + batch, ys : ys + batch] = d.astype(np.float32, copy=False)
    np.maximum(out, 0, out=out)
    return out


def _kmeans_plusplus(X, n_clusters, sample_weight, random_state) -> np.ndarray:
    n_samples = X.shape[0]
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = random_state.choice(n_samples, p=sample_weight / sample_weight.sum())
    centers[0] = X[center_id]
    closest_dist_sq = _sq_distances_upcast(centers[0, np.newaxis], X)
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = _sq_distances_upcast(X[candidate_ids], X)
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        centers[c] = X[candidate_ids[best]]
    return centers


def _running_sq_dist(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Row-wise squared distances summed as the Cython loop sums them:
    float32 groups of four, then a running float32 sum, then the rest."""
    d = A - B
    s = d * d
    n4 = (s.shape[1] // 4) * 4
    g = s[:, :n4].reshape(s.shape[0], -1, 4)
    groups = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    out = np.zeros(s.shape[0], dtype=A.dtype)
    for j in range(groups.shape[1]):
        out += groups[:, j]
    for j in range(n4, s.shape[1]):
        out += s[:, j]
    return out


def _inertia(X, sample_weight, centers, labels, n_threads) -> np.float32:
    per_row = _running_sq_dist(X, centers[labels]) * sample_weight
    n = X.shape[0]
    q, r = divmod(n, n_threads)
    total = np.float32(0)
    start = 0
    for t in range(n_threads):
        end = start + q + (t < r)
        part = np.float32(0)
        for v in per_row[start:end]:
            part = np.float32(part + v)
        total = np.float32(total + part)
        start = end
    return total


def _sgemm_distances(X_chunk, centers, centers_sq):
    """``|c|^2 - 2 x.c`` for a chunk, by the float32 ``sgemm`` call that
    scikit-learn's row-major ``_gemm`` makes (column-major, B before A)."""
    from scipy.linalg.blas import sgemm

    C = np.empty((centers.shape[0], X_chunk.shape[0]), dtype=np.float32, order="F")
    C[:] = centers_sq[:, None]
    out = sgemm(-2.0, centers.T, X_chunk.T, beta=1.0, c=C, trans_a=1, trans_b=0, overwrite_c=1)
    return out.T


def _lloyd_iter(X, sample_weight, centers_old, labels, n_threads, update_centers=True):
    """One E-step (and M-step): ``labels`` written in place, and the new
    centres and their shifts (None with ``update_centers`` off)."""
    n_samples, n_features = X.shape
    n_clusters = centers_old.shape[0]
    chunk = min(CHUNK_SIZE, n_samples)
    n_chunks = -(-n_samples // chunk)
    centers_sq = _row_norms(centers_old)
    for s in range(0, n_samples, chunk):
        D = _sgemm_distances(X[s : s + chunk], centers_old, centers_sq)
        labels[s : s + chunk] = np.argmin(D, axis=1)
    if not update_centers:
        return None
    # static schedule: each thread takes a run of whole chunks and sums its
    # rows in order into its own buffer; the buffers are then added in turn
    threads = min(n_threads, n_chunks)
    q, r = divmod(n_chunks, threads)
    centers_new = np.zeros((n_clusters, n_features), dtype=X.dtype)
    weight_in_clusters = np.zeros(n_clusters, dtype=X.dtype)
    first = 0
    for t in range(threads):
        last = first + q + (t < r)
        rows = slice(first * chunk, min(last * chunk, n_samples))
        buf = np.zeros_like(centers_new)
        wbuf = np.zeros_like(weight_in_clusters)
        np.add.at(wbuf, labels[rows], sample_weight[rows])
        np.add.at(buf, labels[rows], X[rows] * sample_weight[rows, None])
        weight_in_clusters += wbuf
        centers_new += buf
        first = last
    _relocate_empty_clusters(X, sample_weight, centers_old, centers_new, weight_in_clusters, labels)
    argmax_weight = np.argmax(weight_in_clusters)
    for j in range(n_clusters):
        if weight_in_clusters[j] > 0:
            alpha = np.float32(1.0 / float(weight_in_clusters[j]))
            centers_new[j] *= alpha
        else:
            centers_new[j] = centers_new[argmax_weight]
    center_shift = np.sqrt(_running_sq_dist(centers_new, centers_old))
    return centers_new, center_shift


def _relocate_empty_clusters(X, sample_weight, centers_old, centers_new, weight_in_clusters,
                             labels):
    empty = np.where(np.equal(weight_in_clusters, 0))[0].astype(np.int32)
    n_empty = empty.shape[0]
    if n_empty == 0:
        return
    distances = ((X - centers_old[labels]) ** 2).sum(axis=1)
    far = np.argpartition(distances, -n_empty)[: -n_empty - 1 : -1].astype(np.int32)
    if np.max(distances) == 0:
        return
    for new_id, far_idx in zip(empty, far):
        weight = sample_weight[far_idx]
        old_id = labels[far_idx]
        centers_new[old_id] -= X[far_idx] * weight
        centers_new[new_id] = X[far_idx] * weight
        weight_in_clusters[new_id] = weight
        weight_in_clusters[old_id] -= weight


def _lloyd(X, sample_weight, centers, max_iter, tol, n_threads):
    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(max_iter):
        centers_new, center_shift = _lloyd_iter(X, sample_weight, centers, labels, n_threads)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (center_shift**2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        _lloyd_iter(X, sample_weight, centers, labels, n_threads, update_centers=False)
    return labels, _inertia(X, sample_weight, centers, labels, n_threads)


def _is_same_clustering(labels1, labels2, n_clusters) -> bool:
    mapping = np.full(n_clusters, -1, dtype=np.int32)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


def kmeans_fit_predict(
    X: np.ndarray, n_clusters: int, random_state: int, n_init: int = 3,
    max_iter: int = 300, tol: float = 1e-4,
) -> np.ndarray:
    """The labels of ``KMeans(n_clusters, random_state=random_state,
    n_init=n_init).fit_predict(X.astype(float32))`` (Lloyd, k-means++), as
    int32."""
    X = np.array(X, dtype=np.float32, order="C", copy=True)
    if X.shape[0] < n_clusters:
        raise ValueError(f"n_samples={X.shape[0]} should be >= n_clusters={n_clusters}.")
    rng = np.random.RandomState(random_state)
    sample_weight = np.ones(X.shape[0], dtype=X.dtype)
    tol = np.mean(np.var(X, axis=0)) * tol if tol else 0
    X -= X.mean(axis=0)
    n_threads = _n_threads()
    best_inertia = best_labels = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(X, n_clusters, sample_weight, rng)
        labels, inertia = _lloyd(X, sample_weight, centers, max_iter, tol, n_threads)
        if best_inertia is None or (
            inertia < best_inertia and not _is_same_clustering(labels, best_labels, n_clusters)
        ):
            best_labels, best_inertia = labels, inertia
    return best_labels
