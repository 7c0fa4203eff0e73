"""FL + Hierarchical Clustering (Briggs et al., survey §III.B.1), port of
``repro.core.clustering``: the same numpy code, kept here so that the port
imports nothing of the JAX package.

After a few FedAvg rounds, clients are clustered by the similarity of
their local updates (pairwise distance over flattened deltas,
agglomerative, complete linkage, a distance threshold), and each cluster
trains its own model.  The synthetic corpus (``data.synthetic``) has
ground-truth generator clusters (``client_clusters``), so cluster recovery
is measured directly (:func:`adjusted_match`).
"""
from __future__ import annotations

import numpy as np


def pairwise_delta_distance(deltas_flat: np.ndarray, metric="cosine"):
    """deltas_flat: (C, n) per-client update matrix -> (C, C) distances."""
    X = np.asarray(deltas_flat, dtype=np.float64)
    if metric == "cosine":
        norms = np.linalg.norm(X, axis=1, keepdims=True) + 1e-12
        S = (X / norms) @ (X / norms).T
        return 1.0 - S
    if metric == "l1":                       # Manhattan, the metric of [43]
        return np.abs(X[:, None, :] - X[None, :, :]).sum(-1)
    raise ValueError(metric)


def agglomerate(D: np.ndarray, threshold: float):
    """Complete-linkage agglomerative clustering with a distance threshold.
    Returns integer labels (C,)."""
    C = D.shape[0]
    clusters = [[i] for i in range(C)]

    def complete(a, b):
        return max(D[i, j] for i in a for j in b)

    while len(clusters) > 1:
        best, bi, bj = None, -1, -1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = complete(clusters[i], clusters[j])
                if best is None or d < best:
                    best, bi, bj = d, i, j
        if best is None or best > threshold:
            break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
    labels = np.zeros(C, dtype=int)
    for k, cl in enumerate(clusters):
        for i in cl:
            labels[i] = k
    return labels


def adjusted_match(labels: np.ndarray, truth: np.ndarray) -> float:
    """Fraction of client pairs whose same/different-cluster relation
    matches the ground truth (a pairwise Rand-style score, 1.0 = exact
    recovery)."""
    labels, truth = np.asarray(labels), np.asarray(truth)
    C = len(labels)
    agree = total = 0
    for i in range(C):
        for j in range(i + 1, C):
            agree += (labels[i] == labels[j]) == (truth[i] == truth[j])
            total += 1
    return agree / max(total, 1)
