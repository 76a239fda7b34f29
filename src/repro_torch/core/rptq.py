"""RPTQ (paper §II-B5): reorder-based post-training quantization.

RPTQ clusters activation channels by their (min, max) ranges, reorders them
cluster-contiguously, and quantizes each cluster with its own scale, folding
the permutation into adjacent layers.

Numerically, per-cluster quantization is *identical* to per-channel
quantization where each channel uses its cluster's shared alpha — the
permutation only exists so real hardware sees contiguous scale regions.  The
simulation therefore returns:
  * ``alpha_per_channel`` — cluster alphas broadcast back to channels (this is
    what the runtime QDQ uses, zero-copy), and
  * ``perm`` — the reorder, exposed so tests can verify the folded-permutation
    equivalence and so a hardware backend could consume it.

The clustering is a tiny host-side k-means over (C, 2) range points with its
own seeded numpy generator — the reference's, step for step — so ``solve``
takes numpy ranges: the caller brings them off the device once per site.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RPTQResult:
    perm: np.ndarray  # (C,) channel order, cluster-contiguous
    cluster_of: np.ndarray  # (C,) cluster id per (original) channel
    cluster_alpha: np.ndarray  # (R,) clip range per cluster
    alpha_per_channel: np.ndarray  # (C,) = cluster_alpha[cluster_of]


def _kmeans(points: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """Tiny deterministic k-means (k-means++ init) over (C, 2) range points."""
    rng = np.random.RandomState(seed)
    n = points.shape[0]
    k = min(k, n)
    # k-means++ seeding
    centers = [points[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((points[:, None, :] - np.array(centers)[None]) ** 2).sum(-1),
            axis=1,
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(points[rng.choice(n, p=probs)])
    centers = np.array(centers)
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((points[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d2.argmin(axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = points[m].mean(axis=0)
    return assign


def solve(
    ch_min: np.ndarray, ch_max: np.ndarray, num_clusters: int = 4, seed: int = 0
) -> RPTQResult:
    """Cluster channels on calibrated (min, max) and derive scales."""
    ch_min = np.asarray(ch_min, np.float32)
    ch_max = np.asarray(ch_max, np.float32)
    pts = np.stack([ch_min, ch_max], axis=-1)
    assign = _kmeans(pts, num_clusters, seed=seed)
    order = np.argsort(assign, kind="stable")
    r = assign.max() + 1
    cluster_alpha = np.zeros(r, np.float32)
    for j in range(r):
        m = assign == j
        cluster_alpha[j] = max(
            float(np.abs(ch_min[m]).max()), float(np.abs(ch_max[m]).max()), 1e-8
        )
    return RPTQResult(
        perm=order,
        cluster_of=assign,
        cluster_alpha=cluster_alpha,
        alpha_per_channel=cluster_alpha[assign],
    )


def fold_permutation(w_prev_out, w_next_in, perm):
    """Fold channel reorder into neighbours: prev out-cols and next in-rows.

    Returns views reordered such that running [prev -> perm'd acts -> next]
    equals the original network (used by the equivalence test).
    """
    if isinstance(w_prev_out, torch.Tensor):
        perm = torch.as_tensor(np.asarray(perm), device=w_prev_out.device)
    return w_prev_out[..., perm], w_next_in[perm, :]
