"""Masked Davies-Bouldin index, batched over lanes.

Counterpart of `spriteworld_tpu/ops/clustering.py`: sklearn's
``davies_bouldin_score`` as fixed-shape masked tensor algebra,

  DB = mean_i max_{j != i} (S_i + S_j) / ||mu_i - mu_j||

with S_i the mean distance of cluster i's members to its centroid mu_i.
Clusters with no members are dropped from both the max and the mean;
sklearn's zero short-circuits (all S_i ~ 0, or all centroid distances ~ 0)
give 0, and fewer than 2 clusters give NaN where sklearn raises.

Summation order: every float32 sum that more than two terms enter (a
centroid's coordinates and a cluster's distances over the sprite slots,
the mean over the clusters) is a left fold in index order, slot 0 first
(`ordered_sum`), made of elementwise adds. A reduction kernel adds in an
order of its own, which differs between the CPU and the card; the fold
gives the same bits on both. A slot outside the cluster adds an exact 0,
so each sum is the fold over the cluster's members in slot order.
"""

from __future__ import annotations

import numpy as np
import torch

from spriteworld_torch.utils import device as device_lib

_ATOL = 1e-8  # np.allclose default used by sklearn's zero checks


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of `x` over `dim` as a left fold in index order:
    ((x_0 + x_1) + x_2) + ..., one elementwise add a term."""
    terms = x.unbind(dim)
    total = terms[0]
    for term in terms[1:]:
        total = total + term
    return total


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (of two coordinates: their sum
    has one rounding in any order). The square root is taken in float64:
    torch's vectorized float32 sqrt on the CPU is not always correctly
    rounded, and the float64 root rounds to the value that is."""
    return torch.sqrt((x * x).sum(-1).double()).to(x.dtype)


def davies_bouldin_index(positions: torch.Tensor,
                         member: torch.Tensor) -> torch.Tensor:
    """Davies-Bouldin index of a masked clustering, per lane.

    Args:
      positions: f32[B, K, D] point coordinates (rows that belong to no
        cluster are ignored).
      member: bool[B, K, C] cluster membership; each point belongs to at
        most one cluster.

    Returns:
      f32[B]: the DB index; 0 where sklearn's degenerate-zero checks
      trigger; NaN where fewer than 2 clusters have members.
    """
    member_f = member.to(positions.dtype)  # [B, K, C]
    counts = member_f.sum(-2)  # [B, C], whole numbers: exact in any order
    present = counts > 0
    safe_counts = counts.clamp(min=1.0)

    centroids = ordered_sum(member_f[..., None] * positions[..., :, None, :],
                            -3) / safe_counts[..., None]  # [B, C, D]
    d = _norm(positions[..., :, None, :] - centroids[..., None, :, :])
    # An absent cluster's spread is 0 / 1 = 0.
    intra = ordered_sum(d * member_f, -2) / safe_counts  # [B, C]
    cdist = _norm(centroids[..., :, None, :]
                  - centroids[..., None, :, :])  # [B, C, C]

    num_clusters = member.shape[-1]
    pair_present = present[..., :, None] & present[..., None, :]
    off_diag = device_lib.constant(~np.eye(num_clusters, dtype=bool),
                                   member.device)
    # Spreads and distances are >= 0: |x| <= atol is x <= atol.
    intra_all_zero = (intra <= _ATOL).all(-1)
    cdist_all_zero = ((cdist <= _ATOL)
                      | ~(pair_present & off_diag)).flatten(-2).all(-1)

    safe_cdist = torch.where(cdist == 0.0, torch.inf, cdist)
    ratio = (intra[..., :, None] + intra[..., None, :]) / safe_cdist
    # An absent cluster's row is all 0, so its score adds 0 to the mean.
    scores = torch.where(pair_present, ratio, 0.0).amax(-1)  # [B, C]
    num_present = present.sum(-1)
    db = ordered_sum(scores, -1) \
        / num_present.clamp(min=1).to(positions.dtype)

    db = torch.where(intra_all_zero | cdist_all_zero, 0.0, db)
    return torch.where(num_present >= 2, db, torch.nan)
