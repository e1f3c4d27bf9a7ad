"""Masked Davies-Bouldin index, batched over lanes.

Counterpart of `spriteworld_tpu/ops/clustering.py`: sklearn's
``davies_bouldin_score`` as fixed-shape masked tensor algebra,

  DB = mean_i max_{j != i} (S_i + S_j) / ||mu_i - mu_j||

with S_i the mean distance of cluster i's members to its centroid mu_i.
Clusters with no members are dropped from both the max and the mean;
sklearn's zero short-circuits (all S_i ~ 0, or all centroid distances ~ 0)
give 0, and fewer than 2 clusters give NaN where sklearn raises.
"""

from __future__ import annotations

import torch

_ATOL = 1e-8  # np.allclose default used by sklearn's zero checks


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis. The square root is taken in
    float64: torch's vectorized float32 sqrt on the CPU is not always
    correctly rounded, and the float64 root rounds to the value that is."""
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
    counts = member_f.sum(-2)  # [B, C]
    present = counts > 0
    safe_counts = counts.clamp(min=1.0)

    centroids = (member_f[..., None] * positions[..., :, None, :]).sum(-3) \
        / safe_counts[..., None]  # [B, C, D]
    d = _norm(positions[..., :, None, :] - centroids[..., None, :, :])
    intra = (d * member_f).sum(-2) / safe_counts  # [B, C]
    cdist = _norm(centroids[..., :, None, :]
                  - centroids[..., None, :, :])  # [B, C, C]

    num_clusters = member.shape[-1]
    pair_present = present[..., :, None] & present[..., None, :]
    off_diag = ~torch.eye(num_clusters, dtype=torch.bool,
                          device=member.device)
    relevant = pair_present & off_diag

    zero = torch.zeros_like(intra)
    intra_all_zero = (torch.where(present, intra.abs(), zero)
                      <= _ATOL).all(-1)
    cdist_all_zero = (torch.where(relevant, cdist.abs(),
                                  torch.zeros_like(cdist))
                      <= _ATOL).flatten(-2).all(-1)

    safe_cdist = torch.where(cdist == 0.0, torch.full_like(cdist, torch.inf),
                             cdist)
    ratio = (intra[..., :, None] + intra[..., None, :]) / safe_cdist
    scores = torch.where(pair_present, ratio,
                         torch.zeros_like(ratio)).amax(-1)  # [B, C]
    num_present = present.sum(-1)
    db = torch.where(present, scores, zero).sum(-1) \
        / num_present.clamp(min=1).to(positions.dtype)

    db = torch.where(intra_all_zero | cdist_all_zero, torch.zeros_like(db), db)
    return torch.where(num_present >= 2, db, torch.full_like(db, torch.nan))
