r"""Coarse/fine matching and local-to-global registration
(port of :mod:`se3et_tpu.nn.matching`), with the training targets: the
ground-truth patch overlaps and the sampled superpoint targets.

Static shapes throughout: fixed correspondence budgets with validity
masks.  Global top-k selections use :func:`torch.topk`; the chosen slots
are then ordered by flat index, the slot order of the JAX package's
``global_topk``.  The two agree as sets except among exactly tied values
(``global_topk`` fills ties lowest-index-first), which only occurs among
zero-score (invalid) slots.
"""

from __future__ import annotations

import torch
from torch import nn

from se3et_tpu_torch.core import se3
from se3et_tpu_torch.ops import geometry
from se3et_tpu_torch.ops.kernels.sinkhorn import sinkhorn


def _topk_by_index(flat: torch.Tensor, k: int):
    """Top-k values of a 1-D tensor as a set, slots ordered by index."""
    vals, idx = torch.topk(flat, k)
    idx, order = torch.sort(idx)
    return vals[order], idx


class LearnableLogOptimalTransport(nn.Module):
    """SuperGlue-style log-domain Sinkhorn with a learnable dustbin ``alpha``;
    the iterations run in kernel K4, and its gradient is that of the
    logsumexp scan form (``ops.kernels.sinkhorn.sinkhorn_scan``)."""

    def __init__(self, num_iterations: int = 100, inf: float = 1e12):
        super().__init__()
        self.num_iterations = num_iterations
        self.inf = inf
        self.alpha = nn.Parameter(torch.ones(()))

    def reset_parameters_with(self, generator):
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, scores, row_masks, col_masks):
        """scores (B, M, N); masks True = valid -> (B, M+1, N+1) log-probs."""
        b, m, n = scores.shape
        scores = scores.float()
        dev = scores.device
        ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
        row_valid = torch.cat([row_masks, ones], dim=1)
        col_valid = torch.cat([col_masks, ones], dim=1)
        alpha = self.alpha.float()
        padded = torch.cat([
            torch.cat([scores, alpha.expand(b, m, 1)], dim=2),
            alpha.expand(b, 1, n + 1),
        ], dim=1)
        padded = padded.masked_fill(~(row_valid[:, :, None] & col_valid[:, None, :]),
                                    -self.inf)
        num_row = row_masks.sum(dim=1).float()
        num_col = col_masks.sum(dim=1).float()
        norm = -torch.log(num_row + num_col + 1e-9)  # (B,)
        log_mu = torch.cat([norm[:, None].expand(b, m),
                            (torch.log(num_col + 1e-9) + norm)[:, None]], dim=1)
        log_mu = log_mu.masked_fill(~row_valid, -self.inf)
        log_nu = torch.cat([norm[:, None].expand(b, n),
                            (torch.log(num_row + 1e-9) + norm)[:, None]], dim=1)
        log_nu = log_nu.masked_fill(~col_valid, -self.inf)
        out = sinkhorn(padded, log_mu, log_nu, self.num_iterations)
        return out - norm[:, None, None]


def superpoint_matching(ref_feats, src_feats, ref_masks, src_masks,
                        num_correspondences, dual_normalization=True):
    """Global top-k superpoint correspondences from unit-norm features.

    Returns (ref_idx (K,), src_idx (K,), scores (K,), valid (K,)).
    """
    sq = geometry.pairwise_distance(ref_feats, src_feats, normalized=True)
    pair_valid = ref_masks[:, None] & src_masks[None, :]
    scores = torch.exp(-sq).masked_fill(~pair_valid, 0.0)
    if dual_normalization:
        ref_norm = scores / (scores.sum(dim=1, keepdim=True) + 1e-12)
        src_norm = scores / (scores.sum(dim=0, keepdim=True) + 1e-12)
        scores = (ref_norm * src_norm).masked_fill(~pair_valid, 0.0)
    m = src_feats.shape[0]
    corr_scores, corr_idx = _topk_by_index(scores.reshape(-1), num_correspondences)
    valid = corr_scores > 0.0
    return corr_idx // m, corr_idx % m, torch.clamp_min(corr_scores, 0.0), valid


def node_correspondences(ref_nodes, src_nodes, ref_knn_points, src_knn_points, transform,
                         pos_radius, ref_masks, src_masks, ref_knn_masks, src_knn_masks,
                         num_candidates=48):
    """Ground-truth superpoint overlaps (M, N), float32, 0 where no overlap.

    For each ref node the ``num_candidates`` nearest aligned src nodes are
    shortlisted (``torch.topk``); the patch-pair overlap ratio of each
    shortlisted pair (share of points with a partner within ``pos_radius``,
    averaged over both patches, zero unless the enclosing spheres meet) is
    scattered into the dense matrix with a max."""
    aligned_src_nodes = se3.apply_transform(src_nodes, transform)
    aligned_src_knn = se3.apply_transform(src_knn_points, transform)
    sq = geometry.pairwise_distance(ref_nodes, aligned_src_nodes)  # (M, N)
    sq = sq.masked_fill(~(ref_masks[:, None] & src_masks[None, :]), geometry.INF)
    cand_idx = torch.topk(-sq, num_candidates, dim=1).indices  # (M, S)

    # enclosing-sphere prefilter radii
    ref_d = torch.linalg.norm(ref_knn_points - ref_nodes[:, None, :], dim=-1)
    ref_max = ref_d.masked_fill(~ref_knn_masks, 0.0).amax(dim=1)  # (M,)
    src_d = torch.linalg.norm(aligned_src_knn - aligned_src_nodes[:, None, :], dim=-1)
    src_max = src_d.masked_fill(~src_knn_masks, 0.0).amax(dim=1)  # (N,)

    cand_src_knn = aligned_src_knn[cand_idx]  # (M, S, K, 3)
    cand_src_knn_masks = src_knn_masks[cand_idx]  # (M, S, K)
    cand_dist = torch.sqrt(torch.gather(sq, 1, cand_idx))
    intersect = (ref_max[:, None] + src_max[cand_idx] + pos_radius) > cand_dist

    d2 = geometry.pairwise_distance(ref_knn_points[:, None], cand_src_knn)  # (M, S, K, K)
    pair_mask = ref_knn_masks[:, None, :, None] & cand_src_knn_masks[:, :, None, :]
    overlap_pt = (d2 < pos_radius**2) & pair_mask
    ref_counts = overlap_pt.any(dim=3).sum(dim=2).float()
    src_counts = overlap_pt.any(dim=2).sum(dim=2).float()
    ref_total = ref_knn_masks.sum(dim=1).float()  # (M,)
    src_total = cand_src_knn_masks.sum(dim=2).float()  # (M, S)
    overlaps = 0.5 * (ref_counts / ref_total[:, None].clamp_min(1.0)
                      + src_counts / src_total.clamp_min(1.0))
    overlaps = torch.where(intersect, overlaps, torch.zeros_like(overlaps))
    overlap_mat = torch.zeros((ref_nodes.shape[0], src_nodes.shape[0]),
                              dtype=torch.float32, device=ref_nodes.device)
    return overlap_mat.scatter_reduce_(1, cand_idx, overlaps, reduce="amax")


def superpoint_targets(overlap_mat, num_targets, overlap_threshold, generator=None,
                       noise=None):
    """Up to ``num_targets`` ground-truth pairs drawn uniformly among those
    with overlap above ``overlap_threshold``: a masked Gumbel top-k with
    ``noise`` (M, N) or, if not given, Gumbel noise from ``generator`` (a
    ``torch.Generator`` on the matrix's device).

    Returns (ref_idx (T,), src_idx (T,), overlaps (T,), valid (T,)); slots
    ordered by flat index, unfilled slots invalid."""
    m, n = overlap_mat.shape
    eligible = overlap_mat > overlap_threshold
    if noise is None:  # standard Gumbel, -log(-log U)
        u = torch.rand((m, n), generator=generator, device=overlap_mat.device)
        noise = -torch.log(-torch.log(u.clamp(torch.finfo(torch.float32).tiny, 1.0 - 2**-24)))
    keyed = torch.where(eligible, noise.to(overlap_mat.device).float(),
                        torch.full_like(overlap_mat, float("-inf")))
    vals, idx = _topk_by_index(keyed.reshape(-1), num_targets)
    ref_idx, src_idx = idx // n, idx % n
    valid = eligible[ref_idx, src_idx] & (vals > float("-inf"))
    return ref_idx, src_idx, overlap_mat[ref_idx, src_idx], valid


def fine_correspondence_matrix(score_mat, ref_knn_masks, src_knn_masks, k,
                               confidence_threshold, mutual):
    """Per-patch top-k (mutual) correspondence mask; score_mat (B, K, K)."""
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    ref_topk, ref_idx = torch.topk(score_mat, k, dim=2)
    ref_sel = torch.zeros_like(score_mat, dtype=torch.bool).scatter_(
        2, ref_idx, ref_topk > confidence_threshold)
    src_topk, src_idx = torch.topk(score_mat, k, dim=1)
    src_sel = torch.zeros_like(score_mat, dtype=torch.bool).scatter_(
        1, src_idx, src_topk > confidence_threshold)
    corr = (ref_sel & src_sel) if mutual else (ref_sel | src_sel)
    return corr & mask_mat


def local_global_registration(ref_knn_points, src_knn_points, ref_knn_masks,
                              src_knn_masks, matching_scores, k=3,
                              acceptance_radius=0.1, mutual=True,
                              confidence_threshold=0.05, use_dustbin=False,
                              correspondence_threshold=3, correspondence_limit=1024,
                              num_refinement_steps=5):
    """Local-to-global registration.

    Patch hypotheses are weighted Procrustes fits over each patch's full
    masked (K, K) score matrix; the hypothesis with the most inliers on the
    global top-C correspondence set seeds ``num_refinement_steps`` re-fits.
    ``corr_inliers`` (C,) marks the correspondences the final fit weighted
    (its inlier decisions; all valid ones where no patch hypothesis was
    valid and no re-fit ran).
    """
    p, kk = ref_knn_masks.shape
    scores = torch.exp(matching_scores)
    if not use_dustbin:
        scores = scores[:, :kk, :kk]
    corr_mat = fine_correspondence_matrix(scores, ref_knn_masks, src_knn_masks, k,
                                          confidence_threshold, mutual)
    score_mat = torch.where(corr_mat, scores, torch.zeros_like(scores))

    flat_w = score_mat.reshape(p, kk * kk)
    ref_rep = ref_knn_points[:, :, None, :].expand(p, kk, kk, 3).reshape(p, kk * kk, 3)
    src_rep = src_knn_points[:, None, :, :].expand(p, kk, kk, 3).reshape(p, kk * kk, 3)
    hypotheses = se3.weighted_procrustes(src_rep, ref_rep, flat_w)  # (P, 4, 4)
    patch_valid = corr_mat.sum(dim=(1, 2)) >= correspondence_threshold

    corr_scores, corr_idx = _topk_by_index(score_mat.reshape(-1), correspondence_limit)
    cp = corr_idx // (kk * kk)
    ci = (corr_idx // kk) % kk
    cj = corr_idx % kk
    ref_corr = ref_knn_points[cp, ci]  # (C, 3)
    src_corr = src_knn_points[cp, cj]
    corr_valid = corr_scores > 0.0
    corr_scores = torch.where(corr_valid, corr_scores, torch.zeros_like(corr_scores))

    aligned = se3.apply_transform(src_corr[None], hypotheses)  # (P, C, 3)
    residual = torch.linalg.norm(ref_corr[None] - aligned, dim=-1)
    inliers = (residual < acceptance_radius) & corr_valid[None]
    counts = inliers.sum(dim=1).masked_fill(~patch_valid, -1)
    best_inliers = inliers[torch.argmax(counts)]
    corr_inliers = torch.where(patch_valid.any(), best_inliers, corr_valid)
    estimated = se3.weighted_procrustes(src_corr, ref_corr, corr_scores * corr_inliers)
    for _ in range(num_refinement_steps - 1):
        res = torch.linalg.norm(ref_corr - se3.apply_transform(src_corr, estimated), dim=-1)
        corr_inliers = (res < acceptance_radius) & corr_valid
        estimated = se3.weighted_procrustes(src_corr, ref_corr, corr_scores * corr_inliers)

    return {
        "ref_corr_points": ref_corr,
        "src_corr_points": src_corr,
        "corr_scores": corr_scores,
        "corr_valid": corr_valid,
        "corr_inliers": corr_inliers,
        "estimated_transform": estimated,
    }

