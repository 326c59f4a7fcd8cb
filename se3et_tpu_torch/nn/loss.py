r"""Training losses (port of :mod:`se3et_tpu.nn.loss`): the overlap-weighted
circle loss on superpoint features and the negative log-likelihood of the
Sinkhorn matrix with slack labels, on the dense masked outputs of the
training forward (the gt correspondence list is the (M, N) overlap
matrix).

The rotation-matching loss waits with ``supervise_rotation``, which the
port does not run; :func:`overall_loss` refuses it.

:func:`evaluate` is the in-graph evaluator of the serving forward (PIR,
IR, RRE, RTE, RMSE and RR), made of tensor operations only, so that it runs
inside the captured serving graph.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from se3et_tpu_torch.core import se3
from se3et_tpu_torch.ops import geometry


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Field-for-field the JAX ``LossConfig``."""

    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 24.0
    positive_overlap: float = 0.1
    fine_positive_radius: float = 0.05
    weight_coarse_loss: float = 1.0
    weight_fine_loss: float = 1.0
    weight_rotation_loss: float = 1.0
    supervise_rotation: bool = False
    kanchor: int = 6


def weighted_circle_loss(pos_masks, neg_masks, feat_dists, pos_scales=None, neg_scales=None,
                         positive_margin=0.1, negative_margin=1.4, positive_optimal=0.1,
                         negative_optimal=1.4, log_scale=24.0):
    """Overlap-weighted circle loss over feature distances (M, N); rows and
    columns with no positive or no negative are left out of the means."""
    pos_w = torch.clamp_min(feat_dists - positive_optimal, 0.0)
    if pos_scales is not None:
        pos_w = pos_w * pos_scales
    neg_w = torch.clamp_min(negative_optimal - feat_dists, 0.0)
    if neg_scales is not None:
        neg_w = neg_w * neg_scales
    neg_big = torch.tensor(-1e12, dtype=feat_dists.dtype, device=feat_dists.device)
    pos_logits = torch.where(pos_masks, log_scale * pos_w * (feat_dists - positive_margin),
                             neg_big)
    neg_logits = torch.where(neg_masks, -log_scale * neg_w * (feat_dists - negative_margin),
                             neg_big)

    def side(dim):
        loss = F.softplus(torch.logsumexp(pos_logits, dim=dim)
                          + torch.logsumexp(neg_logits, dim=dim)) / log_scale
        ok = pos_masks.any(dim=dim) & neg_masks.any(dim=dim)
        return (loss * ok).sum() / ok.sum().clamp_min(1)

    return 0.5 * (side(-1) + side(-2))


def coarse_matching_loss(output, cfg: LossConfig):
    """Weighted circle loss of the unit-norm superpoint features against the
    ground-truth overlaps; padded nodes are neither positives nor negatives."""
    dists = torch.sqrt(geometry.pairwise_distance(output["ref_feats_c"], output["src_feats_c"],
                                                  normalized=True))
    overlaps = output["gt_overlap_mat"]
    valid_pair = output["ref_node_masks"][:, None] & output["src_node_masks"][None, :]
    pos_masks = (overlaps > cfg.positive_overlap) & valid_pair
    neg_masks = (overlaps == 0.0) & valid_pair
    return weighted_circle_loss(
        pos_masks, neg_masks, dists, torch.sqrt(overlaps * pos_masks),
        positive_margin=cfg.positive_margin, negative_margin=cfg.negative_margin,
        positive_optimal=cfg.positive_optimal, negative_optimal=cfg.negative_optimal,
        log_scale=cfg.log_scale)


def fine_matching_loss(output, transform, cfg: LossConfig):
    """Negative log-likelihood of the Sinkhorn log-probabilities (P, K+1, K+1)
    at the ground-truth point pairs, with slack-row / slack-column labels for
    points without a partner."""
    ref_m = output["ref_node_corr_knn_masks"]
    src_m = output["src_node_corr_knn_masks"]
    scores = output["matching_scores"]
    src_knn = se3.apply_transform(output["src_node_corr_knn_points"], transform)
    d2 = geometry.pairwise_distance(output["ref_node_corr_knn_points"], src_knn)
    gt_corr = (d2 < cfg.fine_positive_radius**2) & ref_m[:, :, None] & src_m[:, None, :]
    k = ref_m.shape[1]
    labels = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    labels[:, :k, :k] = gt_corr
    labels[:, :k, k] = ~gt_corr.any(dim=2) & ref_m
    labels[:, k, :k] = ~gt_corr.any(dim=1) & src_m
    return -(scores * labels).sum() / labels.sum().clamp_min(1)


def overall_loss(output, data, cfg: LossConfig):
    """(total, {"c_loss", "f_loss", "loss"}): the weighted sum of the coarse
    and fine losses."""
    if cfg.supervise_rotation:
        raise NotImplementedError("not ported: the rotation-matching loss")
    c_loss = coarse_matching_loss(output, cfg)
    f_loss = fine_matching_loss(output, data["transform"], cfg)
    total = cfg.weight_coarse_loss * c_loss + cfg.weight_fine_loss * f_loss
    return total, {"c_loss": c_loss, "f_loss": f_loss, "loss": total}


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Field-for-field the JAX ``EvalConfig``; the ``ransac_*`` fields are
    the offline evaluator's ``--method ransac`` settings."""

    acceptance_overlap: float = 0.0
    acceptance_radius: float = 0.1
    rmse_threshold: float = 0.2
    rre_threshold: float = 15.0
    rte_threshold: float = 0.3
    kitti_registration: bool = False  # RR = (RRE < rre_threshold) & (RTE < rte_threshold)
    ransac_distance_threshold: float = 0.05
    ransac_num_points: int = 3
    ransac_num_iterations: int = 50000


def evaluate(output, data, cfg: EvalConfig):
    """{"PIR", "IR", "RRE", "RTE", "RMSE", "RR"} as 0-d float32 tensors on
    the outputs' device, from a serving output that carries
    ``gt_overlap_mat`` (``with_gt=True``).

    PIR: the share of valid coarse correspondences whose ground-truth
    overlap exceeds ``acceptance_overlap``; IR: the share of valid fine
    correspondences within ``acceptance_radius`` under the ground-truth
    transform; RMSE: the mean displacement of the valid source points
    under ``inv(gt) @ est``; RR: ``RMSE < rmse_threshold``, or with
    ``kitti_registration`` ``RRE < rre_threshold and RTE < rte_threshold``.
    Every threshold is a tensor comparison: nothing is read back to the
    host."""
    transform = data["transform"]
    metrics = {}
    gt_map = output["gt_overlap_mat"] > cfg.acceptance_overlap
    valid = output["node_corr_valid"]
    hits = gt_map[output["ref_node_corr_indices"].long(),
                  output["src_node_corr_indices"].long()] & valid
    metrics["PIR"] = hits.sum() / valid.sum().clamp_min(1)

    src_corr = se3.apply_transform(output["src_corr_points"], transform)
    cd = torch.linalg.norm(output["ref_corr_points"] - src_corr, dim=1)
    cv = output["corr_valid"]
    metrics["IR"] = ((cd < cfg.acceptance_radius) & cv).sum() / cv.sum().clamp_min(1)

    est = output["estimated_transform"]
    rre, rte = se3.isotropic_transform_error(transform, est)
    metrics["RRE"], metrics["RTE"] = rre, rte

    src_points, src_masks = data["points_0"][1], data["masks_0"][1]
    moved = se3.apply_transform(src_points, se3.inverse_transform(transform) @ est)
    err = torch.linalg.norm(moved - src_points, dim=1)
    metrics["RMSE"] = (err * src_masks).sum() / src_masks.sum().clamp_min(1)
    if cfg.kitti_registration:
        metrics["RR"] = ((rre < cfg.rre_threshold) & (rte < cfg.rte_threshold)).float()
    else:
        metrics["RR"] = (metrics["RMSE"] < cfg.rmse_threshold).float()
    return metrics
