r"""The SE3ET registration model, serving forward (port of
:mod:`se3et_tpu.nn.model`).

Input is the padded two-cloud pyramid dict of
:func:`se3et_tpu.data.pipeline.build_pair_pyramid` (cloud axis 0 = ref,
1 = src) as tensors on one device (:func:`pyramid_to_tensors`), with the
host-side point-to-node partition (``PyramidConfig.patch_k``) and the
influence weights of :func:`se3et_tpu_torch.data.influence.precompute_influence`.
The forward runs backbone -> transformer -> superpoint matching -> Sinkhorn
-> local-to-global registration with static shapes and no host sync.

The port covers the SE3ET-E/I family (E2PN backbone) with neighbour
indexing (no window maps), the materialised-attention routes and the
fused embedding and Sinkhorn kernels; other settings raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.nn import matching as matching_lib
from se3et_tpu_torch.nn.epn import E2PNBackbone, EPNConfig
from se3et_tpu_torch.nn.layers import init_parameters
from se3et_tpu_torch.nn.transformer import GeometricTransformer
from se3et_tpu_torch.ops import geometry

STOP_POINTS = ("", "backbone", "transformer", "matching", "sinkhorn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters; field-for-field the JAX ``ModelConfig``."""

    compute_dtype: str = "float32"
    bf16_train: bool = False
    backbone: str = "e2pn"
    num_stages: int = 4
    input_dim: int = 1
    ones_features: bool = True
    init_dim: int = 64
    output_dim: int = 256
    kernel_size: int = 15
    init_radius: float = 0.0625
    init_sigma: float = 0.05
    group_norm: int = 32
    gn_joint_stats: bool = False
    backbone_remat: bool = False
    train_fused_conv: bool = True
    train_fused_embedding: bool = True
    train_fused_attention: bool = True
    serve_fused_attention: bool = True
    serve_femb: bool = False
    serve_fused_conv: bool = True
    serve_fused_embedding: bool = True
    serve_fused_sinkhorn: bool = True
    epn: EPNConfig = EPNConfig()
    gt_input_dim: int = 1024
    gt_hidden_dim: int = 256
    gt_output_dim: int = 256
    num_heads: int = 4
    blocks: Sequence[str] = (
        "self_eq", "cross_a_soft", "self_eq", "cross_r_soft",
        "self", "cross", "self", "cross", "self", "cross",
    )
    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"
    supervise_rotation: bool = False
    anchor_matching: bool = False
    align_mode: str = "0"
    n_level_equiv: int = 0
    attn_r_positive: Optional[str] = "sq"
    attn_r_positive_rot_supervise: Optional[str] = "sigmoid"
    attn_r_summ: str = "mean"
    attn_on_sub: bool = False
    attn_r_multihead: bool = False
    ground_truth_matching_radius: float = 0.05
    num_points_in_patch: int = 64
    num_sinkhorn_iterations: int = 100
    num_targets: int = 128
    overlap_threshold: float = 0.1
    num_correspondences: int = 256
    dual_normalization: bool = True
    gt_candidates: int = 48
    fine_topk: int = 3
    acceptance_radius: float = 0.1
    mutual: bool = True
    confidence_threshold: float = 0.05
    use_dustbin: bool = False
    correspondence_threshold: int = 3
    correspondence_limit: int = 1024
    num_refinement_steps: int = 5

    @property
    def kanchor(self) -> int:
        return self.epn.kanchor if self.backbone == "e2pn" else 1


def _check_supported(c: ModelConfig) -> None:
    unsupported = {
        "backbone != 'e2pn'": c.backbone != "e2pn",
        "gn_joint_stats": c.gn_joint_stats,
        "serve_fused_attention (flash attention kernels)": c.serve_fused_attention,
        "serve_fused_sinkhorn=False": not c.serve_fused_sinkhorn,
        "anchor_matching": c.anchor_matching,
        "supervise_rotation": c.supervise_rotation,
        "align_mode != '0'": c.align_mode != "0",
        "attn_r_summ != 'mean'": c.attn_r_summ != "mean",
        "attn_on_sub": c.attn_on_sub,
        "attn_r_multihead": c.attn_r_multihead,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported: {', '.join(bad)}")


def pyramid_to_tensors(data: dict, device) -> dict:
    """numpy pyramid dict -> tensors on ``device`` (float arrays as float32)."""
    out = {}
    for key, val in data.items():
        arr = np.asarray(val)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


class SE3ETModel(nn.Module):
    """Full registration model, serving forward."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        c = cfg
        self.cfg = cfg
        self.backbone_net = E2PNBackbone(
            input_dim=c.input_dim, output_dim=c.output_dim, init_dim=c.init_dim,
            init_radius=c.init_radius, group_norm=c.group_norm, config=c.epn,
            num_stages=c.num_stages, ones_input=c.ones_features,
        )
        self.transformer = GeometricTransformer(
            input_dim=c.gt_input_dim, output_dim=c.gt_output_dim,
            hidden_dim=c.gt_hidden_dim, num_heads=c.num_heads, blocks=tuple(c.blocks),
            sigma_d=c.sigma_d, sigma_a=c.sigma_a, angle_k=c.angle_k,
            reduction_a=c.reduction_a, na=c.kanchor, attn_r_positive=c.attn_r_positive,
            n_level_equiv=c.n_level_equiv,
        )
        self.optimal_transport = matching_lib.LearnableLogOptimalTransport(
            c.num_sinkhorn_iterations)
        init_parameters(self, torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def forward(self, data: dict, with_registration: bool = True, stop_after: str = ""):
        """``stop_after`` in {'backbone', 'transformer', 'matching', 'sinkhorn'}
        returns early (cut points for section-wise comparison)."""
        if stop_after not in STOP_POINTS:
            raise ValueError(f"stop_after must be one of {STOP_POINTS}")
        with prec.compute_dtype_scope(self.cfg.compute_dtype):
            return self._forward(data, with_registration, stop_after)

    def _forward(self, data, with_registration, stop_after):
        c = self.cfg
        coarse, fine = c.num_stages - 1, 1
        points_c, masks_c = data[f"points_{coarse}"], data[f"masks_{coarse}"]
        points_f = data[f"points_{fine}"]
        knn_idx = data.get("node_knn_indices")
        if (knn_idx is None or knn_idx.shape[-1] != c.num_points_in_patch
                or knn_idx.shape[-2] != points_c.shape[1]):
            raise ValueError(
                "the pyramid must carry the host point-to-node partition of this "
                "model's stages (PyramidConfig.patch_k = num_points_in_patch)")
        if "influence_same_0" not in data:
            raise ValueError("the pyramid must carry host influence weights "
                             "(se3et_tpu_torch.data.influence.precompute_influence)")
        node_masks = data["patch_node_masks"]
        knn_masks = data["node_knn_masks"]
        knn_points = [geometry.gather_with_sentinel(points_f[i], knn_idx[i]) for i in range(2)]
        out = {"ref_node_masks": node_masks[0], "src_node_masks": node_masks[1]}

        # 1. backbone
        feats_f, feats_c = self.backbone_net(data["features"], data)
        feats_f, feats_c = feats_f.float(), feats_c.float()
        if stop_after == "backbone":
            return {"feats_f": feats_f, "feats_c": feats_c}

        # 2. coarse transformer (batch of one pair)
        ref_out, src_out, ref_feat_m, src_feat_m = self.transformer(
            points_c[0][None], points_c[1][None], feats_c[0][None], feats_c[1][None],
            masks_c[0][None], masks_c[1][None],
            fused_embedding=c.serve_fused_embedding,
        )
        out["ref_feats_m"], out["src_feats_m"] = ref_feat_m, src_feat_m
        ref_feats_c = ref_out[0].float()
        src_feats_c = src_out[0].float()
        out["ref_feats_c"] = ref_feats_c / (
            torch.linalg.norm(ref_feats_c, dim=-1, keepdim=True) + 1e-12)
        out["src_feats_c"] = src_feats_c / (
            torch.linalg.norm(src_feats_c, dim=-1, keepdim=True) + 1e-12)
        out["ref_feats_f"], out["src_feats_f"] = feats_f[0], feats_f[1]
        if stop_after == "transformer":
            return out

        # 3. coarse correspondences and patch gather
        ref_idx, src_idx, _, corr_valid = matching_lib.superpoint_matching(
            out["ref_feats_c"], out["src_feats_c"], node_masks[0], node_masks[1],
            c.num_correspondences, c.dual_normalization,
        )
        out["ref_node_corr_indices"] = ref_idx
        out["src_node_corr_indices"] = src_idx
        out["node_corr_valid"] = corr_valid
        sel_ref_knn_idx = knn_idx[0][ref_idx]  # (P, K)
        sel_src_knn_idx = knn_idx[1][src_idx]
        out["ref_node_corr_knn_points"] = knn_points[0][ref_idx]
        out["src_node_corr_knn_points"] = knn_points[1][src_idx]
        out["ref_node_corr_knn_masks"] = knn_masks[0][ref_idx] & corr_valid[:, None]
        out["src_node_corr_knn_masks"] = knn_masks[1][src_idx] & corr_valid[:, None]
        sel_ref_feats = geometry.gather_with_sentinel(feats_f[0], sel_ref_knn_idx)
        sel_src_feats = geometry.gather_with_sentinel(feats_f[1], sel_src_knn_idx)
        if stop_after == "matching":
            out["_gathered_feats"] = (sel_ref_feats, sel_src_feats)
            return out

        # inference rotation: cross-anchor similarity of matched-node
        # equivariant features
        if ref_feat_m is not None and src_feat_m is not None:
            def _norm_flat(x):
                flat = x.reshape(x.shape[0], -1)
                return (flat / (torch.linalg.norm(flat, dim=-1, keepdim=True) + 1e-9)
                        ).reshape(x.shape)

            rm = _norm_flat(ref_feat_m[0][:, ref_idx].float())  # (A, P, C)
            sm = _norm_flat(src_feat_m[0][:, src_idx].float())
            out["rot_sup_matrix"] = (torch.einsum("anc,enc->ae", rm, sm) + 1.0) / 2.0

        # 4. optimal transport (kernel K4)
        scores = torch.einsum("pnd,pmd->pnm", sel_ref_feats, sel_src_feats) / float(
            np.sqrt(feats_f.shape[-1]))
        out["matching_scores"] = self.optimal_transport(
            scores, out["ref_node_corr_knn_masks"], out["src_node_corr_knn_masks"])
        if stop_after == "sinkhorn":
            return out

        # 5. local-to-global registration
        if with_registration:
            out.update(matching_lib.local_global_registration(
                out["ref_node_corr_knn_points"], out["src_node_corr_knn_points"],
                out["ref_node_corr_knn_masks"], out["src_node_corr_knn_masks"],
                out["matching_scores"], k=c.fine_topk,
                acceptance_radius=c.acceptance_radius, mutual=c.mutual,
                confidence_threshold=c.confidence_threshold, use_dustbin=c.use_dustbin,
                correspondence_threshold=c.correspondence_threshold,
                correspondence_limit=c.correspondence_limit,
                num_refinement_steps=c.num_refinement_steps,
            ))
        return out
