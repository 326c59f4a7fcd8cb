r"""The SE3ET registration model, serving and training forward (port of
:mod:`se3et_tpu.nn.model`).

Input is the padded two-cloud pyramid dict of
:func:`se3et_tpu_torch.data.pipeline.build_pair_pyramid` (cloud axis 0 = ref,
1 = src) as tensors on one device (:func:`pyramid_to_tensors`), with the
host-side point-to-node partition (``PyramidConfig.patch_k``).  Influence
weights come from the pyramid where it carries them
(:func:`se3et_tpu_torch.data.influence.precompute_influence`), else they are
computed on the card (kernel K15), as in the JAX package.  The forward runs
backbone -> transformer -> superpoint matching -> Sinkhorn ->
local-to-global registration with static shapes and no host sync.
``train=True`` is the route of the JAX training step: float32 features,
the ground-truth overlaps and sampled target correspondences, the
differentiable kernels (K1-K5 with their backwards K8-K11) and the
materialised EQ cross layers.

The port covers the SE3ET-E/I family (E2PN backbone) with neighbour
indexing (no window maps), the fused serving convs (``serve_fused_conv``,
the default: K12-K14) or the K1 + matmul route, the flash attention kernels
(``serve_fused_attention``, the default) or the materialised-attention
routes, the fused embedding (K3) or, with ``serve_femb``, the embedding
recomputed inside the flash self layers (K16), and the Sinkhorn kernel;
other settings raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.data import influence as influence_lib
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
        # rematerialising the backbone in the backward changes memory, not
        # the function; refused until training ports it, so it is never
        # accepted and ignored
        "backbone_remat": c.backbone_remat,
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
    """Full registration model, serving and training forward."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        """Weights are drawn on the CPU from ``torch.Generator(seed)`` and
        then put on ``device`` (the card unless the caller asks otherwise;
        there is no fallback to the CPU)."""
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SE3ETModel: no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        _check_supported(cfg)
        c = cfg
        self.cfg = cfg
        self.backbone_net = E2PNBackbone(
            input_dim=c.input_dim, output_dim=c.output_dim, init_dim=c.init_dim,
            init_radius=c.init_radius, init_sigma=c.init_sigma, group_norm=c.group_norm,
            config=c.epn, kernel_points=functools.partial(influence_lib._kernel_points_for, c),
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
        self.to(device)

    def forward(self, data: dict, train: bool = False, with_registration: bool = True,
                with_gt: bool = False, stop_after: str = "", generator=None,
                target_noise=None):
        """``stop_after`` in {'backbone', 'transformer', 'matching', 'sinkhorn'}
        returns early (cut points for section-wise comparison).

        ``train=True`` is the training route (float32 unless ``bf16_train``;
        autograd on): it adds ``gt_overlap_mat`` and replaces the coarse
        correspondences by :func:`~se3et_tpu_torch.nn.matching.superpoint_targets`,
        whose Gumbel noise comes from ``generator`` (a ``torch.Generator`` on
        the model's device) or is given as ``target_noise`` (M, N).
        ``with_gt`` adds ``gt_overlap_mat`` outside training.  Serving
        (``train=False``) runs under ``torch.no_grad``."""
        if stop_after not in STOP_POINTS:
            raise ValueError(f"stop_after must be one of {STOP_POINTS}")
        c = self.cfg
        dtype = c.compute_dtype if (not train or c.bf16_train) else "float32"
        with prec.compute_dtype_scope(dtype), torch.set_grad_enabled(
                train and torch.is_grad_enabled()):
            return self._forward(data, train, with_registration, with_gt, stop_after,
                                 generator, target_noise)

    def _forward(self, data, train, with_registration, with_gt, stop_after, generator,
                 target_noise):
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
        node_masks = data["patch_node_masks"]
        knn_masks = data["node_knn_masks"]
        knn_points = [geometry.gather_with_sentinel(points_f[i], knn_idx[i]) for i in range(2)]
        out = {"ref_node_masks": node_masks[0], "src_node_masks": node_masks[1]}
        if with_gt or train:
            out["gt_overlap_mat"] = matching_lib.node_correspondences(
                points_c[0], points_c[1], knn_points[0], knn_points[1], data["transform"],
                c.ground_truth_matching_radius, node_masks[0], node_masks[1],
                knn_masks[0], knn_masks[1], num_candidates=c.gt_candidates)

        # 1. backbone
        feats_f, feats_c = self.backbone_net(data["features"], data,
                                             fused=(not train) and c.serve_fused_conv)
        feats_f, feats_c = feats_f.float(), feats_c.float()
        if stop_after == "backbone":
            return {"feats_f": feats_f, "feats_c": feats_c}

        # 2. coarse transformer (batch of one pair)
        ref_out, src_out, ref_feat_m, src_feat_m = self.transformer(
            points_c[0][None], points_c[1][None], feats_c[0][None], feats_c[1][None],
            masks_c[0][None], masks_c[1][None],
            fused_embedding=c.train_fused_embedding if train else c.serve_fused_embedding,
            fused_attention=c.train_fused_attention if train else c.serve_fused_attention,
            # the EQ cross kernels have no backward: training is materialised
            fused_attention_cross=(not train) and c.serve_fused_attention,
            fused_femb=(not train) and c.serve_fused_attention and c.serve_femb,
            # the JAX embedding kernel writes bf16 in training too
            emb_dtype=torch.bfloat16 if train else None,
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
            out["ref_feats_c"].detach(), out["src_feats_c"].detach(), node_masks[0],
            node_masks[1], c.num_correspondences, c.dual_normalization,
        )
        out["ref_node_corr_indices"] = ref_idx
        out["src_node_corr_indices"] = src_idx
        out["node_corr_valid"] = corr_valid
        if train:
            ref_idx, src_idx, _, corr_valid = matching_lib.superpoint_targets(
                out["gt_overlap_mat"], c.num_targets, c.overlap_threshold,
                generator=generator, noise=target_noise)
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

            rm = _norm_flat(ref_feat_m[0][:, ref_idx].detach().float())  # (A, P, C)
            sm = _norm_flat(src_feat_m[0][:, src_idx].detach().float())
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
                out["matching_scores"].detach(), k=c.fine_topk,
                acceptance_radius=c.acceptance_radius, mutual=c.mutual,
                confidence_threshold=c.confidence_threshold, use_dustbin=c.use_dustbin,
                correspondence_threshold=c.correspondence_threshold,
                correspondence_limit=c.correspondence_limit,
                num_refinement_steps=c.num_refinement_steps,
            ))
        return out
