r"""Conditional transformer (block scheduler) + GeometricTransformer wrapper
(port of :mod:`se3et_tpu.nn.transformer`).

The scheduler interprets the experiment's ``blocks`` list (SE3ET-E:
``self_eq, cross_a_soft, self_eq, cross_r_soft, self, cross, ...``) and
handles the equivariant <-> invariant transitions: a ``self_eq`` before a
plain ``cross`` pools anchors by max; plain ``cross`` between ``self_eq``
blocks attends with invariant q/k over equivariant values; ``cross_r_soft``
before plain blocks fuses anchors by the soft rotation weights and
:class:`RotCompressOutput`.

With ``fused_attention`` the self layers take the flash kernel
K5 when every one of them can (``flash_self``: equal clouds of a
128-multiple coarse size): ref and src then go through ONE launch per
layer on the stacked (2, N, N, C) embedding, and the (B, A, N, M, 4)
equivariant embedding is never built (K5 computes the SH term from the
coordinates).  ``fused_attention_cross`` routes the EQ cross layers
through K6 + K7 (serving only: they have no backward, and training takes
the materialised cross route, as the JAX package does).  ``fused_femb``
(serving, ``serve_femb``) goes one step further where the JAX package does
(both clouds stacked with masks, ``flash_self``, ``reduction_a == "max"``):
no embedding is computed, and each flash self layer runs K16, which
rebuilds the embedding rows from the coordinates.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.core import anchors as anchor_lib
from se3et_tpu_torch.nn.attention import (
    RotCompressOutput, RPETransformerLayer, TransformerLayer,
)
from se3et_tpu_torch.nn.embedding import GeometricStructureEmbedding
from se3et_tpu_torch.nn.layers import TorchLinear
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_flash

EQ_BLOCKS = (
    "self_eq", "cross_eq", "cross_a_soft", "cross_a_best", "cross_r_soft",
    "cross_r_best",
)


def _block_attn_mode(block: str) -> Optional[str]:
    if "_eq" in block:
        return None
    for mode in ("a_soft", "a_best", "r_soft", "r_best"):
        if mode in block:
            return mode
    return None


class RPEConditionalTransformer(nn.Module):
    """Block scheduler over ref/src coarse features."""

    def __init__(self, blocks: Sequence[str], d_model, num_heads, activation_fn="ReLU",
                 na=4, attn_r_positive="sq", d_equiv_embed=0):
        super().__init__()
        self.blocks = tuple(blocks)
        layers = []
        for block in self.blocks:
            eq = block in EQ_BLOCKS
            if "self" in block:
                layers.append(RPETransformerLayer(
                    d_model, num_heads, activation_fn=activation_fn, equivariant=eq,
                    d_equiv_embed=d_equiv_embed, kanchor=na))
            else:
                layers.append(TransformerLayer(
                    d_model, num_heads, activation_fn=activation_fn, equivariant=eq,
                    attn_mode=_block_attn_mode(block), kanchor=na,
                    attn_r_positive=attn_r_positive))
        self.layers = nn.ModuleList(layers)
        if any("r_best" in b for b in self.blocks):
            raise NotImplementedError("r_best blocks")
        if any("r_soft" in b for b in self.blocks):
            self.rotcompress = RotCompressOutput(d_model, na, activation_fn)
            quotient = {1: 1, 3: 1, 4: 3, 6: 4, 12: 5}.get(na, 1)
            trace = anchor_lib.get_anchor_space(na, quotient).trace_idx_ori
            self.register_buffer("trace_ori", torch.as_tensor(trace, dtype=torch.long),
                                 persistent=False)

    def _eq2inv_soft(self, feats0, feats1, attn_w0):
        """Soft rotation-weighted anchor fusion (align mode '0'): src anchors
        are fused by the ref block's rotation weights attn_w0 (B, R)."""
        permuted = feats1[:, self.trace_ori]  # (B, R, A, N, C)
        fused = torch.sum(permuted * attn_w0[:, :, None, None, None].to(permuted.dtype),
                          dim=1)
        return self.rotcompress(feats0), self.rotcompress(fused)

    def forward(self, feats0, feats1, embeddings0, embeddings1, masks0=None,
                masks1=None, equiv_embed0=None, equiv_embed1=None, use_flash=False,
                points0=None, points1=None, stacked=None, use_flash_cross=None,
                femb_pack=None):
        """feats (B, A, N, C) equivariant or (B, N, C) invariant coarse feats.

        ``stacked``: optional (emb, masks, points) with both clouds on the
        leading axis; the self layers then run one flash launch over both
        (with ``femb_pack`` (knn_points, wd, wa, sigma_d, sigma_a, tables)
        and emb None, K16's)."""
        feats0_eq = feats1_eq = None
        ref_feat_m = src_feat_m = None
        blocks = self.blocks
        flash_cross = use_flash if use_flash_cross is None else use_flash_cross
        for i, block in enumerate(blocks):
            layer = self.layers[i]
            if "self" in block:
                in0, in1 = (feats0_eq, feats1_eq) if feats0_eq is not None else (feats0, feats1)
                if stacked is not None and in0.shape == in1.shape:
                    emb_s, masks_s, points_s = stacked
                    ins = torch.cat([in0, in1])
                    outs, _ = layer(ins, ins, emb_s, memory_masks=masks_s, points=points_s,
                                    use_flash=True, femb_pack=femb_pack)
                    nb = in0.shape[0]
                    feats0, feats1 = outs[:nb], outs[nb:]
                else:
                    feats0, _ = layer(in0, in0, embeddings0, memory_masks=masks0,
                                      equiv_states=equiv_embed0, points=points0,
                                      use_flash=use_flash)
                    feats1, _ = layer(in1, in1, embeddings1, memory_masks=masks1,
                                      equiv_states=equiv_embed1, points=points1,
                                      use_flash=use_flash)
                if block == "self_eq" and i + 1 < len(blocks) and blocks[i + 1] == "cross":
                    # next block is plain cross: pool to invariant, remember eq
                    feats0_eq, feats1_eq = feats0, feats1
                    feats0, feats1 = feats0_eq.amax(dim=1), feats1_eq.amax(dim=1)
                continue

            next_is_self_eq = i + 1 < len(blocks) and blocks[i + 1] == "self_eq"
            last = i + 1 == len(blocks)
            if block == "cross" and (
                next_is_self_eq or (last and i > 0 and blocks[i - 1] == "self_eq")
            ):
                # invariant q/k with equivariant values -> equivariant output
                feats0_eq, _ = layer(feats0, feats1, feats1_eq, memory_masks=masks1)
                feats0_new = feats0_eq.amax(dim=1)
                feats1_eq, _ = layer(feats1, feats0, feats0_eq, memory_masks=masks0)
                feats1 = feats1_eq.amax(dim=1)
                feats0 = feats0_new
                if last:
                    ref_feat_m, src_feat_m = feats0_eq, feats1_eq
                continue

            feats0_new, aux0 = layer(feats0, feats1, memory_masks=masks1, q_masks=masks0,
                                     use_flash=flash_cross)
            feats1_new, _ = layer(feats1, feats0, memory_masks=masks0, q_masks=masks1,
                                  use_flash=flash_cross)
            feats0, feats1 = feats0_new, feats1_new
            if "r_soft" in block:
                ref_feat_m, src_feat_m = feats0, feats1
                if last:
                    feats0, feats1 = feats0.amax(dim=1), feats1.amax(dim=1)
                elif blocks[i + 1] not in EQ_BLOCKS:
                    feats0_eq = feats1_eq = None
                    feats0, feats1 = self._eq2inv_soft(feats0, feats1, aux0["attn_w"])

        if feats0.ndim == 4:
            feats0, feats1 = feats0.amax(dim=1), feats1.amax(dim=1)
        return feats0, feats1, ref_feat_m, src_feat_m


class GeometricTransformer(nn.Module):
    """in_proj -> geometric embedding -> conditional transformer -> out_proj."""

    def __init__(self, input_dim, output_dim, hidden_dim, num_heads, blocks, sigma_d,
                 sigma_a, angle_k, activation_fn="ReLU", reduction_a="max", na=None,
                 attn_r_positive="sq", n_level_equiv=0):
        super().__init__()
        self.na = na
        d_equiv_embed = int(np.sum(2 * np.arange(n_level_equiv) + 1))
        self.d_equiv_embed = d_equiv_embed
        self.GeometricStructureEmbedding_0 = GeometricStructureEmbedding(
            hidden_dim, sigma_d, sigma_a, angle_k, reduction_a=reduction_a,
            kanchor=na or 1, n_level_equiv=n_level_equiv)
        self.TorchLinear_0 = TorchLinear(input_dim, hidden_dim)  # in_proj
        self.TorchLinear_1 = TorchLinear(hidden_dim, output_dim)  # out_proj
        self.RPEConditionalTransformer_0 = RPEConditionalTransformer(
            blocks, hidden_dim, num_heads, activation_fn=activation_fn, na=na or 4,
            attn_r_positive=attn_r_positive, d_equiv_embed=d_equiv_embed)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_masks,
                src_masks, fused_embedding=False, fused_attention=False,
                fused_attention_cross=None, emb_dtype=None, fused_femb=False):
        """points (B, N, 3); feats (B, N, [A,] C_in) -> (ref_out, src_out,
        ref_feat_m, src_feat_m); outputs (B, N, C_out).  ``emb_dtype``: the
        fused embedding's output type (see GeometricStructureEmbedding)."""
        nb = ref_points.shape[0]
        n_coarse = ref_points.shape[1]
        de = self.d_equiv_embed
        flash_self = (
            fused_attention and n_coarse == src_points.shape[1] and n_coarse % 128 == 0
            and (de == 0 or (de == 4 and (self.na or 1) > 1))
        )
        embed = self.GeometricStructureEmbedding_0
        stacked = femb_pack = None
        ref_eq = src_eq = None
        if ref_points.shape == src_points.shape:
            # both clouds through one embedding evaluation
            pts = torch.cat([ref_points, src_points])
            mks = torch.cat([ref_masks, src_masks])
            if flash_self and fused_femb and embed.reduction_a == "max":
                # no embedding: each flash self layer rebuilds its rows (K16)
                # from tables folded once here for all of them (on the card:
                # the CPU's plain version folds its own)
                wd, wa, knn_pts = embed(pts, mks, tables_only=True)
                tables = rpe_flash.femb_tables(
                    wd, wa, embed.sigma_a,
                    prec.compute_dtype() or torch.float32) if pts.is_cuda else None
                femb_pack = (knn_pts, wd, wa, embed.sigma_d, embed.sigma_a, tables)
                ref_emb = src_emb = None
                stacked = (None, mks, pts)
            else:
                emb, eq_emb = embed(pts, mks, fused=fused_embedding,
                                    compute_equiv=not flash_self, out_dtype=emb_dtype)
                if flash_self:
                    # the flash self layers take the stacked embedding as it is
                    ref_emb = src_emb = None
                    stacked = (emb, mks, pts)
                else:
                    ref_emb, src_emb = emb[:nb], emb[nb:]
                if eq_emb is not None:
                    ref_eq, src_eq = eq_emb[:nb], eq_emb[nb:]
        else:
            ref_emb, ref_eq = embed(ref_points, ref_masks, fused=fused_embedding,
                                    compute_equiv=not flash_self, out_dtype=emb_dtype)
            src_emb, src_eq = embed(src_points, src_masks, fused=fused_embedding,
                                    compute_equiv=not flash_self, out_dtype=emb_dtype)
        if self.na is None or self.na == 1:
            f0, f1 = self.TorchLinear_0(ref_feats), self.TorchLinear_0(src_feats)
        else:
            # (B, N, A, C) -> (B, A, N, C)
            f0 = self.TorchLinear_0(ref_feats.transpose(1, 2))
            f1 = self.TorchLinear_0(src_feats.transpose(1, 2))
        f0, f1, ref_feat_m, src_feat_m = self.RPEConditionalTransformer_0(
            f0, f1, ref_emb, src_emb, masks0=ref_masks, masks1=src_masks,
            equiv_embed0=ref_eq, equiv_embed1=src_eq, use_flash=fused_attention,
            points0=ref_points if flash_self else None,
            points1=src_points if flash_self else None, stacked=stacked,
            use_flash_cross=fused_attention_cross, femb_pack=femb_pack)
        return self.TorchLinear_1(f0), self.TorchLinear_1(f1), ref_feat_m, src_feat_m
