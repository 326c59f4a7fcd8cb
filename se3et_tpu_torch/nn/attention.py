r"""Multi-head attention layers: invariant, RPE, anchor-equivariant
(port of :mod:`se3et_tpu.nn.attention`).

Conventions kept from the JAX package: ``key_masks`` is True for *valid*
keys; attention tensors are (B, [A,] H, N, d); the RPE positional and
equivariant-SH terms fold the projection into the query
(``s_p = (q W_p^T) . emb + q . b_p``) instead of projecting the (N, M)
embedding.  Scores are summed and soft-maxed in float32.

``use_flash`` routes the RPE self layers through kernel K5 (differentiable:
its backward is K11) and, in serving, the ``a_soft`` / ``r_soft`` EQ cross
layers through K6 + K7, as the JAX package routes them through its Pallas
kernels; the materialised routes stay for training's cross layers and the
configurations the flash gates refuse.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.core import anchors as anchor_lib
from se3et_tpu_torch.core import harmonics
from se3et_tpu_torch.nn.layers import LayerNorm, TorchLinear, build_activation, uniform_
from se3et_tpu_torch.ops.kernels import eq_attention as eq_flash
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_flash
from se3et_tpu_torch.ops.kernels.eq_attention import _positive

_NEG = -1e9


def _split_heads(x, num_heads):
    """(..., N, H*C) -> (..., H, N, C)"""
    *lead, n, d = x.shape
    return x.reshape(*lead, n, num_heads, d // num_heads).movedim(-2, -3)


def _merge_heads(x):
    """(..., H, N, C) -> (..., N, H*C)"""
    x = x.movedim(-3, -2)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _masked_softmax(scores, key_masks):
    """float32 softmax over the last axis; key_masks (B, M) broadcast from
    the batch axis to the key axis."""
    s = scores.float()
    if key_masks is not None:
        km = key_masks.reshape(key_masks.shape[0], *(1,) * (s.ndim - 2), key_masks.shape[1])
        s = s.masked_fill(~km, _NEG)
    return torch.softmax(s, dim=-1)


class MultiHeadAttention(nn.Module):
    """Vanilla invariant attention; values may be equivariant (B, A, M, C)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.TorchLinear_0 = TorchLinear(d_model, d_model)
        self.TorchLinear_1 = TorchLinear(d_model, d_model)
        self.TorchLinear_2 = TorchLinear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, key_masks=None):
        h = self.num_heads
        q = _split_heads(self.TorchLinear_0(input_q), h)  # (B, H, N, c)
        k = _split_heads(self.TorchLinear_1(input_k), h)
        v = _split_heads(self.TorchLinear_2(input_v), h)  # (B, [A,] H, M, c)
        scores = torch.einsum("bhnc,bhmc->bhnm", q, k) / math.sqrt(self.d_model // h)
        scores = _masked_softmax(scores, key_masks).to(v.dtype)
        if input_v.ndim == 4:
            hidden = torch.einsum("bhnm,bahmc->bahnc", scores, v)
        else:
            hidden = torch.einsum("bhnm,bhmc->bhnc", scores, v)
        return _merge_heads(hidden), {}


class RPEMultiHeadAttention(nn.Module):
    """Self-attention with geometric relative positional embedding,
    optionally anchor-equivariant with the extra SH-embedding score term."""

    def __init__(self, d_model, num_heads, equivariant=False, d_equiv_embed=0, kanchor=0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.equivariant = equivariant
        self.d_equiv_embed = d_equiv_embed
        self.kanchor = kanchor
        self.TorchLinear_0 = TorchLinear(d_model, d_model)
        self.TorchLinear_1 = TorchLinear(d_model, d_model)
        self.TorchLinear_2 = TorchLinear(d_model, d_model)
        self.proj_p_kernel = nn.Parameter(torch.empty(d_model, d_model))
        self.proj_p_bias = nn.Parameter(torch.empty(d_model))
        self.with_eq_term = equivariant and d_equiv_embed > 0
        if self.with_eq_term:
            self.proj_eq_kernel = nn.Parameter(torch.empty(d_equiv_embed, d_model))
            self.proj_eq_bias = nn.Parameter(torch.empty(d_model))
        if self.with_eq_term and d_equiv_embed == 4 and kanchor > 1:
            # the flash route folds the anchors' degree-1 Wigner-D blocks
            # into the SH query (rpe_attention.fold_equivariant_query)
            space = anchor_lib.get_anchor_space(kanchor, {4: 3, 6: 4, 12: 5}.get(kanchor, 1))
            wd1 = harmonics.anchor_wigner_d([0, 1], space.anchors)[1]
            self.register_buffer("wigner_d1", torch.as_tensor(wd1, dtype=torch.float32),
                                 persistent=False)

    def reset_parameters_with(self, generator):
        bound = 1.0 / math.sqrt(self.d_model)
        uniform_(self.proj_p_kernel, bound, generator)
        uniform_(self.proj_p_bias, bound, generator)
        if self.with_eq_term:
            bound = 1.0 / math.sqrt(self.d_equiv_embed)
            uniform_(self.proj_eq_kernel, bound, generator)
            uniform_(self.proj_eq_bias, bound, generator)

    def _flash_path(self, q, k, v, wp_h, embed_qk, key_masks, points):
        """Kernel K5: folded-query streaming softmax.  Projection biases and
        the degree-0 SH term are per-query constants, softmax no-ops, so only
        the ``q @ W^T`` folds are passed."""
        cdtype = embed_qk.dtype
        b = q.shape[0]
        n, dh = q.shape[-2:]
        ah = math.prod(q.shape[1:-2])  # A*H (or H)
        qf, kf, vf = (t.reshape(b, ah, n, dh).to(cdtype) for t in (q, k, v))
        qp = torch.einsum("...hnc,dhc->...hnd", q, wp_h).reshape(b, ah, n, self.d_model)
        qp = qp.transpose(1, 2).to(cdtype)  # (B, N, AH, C)
        qw = pts = None
        if self.with_eq_term:
            we_h = prec.cast_feature(self.proj_eq_kernel).reshape(
                self.d_equiv_embed, self.num_heads, dh)
            qe = torch.einsum("bahnc,dhc->bahnd", q, we_h)  # (B, A, H, N, 4)
            qw = rpe_flash.fold_equivariant_query(qe, self.wigner_d1)
            pts = rpe_flash.point_rows(points)
        km = key_masks if key_masks is not None else torch.ones(
            (b, n), dtype=torch.bool, device=q.device)
        hidden = rpe_flash.rpe_self_attention(qf, kf, vf, qp, embed_qk, km, qw, pts,
                                              scale=1.0 / math.sqrt(dh)).to(v.dtype)
        return _merge_heads(hidden.reshape(q.shape)), {}

    def forward(self, input_q, input_k, input_v, embed_qk, key_masks=None, embed_eq=None,
                points=None, use_flash=False):
        h = self.num_heads
        dh = self.d_model // h
        q = _split_heads(self.TorchLinear_0(input_q), h)  # (B, [A,] H, N, c)
        k = _split_heads(self.TorchLinear_1(input_k), h)
        v = _split_heads(self.TorchLinear_2(input_v), h)
        cast = prec.cast_feature
        wp_h = cast(self.proj_p_kernel).reshape(self.d_model, h, dh)
        n, m = q.shape[-2], k.shape[-2]
        flash_ok = (
            use_flash and n == m and n % 128 == 0 and embed_qk.shape[-3] == n
            and (not self.with_eq_term
                 or (points is not None and self.d_equiv_embed == 4 and self.kanchor > 1))
        )
        if flash_ok:
            return self._flash_path(q, k, v, wp_h, embed_qk, key_masks, points)
        bp_h = self.proj_p_bias.reshape(h, dh)
        a = "a" if self.equivariant else ""
        # positional scores with the projection folded into q:
        #   s_p = (q @ Wp^T) . emb + q . bp
        qp = torch.einsum(f"b{a}hnc,dhc->b{a}hnd", q, wp_h)
        s_p = torch.einsum(f"b{a}hnd,bnmd->b{a}hnm", qp, cast(embed_qk).to(qp.dtype))
        s_p = s_p.float() + torch.einsum(f"b{a}hnc,hc->b{a}hn", q.float(), bp_h)[..., None]
        scores = torch.einsum(f"b{a}hnc,b{a}hmc->b{a}hnm", q, k).float() + s_p
        if self.with_eq_term:
            if embed_eq is None:
                raise ValueError("equivariant embedding required")
            we_h = cast(self.proj_eq_kernel).reshape(self.d_equiv_embed, h, dh)
            qe = torch.einsum("bahnc,dhc->bahnd", q, we_h)
            s_eq = torch.einsum("bahnd,banmd->bahnm", qe, cast(embed_eq).to(qe.dtype))
            be_h = self.proj_eq_bias.reshape(h, dh)
            scores = scores + s_eq.float() + torch.einsum(
                "bahnc,hc->bahn", q.float(), be_h)[..., None]
        scores = _masked_softmax(scores / math.sqrt(dh), key_masks).to(v.dtype)
        hidden = torch.einsum("...nm,...mc->...nc", scores, v)
        return _merge_heads(hidden), {}


class MultiHeadAttentionEQ(nn.Module):
    """Equivariant cross attention over anchor pairs, global modes
    ``a_soft`` (weight key anchors per query anchor) and ``r_soft`` (fold
    anchor pairs into rotations by the vertex-trace table and weight
    rotations), with mean pooling over all query anchors and heads."""

    def __init__(self, d_model, num_heads, attn_mode, kanchor=4,
                 attn_r_positive: Optional[str] = "sq"):
        super().__init__()
        if attn_mode not in ("a_soft", "r_soft"):
            raise NotImplementedError(f"attention mode {attn_mode!r}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.attn_mode = attn_mode
        self.kanchor = kanchor
        self.attn_r_positive = attn_r_positive
        quotient = {3: 1, 4: 3, 6: 4, 12: 5}[kanchor]
        trace_ori = anchor_lib.get_anchor_space(kanchor, quotient).trace_idx_ori
        self.register_buffer("trace_ori", torch.as_tensor(trace_ori, dtype=torch.long),
                             persistent=False)
        self.TorchLinear_0 = TorchLinear(d_model, d_model)
        self.TorchLinear_1 = TorchLinear(d_model, d_model)
        self.TorchLinear_2 = TorchLinear(d_model, d_model)

    def _flash_path(self, q, k, v, key_masks, q_masks):
        """Kernels K6 (stats) -> tiny (A, E) weight math -> K7 (apply), for a
        batch of one; the (A, E, H, N, M) scores are never materialised."""
        a = self.kanchor
        qs, ks, vs = q[0], k[0], v[0]  # (A, H, N/M, c)
        qm = q_masks[0] if q_masks is not None else torch.ones(
            qs.shape[-2], dtype=torch.bool, device=q.device)
        km = key_masks[0] if key_masks is not None else torch.ones(
            ks.shape[-2], dtype=torch.bool, device=q.device)
        rowmax, rowsum, attn_ae = eq_flash.eq_attention_stats(
            qs, ks, qm, km, positive=self.attn_r_positive)
        if self.attn_mode == "a_soft":
            w_ae = attn_ae / (attn_ae.sum(dim=1, keepdim=True) + 1e-9)
            aux = {"attn_w": w_ae[None]}
        else:  # r_soft: fold anchor pairs into rotations by the trace table
            nr = self.trace_ori.shape[0]
            a_ids = torch.arange(a, device=q.device).expand(nr, a)
            attn_r = attn_ae[a_ids, self.trace_ori].mean(dim=1)  # (R,)
            attn_r = attn_r / (attn_r.sum() + 1e-9)
            onehot = F.one_hot(self.trace_ori, a).to(attn_r.dtype)  # (R, A, E)
            w_ae = torch.einsum("r,rae->ae", attn_r, onehot)
            aux = {"attn_w": attn_r[None]}
        hidden = eq_flash.eq_attention_apply(qs, ks, vs, w_ae, rowmax, rowsum, km)
        return _merge_heads(hidden.to(v.dtype)[None]), aux

    def forward(self, input_q, input_k, input_v, key_masks=None, q_masks=None,
                use_flash=False):
        """inputs (B, A, N/M, C); key_masks (B, M) / q_masks (B, N) True = valid.
        ``use_flash`` (serving, batch of one) takes kernels K6 + K7."""
        h = self.num_heads
        a = self.kanchor
        q = _split_heads(self.TorchLinear_0(input_q), h)  # (B, A, H, N, c)
        k = _split_heads(self.TorchLinear_1(input_k), h)
        v = _split_heads(self.TorchLinear_2(input_v), h)
        if use_flash and q.shape[0] == 1:
            return self._flash_path(q, k, v, key_masks, q_masks)
        s_ae = torch.einsum("bahnc,behmc->baehnm", q, k).float() / math.sqrt(
            self.d_model // h)  # (B, A, E, H, N, M)

        # global attention: head-mean -> positive -> masked point-mean pooling
        g = _positive(s_ae.mean(dim=3, keepdim=True), self.attn_r_positive)
        if key_masks is not None or q_masks is not None:
            b, n, m = s_ae.shape[0], s_ae.shape[-2], s_ae.shape[-1]
            qm = q_masks if q_masks is not None else torch.ones(b, n, dtype=torch.bool,
                                                                 device=s_ae.device)
            km = key_masks if key_masks is not None else torch.ones(
                b, m, dtype=torch.bool, device=s_ae.device)
            pm = (qm[:, :, None] & km[:, None, :])[:, None, None, None].float()
            attn_ae_h = (g * pm).sum(dim=(-2, -1)) / (pm.sum(dim=(-2, -1)) + 1e-9)
        else:
            attn_ae_h = g.mean(dim=(-2, -1))  # (B, A, E, 1)
        scores = _masked_softmax(s_ae, key_masks)

        if self.attn_mode == "a_soft":
            attn_ae = attn_ae_h.mean(dim=-1)  # (B, A, E)
            w = attn_ae / (attn_ae.sum(dim=2, keepdim=True) + 1e-9)
            scores = scores * w[:, :, :, None, None, None]
            aux = {"attn_w": w}
        else:  # r_soft
            nr = self.trace_ori.shape[0]
            a_ids = torch.arange(a, device=s_ae.device).expand(nr, a)
            attn_r_h = attn_ae_h[:, a_ids, self.trace_ori].mean(dim=2)  # (B, R, 1)
            attn_r_h = attn_r_h / (attn_r_h.sum(dim=1, keepdim=True) + 1e-9)
            # sum_r attn_r[r] softmax(s[a, tr(r, a)]) @ v[tr(r, a)] collapses to
            # the anchor-pair form with W[a, e] = sum_r attn_r[r] 1[tr(r, a) == e]
            onehot = F.one_hot(self.trace_ori, a).to(attn_r_h.dtype)  # (R, A, E)
            w_ae = torch.einsum("brh,rae->baeh", attn_r_h, onehot)
            scores = scores * w_ae[:, :, :, :, None, None]
            aux = {"attn_w": attn_r_h.mean(dim=-1)}  # (B, R)
        hidden = torch.einsum("baehnm,behmc->bahnc", scores.to(v.dtype), v)
        return _merge_heads(hidden), aux


class AttentionOutput(nn.Module):
    """FFN block: expand -> act -> squeeze -> LN residual."""

    def __init__(self, d_model, activation_fn="ReLU"):
        super().__init__()
        self.act = build_activation(activation_fn)
        self.TorchLinear_0 = TorchLinear(d_model, d_model * 2)
        self.TorchLinear_1 = TorchLinear(d_model * 2, d_model)
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, x):
        h = self.TorchLinear_1(self.act(self.TorchLinear_0(x)))
        return self.LayerNorm_0(x + h)


class RotCompressOutput(nn.Module):
    """Anchor-axis compression: concat A*C -> MLP -> + anchor-max residual;
    x (B, A, N, C) -> (B, N, C)."""

    def __init__(self, d_model, na, activation_fn="ReLU"):
        super().__init__()
        self.act = build_activation(activation_fn)
        self.TorchLinear_0 = TorchLinear(na * d_model, d_model * 2)
        self.TorchLinear_1 = TorchLinear(d_model * 2, d_model)
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, x):
        x_max = x.amax(dim=1)
        b, a, n, c = x.shape
        flat = x.movedim(1, 2).reshape(b, n, a * c)
        h = self.TorchLinear_1(self.act(self.TorchLinear_0(flat)))
        return self.LayerNorm_0(x_max + h)


class AttentionLayer(nn.Module):
    """Attention + linear + LN residual."""

    def __init__(self, d_model, num_heads, equivariant=False, attn_mode=None,
                 kanchor=4, attn_r_positive="sq"):
        super().__init__()
        self.equivariant = equivariant
        if equivariant:
            self.MultiHeadAttentionEQ_0 = MultiHeadAttentionEQ(
                d_model, num_heads, attn_mode, kanchor=kanchor,
                attn_r_positive=attn_r_positive)
        else:
            self.MultiHeadAttention_0 = MultiHeadAttention(d_model, num_heads)
        self.TorchLinear_0 = TorchLinear(d_model, d_model)
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, input_states, memory_states, value_states=None,
                memory_masks=None, q_masks=None, use_flash=False):
        if value_states is None:
            value_states = memory_states
        if self.equivariant:
            hidden, aux = self.MultiHeadAttentionEQ_0(
                input_states, memory_states, value_states, key_masks=memory_masks,
                q_masks=q_masks, use_flash=use_flash)
        else:
            hidden, aux = self.MultiHeadAttention_0(
                input_states, memory_states, value_states, key_masks=memory_masks)
        hidden = self.TorchLinear_0(hidden)
        if hidden.ndim == input_states.ndim + 1:
            # equivariant output from invariant input: broadcast residual over A
            input_states = input_states[:, None]
        return self.LayerNorm_0(hidden + input_states), aux


class TransformerLayer(nn.Module):
    """AttentionLayer + AttentionOutput."""

    def __init__(self, d_model, num_heads, activation_fn="ReLU", equivariant=False,
                 attn_mode=None, kanchor=4, attn_r_positive="sq"):
        super().__init__()
        self.AttentionLayer_0 = AttentionLayer(
            d_model, num_heads, equivariant=equivariant, attn_mode=attn_mode,
            kanchor=kanchor, attn_r_positive=attn_r_positive)
        self.AttentionOutput_0 = AttentionOutput(d_model, activation_fn)

    def forward(self, input_states, memory_states, value_states=None,
                memory_masks=None, q_masks=None, use_flash=False):
        hidden, aux = self.AttentionLayer_0(input_states, memory_states, value_states,
                                            memory_masks, q_masks, use_flash=use_flash)
        return self.AttentionOutput_0(hidden), aux


class RPEAttentionLayer(nn.Module):
    """RPE attention + linear + LN residual."""

    def __init__(self, d_model, num_heads, equivariant=False, d_equiv_embed=0, kanchor=0):
        super().__init__()
        self.RPEMultiHeadAttention_0 = RPEMultiHeadAttention(
            d_model, num_heads, equivariant=equivariant, d_equiv_embed=d_equiv_embed,
            kanchor=kanchor)
        self.TorchLinear_0 = TorchLinear(d_model, d_model)
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, input_states, memory_states, position_states, memory_masks=None,
                equiv_states=None, points=None, use_flash=False):
        hidden, aux = self.RPEMultiHeadAttention_0(
            input_states, memory_states, memory_states, position_states,
            key_masks=memory_masks, embed_eq=equiv_states, points=points,
            use_flash=use_flash)
        hidden = self.TorchLinear_0(hidden)
        return self.LayerNorm_0(hidden + input_states), aux


class RPETransformerLayer(nn.Module):
    """RPE attention layer + FFN."""

    def __init__(self, d_model, num_heads, activation_fn="ReLU", equivariant=False,
                 d_equiv_embed=0, kanchor=0):
        super().__init__()
        self.RPEAttentionLayer_0 = RPEAttentionLayer(
            d_model, num_heads, equivariant=equivariant, d_equiv_embed=d_equiv_embed,
            kanchor=kanchor)
        self.AttentionOutput_0 = AttentionOutput(d_model, activation_fn)

    def forward(self, input_states, memory_states, position_states, memory_masks=None,
                equiv_states=None, points=None, use_flash=False):
        hidden, aux = self.RPEAttentionLayer_0(
            input_states, memory_states, position_states, memory_masks, equiv_states,
            points=points, use_flash=use_flash)
        return self.AttentionOutput_0(hidden), aux
