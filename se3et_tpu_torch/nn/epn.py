r"""E2PN anchor-equivariant KPConv backbone (port of :mod:`se3et_tpu.nn.epn`).

The rotate-by-permute machinery of the E2PN convolution is folded at
construction into one static gather index ``wg_index[r, k, a]`` over the
tied weight blocks, rebuilt here from the numpy anchor and
kernel-point tables, so a conv is:

1. the neighbour gather x influence contraction
   ``wf[b, n, k, a, c] = sum_h infl[b, n, h, k] x[b, nbr(n, h), a, c]``
   (kernel K1, :func:`se3et_tpu_torch.ops.kernels.windowed_conv.gather_wf`);
2. one matmul against the expanded weight ``W[wg_index]``
   (``(K*A*Cin, A*Cout)``), or for ``Cin >= 256`` the factored
   class-reduction pair of matmuls.

The strided skip max-pool is kernel K2
(:func:`~se3et_tpu_torch.ops.kernels.windowed_conv.neighbor_max`).  Under
autograd (training) both differentiate through their backward kernels K8
and K9.

Serving with ``fused`` (the model's ``serve_fused_conv``, as in the JAX
package) takes the fused forms where they apply: an expanded-contraction
conv runs as K12 (gather + weight product in one kernel, no wf tensor),
a strided bottleneck hands its skip payload to its conv, which runs as K13
(K12 + the skip max) or, where K13 does not take the widths, as K14 (wf
and the skip max in one pass) + matmul; a skip that neither takes pools in
K2.  The gates are ``gather_wf_mm_fits``, ``gather_wf_max_mm_fits`` and
``gather_wf_max_fits`` of :mod:`se3et_tpu_torch.ops.kernels.windowed_conv`;
at full ``se3ete.3dmatch`` width they send the same convs to each form as
the JAX package's VMEM gates do (``scripts/fused_conv_split.py``): stage
0-1 same-level convs K12, the s0 -> s1 strided block K13, the s1 -> s2
strided block K14, the s2 -> s3 strided block K1 + matmul + K2, stage 2-3
same-level convs K1 + matmul.
Influence weights are shared by every conv of a (stage, neighbour set):
the pyramid's host-precomputed ones (:mod:`se3et_tpu_torch.data.influence`)
where it carries them, else computed on the card by kernel K15
(:func:`~se3et_tpu_torch.ops.kernels.windowed_conv.influence`), as the JAX
package's ``make_influence`` does.

Feature tensors carry a leading cloud axis: ``x (B, N, A, C)``;
neighbour indices ``(B, N, H)`` with per-cloud sentinel ``N_support``.
Submodules are named as in the flax tree (see :mod:`se3et_tpu_torch.convert`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from se3et_tpu_torch.core import anchors as anchor_lib
from se3et_tpu_torch.core import kernel_points as kp_lib
from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.nn.layers import (
    MaskedGroupNorm, TorchLinear, UnaryBlock, leaky_relu, uniform_,
)
from se3et_tpu_torch.ops.geometry import batched_gather_rows
from se3et_tpu_torch.ops.kernels.windowed_conv import (
    gather_wf, gather_wf_max, gather_wf_max_fits, gather_wf_max_mm, gather_wf_max_mm_fits,
    gather_wf_mm, gather_wf_mm_fits, influence, neighbor_max,
)


@dataclasses.dataclass(frozen=True)
class EPNConfig:
    """Equivariant-conv hyperparameters; field-for-field the JAX
    ``EPNConfig``.  The port implements the non-separable E2PN conv
    (``non_sep_conv``, kanchor > 1, equivariant kernel points) with
    'exact' or 'relaxed' steerability and plain anchor max-pooling."""

    kanchor: int = 6
    quotient_factor: int = 4
    num_kernel_points: int = 15
    non_sep_conv: bool = True
    rot_by_permute: bool = True
    fixed_kernel_points: str = "center"
    ignore_steer_constraint: bool = False
    steerability: str = "exact"
    epn_kernel: bool = False
    att_pooling: bool = False
    att_permute: bool = False
    dual_feature: bool = False
    kp_influence: str = "linear"
    aggregation_mode: str = "sum"
    wf_kfirst: bool = False
    wf_kfirst_min_ac: int = 384

    @property
    def space(self) -> anchor_lib.AnchorSpace:
        return anchor_lib.get_anchor_space(self.kanchor, self.quotient_factor)


def check_supported(cfg: EPNConfig) -> None:
    """Raise for E2PN options outside the port's slice."""
    if cfg.kanchor == 1 or not cfg.non_sep_conv or cfg.fixed_kernel_points == "verticals":
        raise NotImplementedError(
            "the port implements the non-separable E2PN conv with kanchor > 1"
        )
    if cfg.att_pooling or cfg.att_permute or cfg.dual_feature:
        raise NotImplementedError("the port pools anchors by plain max only")


class KPConvInterSO3(nn.Module):
    """E2PN inter-point equivariant convolution (non-separable, permute path)."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 config: EPNConfig):
        super().__init__()
        check_supported(config)
        space = config.space
        a = config.kanchor
        kp = kp_lib.equivariant_kernel_points(
            radius, config.num_kernel_points, a, config.quotient_factor
        )
        kidx_rot, fold, num_real = kp_lib.kernel_permutation_tables(
            kp, space, config.ignore_steer_constraint, radius=radius
        )
        if config.steerability == "exact":
            class_idx, num_blocks = kp_lib.joint_steerability_classes(kp, space)
            # wg_index[r, k, a] = class(kidx_rot[r, k], ridx_rot[a, r])
            idx = class_idx[kidx_rot[:, :, None], space.ridx_rot.T[:, None, :]]
        else:
            idx = fold[kidx_rot][:, :, None] * a + space.ridx_rot.T[:, None, :]
            num_blocks = num_real * a
        idx = idx.astype(np.int64)  # (R=A, K, A)
        r_dim, kk, aa = idx.shape
        # (K*A, R*O) 0/1 class-reduction matrix of the factored contraction:
        # column r*O + o selects the (k, a) pairs whose weight block is o
        reduce_mats = np.zeros((kk * aa, r_dim * num_blocks), np.float32)
        for r in range(r_dim):
            reduce_mats[np.arange(kk * aa), r * num_blocks + idx[r].reshape(-1)] = 1.0
        self.register_buffer("wg_index", torch.as_tensor(idx), persistent=False)
        self.register_buffer("reduce_mats", torch.as_tensor(reduce_mats),
                             persistent=False)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kanchor = a
        self.num_kernel_points = config.num_kernel_points
        self.num_weight_blocks = num_blocks
        self.weights = nn.Parameter(torch.empty(num_blocks, in_channels, out_channels))

    def reset_parameters_with(self, generator):
        # the reference's kaiming bound on (K_real, A, Cin, Cout)
        bound = 1.0 / math.sqrt(self.kanchor * self.in_channels * self.out_channels)
        uniform_(self.weights, bound, generator)

    def _expanded_rhs(self, a_dim, cin):
        """(K*A*Cin, A*Cout) effective weight in the flat (k, a, c) order of
        wf, as the transposed view of a contiguous (A*Cout, K*A*Cin) tensor
        (the layout K12/K13 read)."""
        wg = prec.cast_feature(self.weights)[self.wg_index]  # (R, K, A, Cin, Cout)
        return wg.permute(0, 4, 1, 2, 3).reshape(
            self.kanchor * self.out_channels, self.num_kernel_points * a_dim * cin
        ).t()

    def forward(self, x, neighbor_indices, influence, ones_input=False, fused=False,
                skip=None):
        """x: (B, Ns, A, Cin); influence (B, Nq, H, K) -> (B, Nq, A, Cout) f32.

        ``fused`` (serving): take K12 / K13 where the gates admit the widths.
        ``skip`` (B, Ns, AC2): the strided bottleneck's skip payload, pooled
        over the same neighbours (K13, or K14 with the weight product after
        it); the call then returns ``(out, pooled (B, Nq, AC2))``, with
        ``pooled`` None where neither kernel takes the widths."""
        b, num_s, a_dim, cin = x.shape
        nq = neighbor_indices.shape[1]
        k, a = self.num_kernel_points, self.kanchor
        w = prec.cast_feature(influence)
        pooled = None
        if ones_input:
            # x == 1 and invalid-neighbour weights are zero:
            # wf[b, n, k, a, c] = sum_h w[b, n, h, k]
            inf_sum = w.float().sum(dim=2).to(w.dtype)
            wf_flat = inf_sum[:, :, :, None].expand(b, nq, k, a_dim * cin).reshape(
                b, nq, k * a_dim * cin)
        else:
            flat = prec.cast_feature(x).reshape(b, num_s, a_dim * cin)
            ac, ac_out = a_dim * cin, a * self.out_channels
            fused_mm = fused and cin < 256  # K12/K13 fuse the expanded contraction
            if fused_mm and skip is None and gather_wf_mm_fits(ac, ac_out, k):
                out = gather_wf_mm(flat, neighbor_indices, w, self._expanded_rhs(a_dim, cin))
                return out.reshape(b, nq, a, self.out_channels)
            if fused_mm and skip is not None and gather_wf_max_mm_fits(ac, ac_out,
                                                                       skip.shape[2], k):
                out, pooled = gather_wf_max_mm(flat, neighbor_indices, w, skip,
                                               self._expanded_rhs(a_dim, cin))
                return out.reshape(b, nq, a, self.out_channels), pooled
            if skip is not None and gather_wf_max_fits(skip.shape[2], k):
                wf_flat, pooled = gather_wf_max(flat, neighbor_indices, w, skip)
            else:
                wf_flat = gather_wf(flat, neighbor_indices, w)
        if cin < 256:
            out = (wf_flat @ self._expanded_rhs(a_dim, cin)).float()
            out = out.reshape(b, nq, a, self.out_channels)
        else:
            # factored: out[n, r, d] = sum_{o, c} (sum_{ka: idx[r, ka] = o} wf[n, ka, c]) W[o, c, d]
            num_o = self.num_weight_blocks
            wf_kac = wf_flat.reshape(b, nq, k * a, cin)
            red = torch.einsum("bnxc,xm->bnmc", wf_kac,
                               prec.cast_feature(self.reduce_mats)).reshape(
                b, nq, a, num_o, cin)
            out = torch.einsum("bnroc,ocd->bnrd", red, prec.cast_feature(self.weights)).float()
        return out if skip is None else (out, pooled)


class InvOutBlockEPN(nn.Module):
    """Equivariant -> invariant pooling: max over the anchor axis,
    (B, N, A, C) -> (B, N, C)."""

    def forward(self, x):
        return x.amax(dim=2)


def nearest_upsample(x, upsample_indices):
    """Each fine query copies its nearest coarse neighbour (first column);
    x: (B, Nc, C); upsample_indices (B, Nf, K) -> (B, Nf, C)."""
    return batched_gather_rows(x, upsample_indices[:, :, :1])[:, :, 0]


def lift_features(x: torch.Tensor, kanchor: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, A, C) by broadcast."""
    return x[:, :, None, :].expand(x.shape[0], x.shape[1], kanchor, x.shape[2])


class KPConvInterSO3Block(nn.Module):
    """Conv -> GroupNorm -> LeakyReLU."""

    def __init__(self, in_dim, out_dim, radius, group_norm, config):
        super().__init__()
        self.KPConvInterSO3_0 = KPConvInterSO3(in_dim, out_dim, radius, config)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(group_norm, out_dim)

    def forward(self, x, neighbor_indices, q_mask, influence, ones_input=False, fused=False,
                skip=None):
        x = self.KPConvInterSO3_0(x, neighbor_indices, influence, ones_input=ones_input,
                                  fused=fused, skip=skip)
        if skip is None:
            return leaky_relu(self.MaskedGroupNorm_0(x, q_mask))
        x, pooled = x
        return leaky_relu(self.MaskedGroupNorm_0(x, q_mask)), pooled


class SimpleBlockEPN(nn.Module):
    """First encoder block."""

    def __init__(self, in_dim, out_dim, radius, group_norm, config):
        super().__init__()
        self.KPConvInterSO3Block_0 = KPConvInterSO3Block(
            in_dim, out_dim, radius, group_norm, config)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(group_norm, out_dim)

    def forward(self, x, neighbor_indices, q_mask, influence, ones_input=False, fused=False):
        x = self.KPConvInterSO3Block_0(x, neighbor_indices, q_mask, influence,
                                       ones_input=ones_input, fused=fused)
        return leaky_relu(self.MaskedGroupNorm_0(x, q_mask))


class ResnetBottleneckBlockEPN(nn.Module):
    """Bottleneck residual block, optionally strided (max-pooled skip)."""

    def __init__(self, in_dim, out_dim, radius, group_norm, config, strided=False):
        super().__init__()
        mid = out_dim // 4
        self.strided = strided
        # flax numbers the UnaryBlocks in creation order: [in,] out [, skip]
        unary = (f"UnaryBlock_{i}" for i in range(3))
        self.unary_in = next(unary) if in_dim != mid else None
        if self.unary_in:
            self.add_module(self.unary_in, UnaryBlock(in_dim, mid, group_norm))
        self.KPConvInterSO3Block_0 = KPConvInterSO3Block(mid, mid, radius, group_norm, config)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(group_norm, mid)
        self.unary_out = next(unary)
        self.add_module(self.unary_out, UnaryBlock(mid, out_dim, group_norm, no_relu=True))
        self.unary_skip = next(unary) if in_dim != out_dim else None
        if self.unary_skip:
            self.add_module(self.unary_skip,
                            UnaryBlock(in_dim, out_dim, group_norm, no_relu=True))

    def forward(self, x, neighbor_indices, q_mask, influence, s_mask=None, fused=False):
        """``fused`` (serving): the convs take the fused kernels, and a
        strided block's skip max rides its conv over the same neighbours
        where a kernel takes it, else K2 (the payload cast to the compute
        dtype either way, as in the JAX fused route); otherwise the skip is
        K2's max of the float32 features."""
        if s_mask is None and not self.strided:
            s_mask = q_mask
        skip = x
        b, ns, a_dim, ch = skip.shape
        nq = neighbor_indices.shape[1]
        h = getattr(self, self.unary_in)(x, s_mask) if self.unary_in else x
        if self.strided and fused:
            payload = prec.cast_feature(skip).reshape(b, ns, a_dim * ch)
            h, pooled = self.KPConvInterSO3Block_0(h, neighbor_indices, q_mask, influence,
                                                   fused=True, skip=payload)
            if pooled is None:
                pooled = neighbor_max(payload, neighbor_indices)
            skip = pooled.reshape(b, nq, a_dim, ch).float()
        else:
            h = self.KPConvInterSO3Block_0(h, neighbor_indices, q_mask, influence, fused=fused)
        h = leaky_relu(self.MaskedGroupNorm_0(h, q_mask))
        h = getattr(self, self.unary_out)(h, q_mask)
        if self.strided and not fused:
            pooled = neighbor_max(skip.reshape(b, ns, a_dim * ch), neighbor_indices)
            skip = pooled.reshape(b, nq, a_dim, ch)
        if self.unary_skip:
            skip = getattr(self, self.unary_skip)(skip, q_mask)
        return leaky_relu(h + skip)


class _EPNStage0(nn.Module):
    """Stage-0 encoder pair (simple + bottleneck)."""

    def __init__(self, in_dim, out_dim, radius, group_norm, config, ones_input=False):
        super().__init__()
        self.ones_input = ones_input
        self.SimpleBlockEPN_0 = SimpleBlockEPN(in_dim, out_dim, radius, group_norm, config)
        self.ResnetBottleneckBlockEPN_0 = ResnetBottleneckBlockEPN(
            out_dim, out_dim * 2, radius, group_norm, config)

    def forward(self, x, nbs, msk, influence, fused=False):
        x = self.SimpleBlockEPN_0(x, nbs, msk, influence, ones_input=self.ones_input,
                                  fused=fused)
        return self.ResnetBottleneckBlockEPN_0(x, nbs, msk, influence, fused=fused)


class _EPNStage(nn.Module):
    """One encoder stage: strided block + 2 same-level bottlenecks.  ``radius``
    is the strided (previous-level) value; the same-level blocks use 2x."""

    def __init__(self, in_dim, radius, group_norm, config):
        super().__init__()
        self.ResnetBottleneckBlockEPN_0 = ResnetBottleneckBlockEPN(
            in_dim, in_dim, radius, group_norm, config, strided=True)
        self.ResnetBottleneckBlockEPN_1 = ResnetBottleneckBlockEPN(
            in_dim, in_dim * 2, radius * 2, group_norm, config)
        self.ResnetBottleneckBlockEPN_2 = ResnetBottleneckBlockEPN(
            in_dim * 2, in_dim * 2, radius * 2, group_norm, config)

    def forward(self, x, sub_idx, nbr_idx, q_msk, s_msk, inf_sub, inf_same, fused=False):
        x = self.ResnetBottleneckBlockEPN_0(x, sub_idx, q_msk, inf_sub, s_mask=s_msk,
                                            fused=fused)
        x = self.ResnetBottleneckBlockEPN_1(x, nbr_idx, q_msk, inf_same, fused=fused)
        return self.ResnetBottleneckBlockEPN_2(x, nbr_idx, q_msk, inf_same, fused=fused)


class E2PNBackbone(nn.Module):
    """E2PN encoder + invariant FPN decoder.

    Returns ``(feats_f, feats_c_equiv)``: invariant fine features at stage 1
    (B, N1, output_dim) and equivariant coarse features (B, Nc, A, C).
    """

    def __init__(self, input_dim, output_dim, init_dim, init_radius, init_sigma, group_norm,
                 config: EPNConfig, kernel_points, num_stages=4, ones_input=False):
        """``init_sigma`` and ``kernel_points`` (radius -> (K, 3) numpy, the
        port's ``data.influence._kernel_points_for``) serve the influence of
        pyramids without host weights."""
        super().__init__()
        check_supported(config)
        self.kanchor = config.kanchor
        self.num_stages = num_stages
        self.init_radius, self.init_sigma = init_radius, init_sigma
        self.kp_influence = config.kp_influence
        self.num_kernel_points = config.num_kernel_points
        self._kernel_points = kernel_points
        self._kp_tensors = {}  # (radius, device) -> (K, 3) kernel points, copied there once
        self.inv_out = InvOutBlockEPN()
        d, r = init_dim, init_radius
        self._EPNStage0_0 = _EPNStage0(input_dim, d, r, group_norm, config,
                                       ones_input=ones_input and input_dim == 1)
        dims = [d * 2]
        for st in range(1, num_stages):
            self.add_module(f"_EPNStage_{st - 1}",
                            _EPNStage(dims[-1], r * 2 ** (st - 1), group_norm, config))
            dims.append(dims[-1] * 2)
        # decoder: upsampled latent ++ stage-st invariant features (dims[st])
        latent = dims[-1]
        n_unary = 0
        for st in range(num_stages - 2, 0, -1):
            cat = latent + dims[st]
            if st > 1:
                self.add_module(f"UnaryBlock_{n_unary}", UnaryBlock(cat, dims[st], group_norm))
                n_unary += 1
                latent = dims[st]
            else:
                self.TorchLinear_0 = TorchLinear(cat, output_dim)

    def make_influence(self, pyramid, key, radius, sigma, q, sup, idx):
        """Influence weights of one (stage, neighbour set): the pyramid's
        ``key`` where present and shaped for ``idx`` (JAX ``make_influence``'s
        checks), else kernel K15 on the card (its plain version on the CPU),
        cast to the compute dtype; its H-sum is not used."""
        pre = pyramid.get(key)
        if (pre is not None and pre.shape[:2] == idx.shape[:2] and pre.shape[2] >= idx.shape[2]
                and pre.shape[-1] == self.num_kernel_points):
            return pre
        kp = self._kp_tensors.get((radius, q.device))
        if kp is None:  # a copy from host memory per call would wait for the card
            kp = torch.as_tensor(self._kernel_points(radius), dtype=torch.float32,
                                 device=q.device)
            self._kp_tensors[(radius, q.device)] = kp
        infl, _ = influence(q, sup, idx, kp, sigma=float(sigma), mode=self.kp_influence,
                            out_dtype=prec.compute_dtype() or torch.float32)
        return infl

    def forward(self, feats, pyramid, fused=False):
        """``fused``: the serving route of the convs (``serve_fused_conv``
        outside training); no gradient flows through it."""
        s = self.num_stages
        pts = [pyramid[f"points_{i}"] for i in range(s)]
        msk = [pyramid[f"masks_{i}"] for i in range(s)]
        nbs = [pyramid[f"neighbors_{i}"] for i in range(s)]
        subs = [pyramid[f"subsampling_{i}"] for i in range(s - 1)]
        ups = [pyramid[f"upsampling_{i}"] for i in range(s - 1)]
        # the radius / sigma schedule of the JAX backbone: same-level sets at
        # 2^(st-1) * 2 * init (stage 0: init), strided sets at 2^(st-1) * init
        r, sg = self.init_radius, self.init_sigma
        inf_same = [self.make_influence(pyramid, "influence_same_0", r, sg, pts[0], pts[0],
                                        nbs[0])]
        inf_sub = [None]
        for st in range(1, s):
            mult = 2 ** (st - 1)
            inf_sub.append(self.make_influence(
                pyramid, f"influence_sub_{st}", r * mult, sg * mult, pts[st], pts[st - 1],
                subs[st - 1]))
            inf_same.append(self.make_influence(
                pyramid, f"influence_same_{st}", r * mult * 2, sg * mult * 2, pts[st],
                pts[st], nbs[st]))

        x = lift_features(feats, self.kanchor)
        x = self._EPNStage0_0(x, nbs[0], msk[0], inf_same[0], fused=fused)
        stage_feats = [x]
        for st in range(1, s):
            x = getattr(self, f"_EPNStage_{st - 1}")(
                x, subs[st - 1], nbs[st], msk[st], msk[st - 1], inf_sub[st], inf_same[st],
                fused=fused,
            )
            stage_feats.append(x)

        # invariant features per stage, FPN decoder down to stage 1
        inv_feats = [self.inv_out(stage_feats[i]) for i in range(1, s)]
        latent = inv_feats[-1]
        n_unary = 0
        for st in range(s - 2, 0, -1):
            latent = nearest_upsample(latent, ups[st])
            latent = torch.cat([latent, inv_feats[st - 1]], dim=-1)
            if st > 1:
                latent = getattr(self, f"UnaryBlock_{n_unary}")(latent, msk[st])
                n_unary += 1
            else:
                latent = self.TorchLinear_0(latent)
        return latent, stage_feats[-1]
