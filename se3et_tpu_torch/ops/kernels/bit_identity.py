"""This checkout's kernels against another checkout's, on one card: outputs
held bit for bit (or within a stated tolerance where a kernel changed on
purpose) and kernel times taken in turns.

    python -m se3et_tpu_torch.ops.kernels.bit_identity --other <another checkout>

Each checkout runs in processes of its own, with its own package, wrappers
and ``csrc`` (built with the same flags into its own
``se3et_tpu_torch/_build``), on the same seeded inputs: the other, this,
this, the other.  The first run of each saves its outputs; the four runs
time the kernels in ``TIMED`` with CUDA events.  Cases, at the serving
shapes of se3ete.3dmatch (bf16) and the tiny float32 widths:

* K3 (geometric embedding) at N = 1024, C = 256 in bf16, and N = 128,
  C = 64 in float32;
* K5 (flash RPE self-attention) on random inputs: AH = 24 with the SH term
  and AH = 4 without, at both widths (the bf16 ones, the serving shapes,
  timed); and at the wide-head family's three self-layer shapes (head
  width 32, C = 128, bf16: AH = 24 with and without the SH term, AH = 4
  without), timed and held within their ``TOLERANCES`` (its ws form there
  against a build where the first design takes them);
* K12 (fused conv) at the stage-0 (x (2, 20000, 192), H 24) and stage-1
  (x (2, 10000, 384), H 32) shapes and at se3ete2's stage-2 shape (x (2,
  3072, 384), H 36: its tc48 form, held within its ``TOLERANCES``), all
  timed, and K13 at the s0 -> s1 strided shape (skip (2, 20000, 768)), its
  conv output and its skip max as two cases (both timed; the conv held
  within its ``TOLERANCES``, the max bit for bit);
* K11 (the backward of K5) on K5's output and row log-sum-exp (computed
  once, before the timing) for a random float32 cotangent, at AH = 24
  with SH and AH = 4 without, at both widths (the bf16 ones, the training
  shapes, timed), and at the wide-head family's three self-layer shapes
  (head width 32, C = 128, bf16: AH = 24 with and without the SH term, AH
  = 4 without; timed and held within their ``TOLERANCES``), all six
  gradients;
* K10 (the backward of K3) for a random cotangent at N = 1024, C = 256 in
  bf16 (the training shape; timed, held within its ``TOLERANCES``) and N =
  128, C = 64 in float32 (bit for bit), the four gradients, on inputs of
  their own generator;
* K16 (fused-embedding attention) at AH = 24 with SH and AH = 4 without,
  at both widths (the bf16 ones, the serving shapes, timed), and at the
  wide-head family's two self-layer shapes (head width 32, C = 128, bf16:
  AH = 24 with the SH term, AH = 4 without; timed and held within their
  ``TOLERANCES``: its ws form there against a build where the first design
  takes them); where the wrapper takes folded tables
  (``rpe_attention.femb_tables``) they are folded in the timed call and
  passed, so a build that folds them in the wrapper is held bit for bit
  against one that takes them folded, and both builds' times include the
  fold;
* K1 (conv gather) in bf16 at the stage-2 (x (2, 2500, 768), H 36), s2 ->
  s3 (the same x, 1024 queries) and stage-3 (x (2, 1024, 1536), H 38)
  shapes, and in float32 (the rows form) at the seven training shapes
  (the forwards of K8's ten convs: stage 0 same-level x (2, 20000, 192), H
  24, through stage 3 x (2, 1024, 1536), H 38), all timed;
* K6 (EQ cross-attention stats) and K7 (apply) at the serving shape, q, k,
  v (6, 4, 1024, 64) in bf16 (timed), and at N = M = 128, head width 16 in
  float32; both also at se3ete2's serving shape, head width 32 in bf16
  (timed; K6 held within its ``TOLERANCES``), on inputs of their own
  generator (K7's row statistics from the plain K6, so K7 is held by
  itself at both widths);
* K4 (Sinkhorn, 100 iterations, float32) on ``selfcheck.sinkhorn_inputs``
  at the serving shape (256, 65, 65) (timed) and at (6, 17, 13), compared
  on valid entries only: the masked ones are zeroed (they hold -1e12 + u +
  v, whose scale would hide any difference), which the timing includes;
* K2 (neighbour max) in bf16 at the fused serving route's s2 -> s3 skip (x
  (2, 2500, 3072), H 36) and in float32 at the training s0 -> s1 skip (x
  (2, 20000, 768), H 24), both timed and held by their bit patterns;
* K8 (the backward of K1, float32) at the stage-0 same-level (dwf (2,
  20000, 15 * 192), H 24), s0 -> s1 strided (10000 queries over 20000
  sources) and stage-1 same-level (dwf (2, 10000, 15 * 384), H 32)
  training shapes on local neighbours, timed (its index built by the first
  call, before the timing) and held bit for bit;
* K9 (the backward of K2, float32) at the three strided skips of training
  (dout (2, 10000, 768) over x (2, 20000, 768), H 24; (2, 2500, 1536) over
  (2, 10000, 1536), H 32; (2, 1024, 3072) over (2, 2500, 3072), H 36) on
  local neighbours with integer-valued x (many ties) and its forward max,
  timed (its index built by the first call) and held bit for bit;
* K14 (fused conv gather + skip max) at the s1 -> s2 strided shape (x (2,
  10000, 384), H 32, K 15, skip (2, 10000, 1536), bf16), its wf and its
  pooled as two cases, both timed: wf held within its ``TOLERANCES``,
  pooled by its bit pattern;
* K15 (device influence weights) at the stage-0 same-level set (points
  (2, 20000, 3) in a cube of 0.15, local neighbours (2, 20000, 24), the
  15 kernel points of radius 0.0625, sigma 0.05, linear, bf16), the
  weights and their H-sums, timed and held by their bit patterns.


Each case is held bit for bit unless ``TOLERANCES`` names it: then the
largest difference over the other checkout's largest magnitude must stay
within the stated bound.  Prints one line per case, the times per turn,
the card's name and power limit, and exits non-zero if any case fails.

With ``--train-steps N`` each turn also times N full-width training steps
(``make_train_step`` on se3ete.3dmatch's serving cut, one synthetic pair
at point_limit 20000 with the host's influence, seeded weights, one
warm-up step first; each step on fresh device tensors of the pair, so its
neighbour indexes are built anew, as on a new pair) and prints the median
step ms per turn: the step of each checkout, with its own kernels and
training code, in turns.  One more step a turn is profiled
(``torch.profiler``, device time by kernel): it prints the kernels' total
per turn and the kernels whose device ms moved most between the two
checkouts (medians over their turns).  Each turn also takes N steps after
a warm-up on a fresh model with ``torch.use_deterministic_algorithms`` on
(warn only: the operations still without a deterministic implementation
are printed) and keeps the last one's losses, gradients and parameters:
this checkout's are held bit for bit against the other's (a case like the
others), and each checkout's two turns are compared too (run to run).

With ``--serve-pairs N`` each turn also serves ``--serve-experiment``
(se3ete2.3dmatch by default) captured, as ``chip_smoke.py`` phase 9 serves
se3ete2 (with ``--serve-femb``, on the ``serve_femb`` route: K16 in place
of K3 + K5): the experiment's serving config at full width, its first two
synthetic pairs of ``point_limit`` points with the host's influence and
seeded weights, ``capture_forward`` on pair 0, each pair's replay held to
the eager forward bit for bit (the turn fails otherwise); then N pairs
served captured (copy-in, replay, outputs cloned, synchronised) by the
host clock after one untimed pair.  It prints each turn's host load, its
launches a pair (the wrappers' counters over the capture) and ms/pair, and
the median ms/pair of each checkout.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

K5_BF16 = ("K5 AH=24 SH N=1024 C=256 bf16", "K5 AH=4 no SH N=1024 C=256 bf16")
K16_BF16 = ("K16 AH=24 SH N=1024 C=256 bf16", "K16 AH=4 no SH N=1024 C=256 bf16")
K11_BF16 = ("K11 AH=24 SH N=1024 C=256 bf16", "K11 AH=4 no SH N=1024 C=256 bf16")
K10_CASES = ("K10 N=1024 C=256 bf16", "K10 N=128 C=64 float32")
K6_BF16 = "K6 N=M=1024 c=64 bf16"
K7_BF16 = "K7 N=M=1024 c=64 bf16"
K7_BF16_32 = "K7 N=M=1024 c=32 bf16"
K6_BF16_32 = "K6 N=M=1024 c=32 bf16"
# K5 at head width 32: (name, AH, SH term)
K5_BF16_32 = (("K5 AH=24 SH N=1024 C=128 c=32 bf16", 24, True),
              ("K5 AH=4 no SH N=1024 C=128 c=32 bf16", 4, False),
              ("K5 AH=24 no SH N=1024 C=128 c=32 bf16", 24, False))
# K16 at head width 32: (name, AH, SH term)
K16_BF16_32 = (("K16 AH=24 SH N=1024 C=128 c=32 bf16", 24, True),
               ("K16 AH=4 no SH N=1024 C=128 c=32 bf16", 4, False))
# K11 at head width 32: (name, AH, SH term)
K11_BF16_32 = (("K11 AH=24 SH N=1024 C=128 c=32 bf16", 24, True),
               ("K11 AH=4 no SH N=1024 C=128 c=32 bf16", 4, False),
               ("K11 AH=24 no SH N=1024 C=128 c=32 bf16", 24, False))
K4_CASES = ("K4 (256, 65, 65) f32", "K4 (6, 17, 13) f32")
K13_CASES = ("K13 s0 -> s1 out", "K13 s0 -> s1 pooled")
K12_CASES = ("K12 stage 0", "K12 stage 1", "K12 se3ete2 stage 2")
K2_CASES = ("K2 s2 -> s3 bf16", "K2 s0 -> s1 float32")
K14_CASES = ("K14 s1 -> s2 wf", "K14 s1 -> s2 pooled")
K15_CASE = "K15 stage 0 bf16"
K1_BF16 = ("K1 stage 2", "K1 s2 -> s3", "K1 stage 3")
# K1 in float32 at the training shapes: (name, Nq, Ns, H, AC)
K1_F32 = (("K1 float32 stage 0", 20000, 20000, 24, 192),
          ("K1 float32 s0 -> s1", 10000, 20000, 24, 192),
          ("K1 float32 stage 1", 10000, 10000, 32, 384),
          ("K1 float32 s1 -> s2", 2500, 10000, 32, 384),
          ("K1 float32 stage 2", 2500, 2500, 36, 768),
          ("K1 float32 s2 -> s3", 1024, 2500, 36, 768),
          ("K1 float32 stage 3", 1024, 1024, 38, 1536))
K8_CASES = ("K8 stage 0 float32", "K8 s0 -> s1 float32", "K8 stage 1 float32")
# K9 at the strided skips of training: (name, Nq, Ns, H, AC)
K9_CASES = (("K9 s0 -> s1 float32", 10000, 20000, 24, 768),
            ("K9 s1 -> s2 float32", 2500, 10000, 32, 1536),
            ("K9 s2 -> s3 float32", 1024, 2500, 36, 3072))
TIMED = K5_BF16 + tuple(c[0] for c in K5_BF16_32) + K16_BF16 \
    + tuple(c[0] for c in K16_BF16_32) \
    + (K6_BF16, K7_BF16, K6_BF16_32, K7_BF16_32, K4_CASES[0]) + K12_CASES + K13_CASES \
    + K2_CASES + K14_CASES \
    + K1_BF16 + tuple(c[0] for c in K1_F32) + K11_BF16 + tuple(c[0] for c in K11_BF16_32) \
    + K10_CASES[:1] + K8_CASES \
    + tuple(c[0] for c in K9_CASES) + (K15_CASE,)
# the last timed training step's outputs (with --train-steps)
TRAIN_OUTPUTS = ("training step: losses", "training step: gradients",
                 "training step: parameters")
# held by their bit patterns (-0.0 apart from +0.0), where the others are
# held by value
BITS = K2_CASES + K14_CASES[1:] + (K15_CASE,) + TRAIN_OUTPUTS
REPS = 20  # launches per timing
TRAIN_STEP = "training step (median)"
STEP_KERNELS = "training step kernels (device ms by kernel)"
SERVE = "captured serving ms/pair (median)"
SERVE_TURN = "captured serving (ms/pair, host load, launches a pair)"
# kernels changed on purpose, with their bound against the other build
# (the rest, K5, K11 and K16 at head width 64, K6 at 64 and K7 at both
# widths among them, are held bit for bit): K5 at head width 32 in bf16 (1e-3 of
# the first design's scale) takes its ws form since it was built there,
# where the first design took the shape: products summed on the tensor
# cores in another order, and at AH = 4 each head's softmax in two halves
# of the keys, merged at the end, so some p round to bf16 at other running
# maxima; K6 at head width 32 in bf16 (1e-3 of each output's scale, as its
# kernel-vs-plain check states) takes its tc form since it was built there,
# where the first design took the shape: products on the tensor cores, the
# row sums of ex2.approx in base 2 per lane against expf rescaled per tile,
# merged across the quad; K4 (1e-5
# of the valid entries' scale, ~K4's 1e-4 absolute at out ~ 10) sums each
# row and column in two lanes' slices of two FMA chains each, where its
# first design summed 32 lanes' strided shares; the bf16 K13's conv (1e-3;
# its skip max stays bit for bit) runs on K12's tensor-core tiles since its
# redesign, whose H contraction sums in another order than the first
# design's CUDA-core gather (as K12's did, 2.1e-4, when it took that form);
# the bf16 K14's wf (1e-2, as selfcheck.check_fused_conv states; its pooled
# stays bit for bit) runs on K1's tensor-core routine since its redesign,
# whose H contraction sums in another order than the first design's FMA
# chain, so a sum rounds to bf16 an ulp apart where the orders round apart;
# the bf16 K11 at head width 32 (1e-2 of each gradient's scale, as its
# kernel-vs-plain check states; at 64 and in float32 it stays bit for bit)
# takes its tc form since it was built there, where the first design took
# the shape: P, dS and dO rounded to bf16 before the products, where the
# first design kept them in float32; the bf16 K10 (1e-2
# of each gradient's scale, as its kernel-vs-plain check states; its float32
# form, the first design, stays bit for bit) runs in its tc form since its
# redesign, which rounds the bases to bf16 before the products and sums on
# the tensor cores per block, where the first design summed float32 bases
# per query row; the bf16 K12 at H 36 (1e-2, K12's tolerance in
# selfcheck.check_fused_conv) takes its tc48 form since it was built, where
# the first design took the shape: the H contraction summed on the tensor
# cores in another order before the same per-k rounding to bf16, the weight
# product on the tensor cores; the bf16 K16 at head width 32 (1e-2, K16's
# tolerance in selfcheck.check_rpe_attention_femb) takes its ws form since
# it was built there, where the first design took the shape: the same
# bases, G and rows rounded to bf16, the projections and products summed on
# the tensor cores in another order, so a row can round an ulp apart
TOLERANCES = {**dict.fromkeys((c[0] for c in K16_BF16_32), 1e-2),
              **dict.fromkeys((c[0] for c in K11_BF16_32), 1e-2), K10_CASES[0]: 1e-2,
              **dict.fromkeys((c[0] for c in K5_BF16_32), 1e-3), K6_BF16_32: 1e-3,
              **dict.fromkeys(K4_CASES, 1e-5), K13_CASES[0]: 1e-3, K14_CASES[0]: 1e-2,
              K12_CASES[2]: 1e-2}


def _femb_case(rpe_attention, args, hc):
    """K16's call on ``args`` (q .. wa); where the checkout's wrapper takes
    folded tables, folded in the call and passed, so that its time includes
    the fold as a build whose wrapper folds them does."""
    kw = dict(scale=hc ** -0.5, sigma_d=0.2, sigma_a=15.0)
    if not hasattr(rpe_attention, "femb_tables"):
        return lambda: rpe_attention.rpe_self_attention_femb(*args, **kw)
    return lambda: rpe_attention.rpe_self_attention_femb(
        *args, tables=rpe_attention.femb_tables(args[8], args[9], 15.0, args[0].dtype), **kw)


def _cases(dev):
    """[(name, fn)] on seeded inputs; ``fn`` returns a tensor or a tuple."""
    from se3et_tpu_torch.ops.kernels import (
        embedding, eq_attention, rpe_attention, selfcheck, sinkhorn,
    )
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(0)
    cases = []
    for n, cc, hc, dtype in ((1024, 256, 64, torch.bfloat16), (128, 64, 16, torch.float32)):
        points = (torch.rand((2, n, 3), generator=g) * 4 - 2).to(dev)
        masks = torch.ones((2, n), dtype=torch.bool, device=dev)
        masks[1, -40:] = False
        sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
        idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
        knn = torch.gather(points, 1, idx.reshape(2, -1, 1).expand(-1, -1, 3)).reshape(
            2, n, 3, 3)
        w = [((torch.rand(s, generator=g) * 2 - 1) * cc ** -0.5).to(dev)
             for s in ((cc, cc), (cc,), (cc, cc), (cc,))]
        tag = "bf16" if dtype == torch.bfloat16 else "float32"
        cases.append((f"K3 N={n} C={cc} {tag}",
                      lambda p=points, k=knn, w=w, dt=dtype: embedding.geometric_embedding(
                          p, k, *w, 0.2, 15.0, out_dtype=dt)))
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, dtype)  # noqa: E731
        emb = rnd(2, n, n, cc)
        pts = rpe_attention.point_rows(points)
        for ah, with_sh in ((24, True), (4, False)):
            q, k, v = rnd(2, ah, n, hc), rnd(2, ah, n, hc), rnd(2, ah, n, hc)
            qp = rnd(2, n, ah, cc) * cc ** -0.5
            qw = (torch.randn((2, 3, ah, n), generator=g) * 0.3).to(dev) if with_sh else None
            sh = "SH" if with_sh else "no SH"
            args = (q, k, v, qp, emb, masks, qw, pts if with_sh else None)
            cases.append((f"K5 AH={ah} {sh} N={n} C={cc} {tag}",
                           lambda a=args, hc=hc: rpe_attention.rpe_self_attention_with_lse(
                               *a, scale=hc ** -0.5)))
            # K11 on this build's K5 output and row statistics (K5 stays bit
            # for bit against the other build), so that its time is K11's
            saved = args + (torch.randn((2, ah, n, hc), generator=g).to(dev),) \
                + rpe_attention.rpe_self_attention_with_lse(*args, scale=hc ** -0.5)
            cases.append((f"K11 AH={ah} {sh} N={n} C={cc} {tag}",
                          lambda a=saved, hc=hc: tuple(
                              t for t in rpe_attention.rpe_attention_bwd(*a, scale=hc ** -0.5)
                              if t is not None)))
            cases.append((f"K16 AH={ah} {sh} N={n} C={cc} {tag}",
                          _femb_case(rpe_attention, (q, k, v, qp, masks, qw, pts, knn, w[0],
                                                     w[2]), hc)))
    g10 = torch.Generator().manual_seed(10)
    for name, (n, cc, dtype) in zip(K10_CASES, ((1024, 256, torch.bfloat16),
                                                (128, 64, torch.float32))):
        points = (torch.rand((2, n, 3), generator=g10) * 4 - 2).to(dev)
        sq = torch.cdist(points, points)
        idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
        knn = torch.gather(points, 1, idx.reshape(2, -1, 1).expand(-1, -1, 3)).reshape(
            2, n, 3, 3)
        w = [((torch.rand(s, generator=g10) * 2 - 1) * cc ** -0.5).to(dev)
             for s in ((cc, cc), (cc,), (cc, cc), (cc,))]
        d_emb = torch.randn((2, n, n, cc), generator=g10).to(dev, dtype)
        cases.append((name, lambda a=(d_emb, points, knn, *w): embedding.geometric_embedding_bwd(
            *a, 0.2, 15.0)))
    bf = torch.bfloat16
    for name, nq, ns, h, ac, ac2 in (("K12 stage 0", 20000, 20000, 24, 192, 0),
                                     ("K12 stage 1", 10000, 10000, 32, 384, 0),
                                     ("K13 s0 -> s1", 10000, 20000, 24, 192, 768)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, bf)
        infl = (torch.rand((2, nq, h, 15), generator=g).to(dev) * (nbr < ns)[..., None]).to(bf)
        rhs = (torch.randn((ac, 15 * ac), generator=g) * (15 * ac) ** -0.5).to(dev, bf).t()
        if ac2:
            x2 = torch.randn((2, ns, ac2), generator=g).to(dev, bf)
            for i, case in enumerate(K13_CASES):
                cases.append((case, lambda a=(x, nbr, infl, x2, rhs), i=i:
                              wc.gather_wf_max_mm(*a)[i]))
        else:
            cases.append((name, lambda a=(x, nbr, infl, rhs): wc.gather_wf_mm(*a)))
    # se3ete2's stage-2 convs (H 36), on inputs of their own
    g12 = torch.Generator().manual_seed(12)
    nq, h, ac = 3072, 36, 384
    nbr = torch.cat([selfcheck.local_neighbors(nq, nq, h, g12, dev) for _ in range(2)])
    x = torch.randn((2, nq, ac), generator=g12).to(dev, bf)
    infl = (torch.rand((2, nq, h, 15), generator=g12).to(dev) * (nbr < nq)[..., None]).to(bf)
    rhs = (torch.randn((ac, 15 * ac), generator=g12) * (15 * ac) ** -0.5).to(dev, bf).t()
    cases.append((K12_CASES[2], lambda a=(x, nbr, infl, rhs): wc.gather_wf_mm(*a)))
    for name, nq, ns, h, ac, dtype in (("K1 stage 2", 2500, 2500, 36, 768, bf),
                                       ("K1 s2 -> s3", 1024, 2500, 36, 768, bf),
                                       ("K1 stage 3", 1024, 1024, 38, 1536, bf),
                                       *((*c, torch.float32) for c in K1_F32)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, dtype)
        infl = (torch.rand((2, nq, h, 15), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(dtype)
        cases.append((name, lambda a=(x, nbr, infl): wc.gather_wf(*a)))
    g8 = torch.Generator().manual_seed(8)
    for name, nq, ns, h, ac in zip(K8_CASES, (20000, 10000, 10000), (20000, 20000, 10000),
                                   (24, 24, 32), (192, 192, 384)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g8, dev) for _ in range(2)])
        dwf = torch.randn((2, nq, 15 * ac), generator=g8).to(dev)
        infl = torch.rand((2, nq, h, 15), generator=g8).to(dev) * (nbr < ns)[..., None]
        cases.append((name, lambda a=(dwf, nbr, infl, ns): wc.gather_wf_bwd(*a)))
    g9 = torch.Generator().manual_seed(9)
    for name, nq, ns, h, ac in K9_CASES:
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g9, dev) for _ in range(2)])
        x = torch.randint(-8, 9, (2, ns, ac), generator=g9).float().to(dev)
        dout = torch.randn((2, nq, ac), generator=g9).to(dev)
        out = wc.neighbor_max_plain(x, nbr)
        cases.append((name, lambda a=(dout, x, out, nbr): wc.neighbor_max_bwd(*a)))
    for n, c, dtype in ((1024, 64, bf), (128, 16, torch.float32)):
        q = torch.randn((6, 4, n, c), generator=g).to(dev, dtype)
        k = torch.randn((6, 4, n, c), generator=g).to(dev, dtype)
        qm = torch.arange(n, device=dev) < n - 24
        km = torch.arange(n, device=dev) < n - 40
        tag = "bf16" if dtype == bf else "float32"
        cases.append((f"K6 N=M={n} c={c} {tag}",
                      lambda a=(q, k, qm, km): eq_attention.eq_attention_stats(*a)))
        v = torch.randn((6, 4, n, c), generator=g).to(dev, dtype)
        rowmax, rowsum, _ = eq_attention.eq_attention_stats_plain(q, k, qm, km)
        w = torch.rand((6, 6), generator=g).to(dev)
        cases.append((f"K7 N=M={n} c={c} {tag}",
                      lambda a=(q, k, v, w / w.sum(1, keepdim=True), rowmax, rowsum, km):
                      eq_attention.eq_attention_apply(*a)))
    g7 = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((6, 4, 1024, 32), generator=g7).to(dev, bf) for _ in range(3))
    qm = torch.arange(1024, device=dev) < 1024 - 24
    km = torch.arange(1024, device=dev) < 1024 - 40
    cases.append((K6_BF16_32, lambda a=(q, k, qm, km): eq_attention.eq_attention_stats(*a)))
    rowmax, rowsum, _ = eq_attention.eq_attention_stats_plain(q, k, qm, km)
    w = torch.rand((6, 6), generator=g7).to(dev)
    cases.append((K7_BF16_32, lambda a=(q, k, v, w / w.sum(1, keepdim=True), rowmax, rowsum, km):
                  eq_attention.eq_attention_apply(*a)))
    g32 = torch.Generator().manual_seed(32)
    points = (torch.rand((2, 1024, 3), generator=g32) * 4 - 2).to(dev)
    masks = torch.ones((2, 1024), dtype=torch.bool, device=dev)
    masks[1, -40:] = False
    emb = torch.randn((2, 1024, 1024, 128), generator=g32).to(dev, bf)
    for name, ah, with_sh in K5_BF16_32:
        q, k, v = (torch.randn((2, ah, 1024, 32), generator=g32).to(dev, bf) for _ in range(3))
        qp = torch.randn((2, 1024, ah, 128), generator=g32).to(dev, bf) * 128 ** -0.5
        qw = (torch.randn((2, 3, ah, 1024), generator=g32) * 0.3).to(dev) if with_sh else None
        pts = rpe_attention.point_rows(points) if with_sh else None
        cases.append((name, lambda a=(q, k, v, qp, emb, masks, qw, pts):
                      rpe_attention.rpe_self_attention_with_lse(*a, scale=32 ** -0.5)))
    # K11 at head width 32, on this build's K5 output and row statistics
    g11 = torch.Generator().manual_seed(11)
    for name, ah, with_sh in K11_BF16_32:
        q, k, v = (torch.randn((2, ah, 1024, 32), generator=g11).to(dev, bf) for _ in range(3))
        qp = torch.randn((2, 1024, ah, 128), generator=g11).to(dev, bf) * 128 ** -0.5
        qw = (torch.randn((2, 3, ah, 1024), generator=g11) * 0.3).to(dev) if with_sh else None
        args = (q, k, v, qp, emb, masks, qw, rpe_attention.point_rows(points) if with_sh else None)
        saved = args + (torch.randn((2, ah, 1024, 32), generator=g11).to(dev),) \
            + rpe_attention.rpe_self_attention_with_lse(*args, scale=32 ** -0.5)
        cases.append((name, lambda a=saved: tuple(
            t for t in rpe_attention.rpe_attention_bwd(*a, scale=32 ** -0.5) if t is not None)))
    # K16 at head width 32 on the same points, inputs of its own generator
    g16 = torch.Generator().manual_seed(16)
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(2, -1, 1).expand(-1, -1, 3)).reshape(2, 1024, 3, 3)
    wd, wa = (((torch.rand((128, 128), generator=g16) * 2 - 1) * 128 ** -0.5).to(dev)
              for _ in range(2))
    for name, ah, with_sh in K16_BF16_32:
        q, k, v = (torch.randn((2, ah, 1024, 32), generator=g16).to(dev, bf) for _ in range(3))
        qp = torch.randn((2, 1024, ah, 128), generator=g16).to(dev, bf) * 128 ** -0.5
        qw = (torch.randn((2, 3, ah, 1024), generator=g16) * 0.3).to(dev) if with_sh else None
        cases.append((name, _femb_case(rpe_attention, (q, k, v, qp, masks, qw,
                                                       rpe_attention.point_rows(points), knn,
                                                       wd, wa), 32)))
    for name, (b, m, n) in zip(K4_CASES, ((256, 65, 65), (6, 17, 13))):
        padded, mu, nu, valid = selfcheck.sinkhorn_inputs(b, m, n, dev)
        cases.append((name, lambda a=(padded, mu, nu), v=valid: torch.where(
            v, sinkhorn.sinkhorn(*a, 100), 0.0)))
    for name, (nq, ns, h, ac, dtype) in zip(K2_CASES, ((1024, 2500, 36, 3072, bf),
                                                       (10000, 20000, 24, 768, torch.float32))):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, dtype)
        cases.append((name, lambda a=(x, nbr): wc.neighbor_max(*a)))
    nq, ns, h, ac, ac2 = 2500, 10000, 32, 384, 1536
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
    x = torch.randn((2, ns, ac), generator=g).to(dev, bf)
    infl = (torch.rand((2, nq, h, 15), generator=g).to(dev) * (nbr < ns)[..., None]).to(bf)
    x2 = torch.randn((2, ns, ac2), generator=g).to(dev, bf)
    for i, case in enumerate(K14_CASES):
        cases.append((case, lambda a=(x, nbr, infl, x2), i=i: wc.gather_wf_max(*a)[i]))
    from se3et_tpu_torch.core import kernel_points as kp_lib

    g15 = torch.Generator().manual_seed(15)
    pts = (torch.rand((2, 20000, 3), generator=g15) * 0.15).to(dev)
    nbr = torch.cat([selfcheck.local_neighbors(20000, 20000, 24, g15, dev) for _ in range(2)])
    kp = torch.as_tensor(kp_lib.equivariant_kernel_points(0.0625, 15, 6, 4), dtype=torch.float32,
                         device=dev)
    cases.append((K15_CASE, lambda a=(pts, pts, nbr, kp): wc.influence(
        *a, sigma=0.05, mode="linear", out_dtype=bf)))
    return cases


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _any_bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor of any dtype flattened, floats as their bytes (NaNs and
    signed zeros included)."""
    flat = t.detach().contiguous().reshape(-1)
    return flat.view(torch.uint8) if flat.dtype.is_floating_point else flat


def _same_bits(a, b) -> bool:
    """Two lists of tensors of the same shapes and bit patterns."""
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(_bits(x), _bits(y))
                                    for x, y in zip(a, b))


def _train_step_ms(steps: int):
    """Median ms of ``steps`` synchronised full-width training steps, after
    one warm-up step, in the checkout on ``sys.path[0]``, each on fresh
    device tensors of the pair; {kernel: device ms} of one more step under
    ``torch.profiler``; and, from as many steps again on a fresh model with
    ``torch.use_deterministic_algorithms`` on (warn only; the operations it
    warns about are printed), the last step's losses, gradients and
    parameters ({name: [CPU tensors]}, in the model's parameter order)."""
    import time
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from se3et_tpu_torch.data.influence import precompute_influence
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import make_optimizer
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = precompute_influence(
        synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                       synthetic_extent(cfg.data.dataset), seed=cfg.seed), cfg.model)
    dev = torch.device("cuda", 0)

    def fresh():
        model = SE3ETModel(cfg.model, seed=cfg.seed)
        step = make_train_step(model, cfg.loss, make_optimizer(model.parameters(), cfg.optim, 1))
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        step(pyramid_to_tensors(pair, dev), generator=gen)
        return model, step, gen

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model, step, gen = fresh()
            for _ in range(steps):
                losses = step(pyramid_to_tensors(pair, dev), generator=gen)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    params = [p for _, p in model.named_parameters()]
    state = dict(zip(TRAIN_OUTPUTS, (
        [losses[k].cpu() for k in sorted(losses)], [p.grad.cpu() for p in params],
        [p.detach().cpu() for p in params])))
    warned = sorted({str(w.message).split(" does not have a deterministic")[0].split("\n")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"deterministic training steps ({sys.path[0]}): operations warned about: "
          f"{warned or 'none'}", flush=True)
    del model, step, params

    model, step, gen = fresh()
    ms = []
    for _ in range(steps):
        inputs = pyramid_to_tensors(pair, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(inputs, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    inputs = pyramid_to_tensors(pair, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(inputs, generator=gen)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            kernels[e.key] = (e.self_cuda_time_total if t is None else t) / 1e3
    return statistics.median(ms), kernels, state


def _serve_ms(experiment: str, pairs: int, femb: bool = False):
    """``pairs`` captured serving ms of ``experiment``'s first two synthetic
    pairs in turn, after one untimed pair, in the checkout on
    ``sys.path[0]``, every replay first held to the eager forward bit for
    bit; and the launches a pair.  ``femb``: on the ``serve_femb`` route."""
    import dataclasses
    import time

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.experiments import configs
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    dev = torch.device("cuda", 0)
    cfg = configs.serving_config(configs.make_cfg(experiment))
    extent = configs.synthetic_extent(cfg.data.dataset)
    inputs = [pyramid_to_tensors(synthetic_pair(i, cfg.pipeline, cfg.model,
                                                cfg.data.point_limit, extent, seed=cfg.seed),
                                 dev) for i in range(2)]
    m = dataclasses.replace(cfg.model, serve_femb=True) if femb else cfg.model
    model = SE3ETModel(m, seed=cfg.seed).eval()
    eager = [model(td) for td in inputs]
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    served = capture_forward(model, inputs[0])
    for i, td in enumerate(inputs):
        got = served(td)
        if set(got) != set(eager[i]) or not all(
                torch.equal(_any_bits(got[k]), _any_bits(v))
                for k, v in eager[i].items() if torch.is_tensor(v)):
            raise RuntimeError(f"{sys.path[0]}: pair {i}'s replay differs from the eager forward")
    served(inputs[0])
    ms = []
    for i in range(pairs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = served(inputs[i % 2])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(got["estimated_transform"]).all()):
            raise RuntimeError(f"{sys.path[0]}: a non-finite transform")
    return ms, {n: c for n, c in served.launches.items() if c}


def _worker(tree: str, out: str, save: bool, train_steps: int, serve_pairs: int,
            experiment: str, femb: bool = False) -> None:
    """One run in checkout ``tree``: the outputs (saved when ``save``) and
    the ms of the ``TIMED`` cases (and of ``train_steps`` training steps,
    and of ``serve_pairs`` pairs of ``experiment`` served captured)."""
    sys.path[0] = tree  # in place of this script's directory
    from se3et_tpu_torch.ops.kernels import _build, selfcheck

    _build.build()
    cases = dict(_cases(torch.device("cuda", 0)))
    outs = {}
    with torch.no_grad():
        for name, fn in cases.items():
            got = fn()
            outs[name] = [t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
        torch.cuda.synchronize()
        ms = {name: selfcheck._time_ms(cases[name], REPS) for name in TIMED}
    del cases
    if train_steps:
        ms[TRAIN_STEP], ms[STEP_KERNELS], state = _train_step_ms(train_steps)
        torch.save(state, out + ".train.pt")
    if serve_pairs:
        load = os.getloadavg()
        pair_ms, launches = _serve_ms(experiment, serve_pairs, femb)
        ms[SERVE] = statistics.median(pair_ms)
        ms[SERVE_TURN] = [pair_ms, load, launches]
    if save:
        torch.save(outs, out + ".pt")
    with open(out + ".json", "w") as f:
        json.dump(ms, f)


def _print_step_kernels(times, top=12) -> None:
    """The profiled steps' kernel totals per turn, and the ``top`` kernels
    whose device ms moved most (median this - median other)."""
    per = {who: [t[STEP_KERNELS] for t in times[who]] for who in times}
    print("step kernels ms, profiled, per turn: other "
          f"{[round(sum(k.values()), 2) for k in per['other']]}, this "
          f"{[round(sum(k.values()), 2) for k in per['this']]}", flush=True)
    names = set().union(*(k for who in per for k in per[who]))
    med = {who: {n: statistics.median(k.get(n, 0.0) for k in per[who]) for n in names}
           for who in per}
    moved = sorted(names, key=lambda n: abs(med["this"][n] - med["other"][n]), reverse=True)
    for n in moved[:top]:
        print(f"  {med['this'][n] - med['other'][n]:+9.4f} ms  (other {med['other'][n]:.4f}, "
              f"this {med['this'][n]:.4f})  {n[:100]}", flush=True)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="root of the other checkout")
    parser.add_argument("--worker", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    parser.add_argument("--save", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--train-steps", type=int, default=0,
                        help="also time this many full-width training steps a turn")
    parser.add_argument("--serve-pairs", type=int, default=0,
                        help="also serve this many pairs captured a turn")
    parser.add_argument("--serve-experiment", default="se3ete2.3dmatch",
                        help="the experiment served with --serve-pairs")
    parser.add_argument("--serve-femb", action="store_true",
                        help="serve it on the serve_femb route (K16 in place of K3 + K5)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bit_identity: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        _worker(*args.worker, args.save, args.train_steps, args.serve_pairs,
                args.serve_experiment, args.serve_femb)
        return 0
    if not args.other:
        parser.error("--other is required")
    mine = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    other = os.path.abspath(args.other)
    work = os.path.join(mine, "se3et_tpu_torch", "_build", "before_after")
    os.makedirs(work, exist_ok=True)
    turns = [("other", other), ("this", mine), ("this", mine), ("other", other)]
    times = {"this": [], "other": []}
    for i, (who, tree) in enumerate(turns):
        out = os.path.join(work, f"turn{i}")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree, out,
               "--train-steps", str(args.train_steps), "--serve-pairs", str(args.serve_pairs),
               "--serve-experiment", args.serve_experiment] + (["--save"] if i < 2 else []) \
            + (["--serve-femb"] if args.serve_femb else [])
        subprocess.run(cmd, check=True, cwd=tree)
        with open(out + ".json") as f:
            times[who].append(json.load(f))
        if args.serve_pairs:
            pair_ms, load, launches = times[who][-1][SERVE_TURN]
            print(f"turn {i} {who}: {args.serve_experiment}"
                  f"{' serve_femb' if args.serve_femb else ''} captured, host load "
                  f"{[round(x, 2) for x in load]}; launches a pair {launches}; ms/pair "
                  f"{[round(x, 2) for x in pair_ms]}", flush=True)
    theirs = torch.load(os.path.join(work, "turn0.pt"))
    ours = torch.load(os.path.join(work, "turn1.pt"))
    if args.train_steps:
        train = [torch.load(os.path.join(work, f"turn{i}.train.pt")) for i in range(4)]
        theirs.update(train[0])
        ours.update(train[1])
        for who, (i, j) in (("other", (0, 3)), ("this", (1, 2))):
            same = {name: _same_bits(train[i][name], train[j][name]) for name in TRAIN_OUTPUTS}
            print(f"training step outputs, {who} run to run: " + ", ".join(
                f"{name} {'bit-identical' if ok else 'DIFFER'}" for name, ok in same.items()),
                flush=True)
    bad = 0
    for name, a in ours.items():
        b = theirs[name]
        if name in BITS:
            same = _same_bits(a, b)
        else:
            same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x.float() - y.float()).abs().max()) / max(
            float(y.float().abs().max()), 1e-30) for x, y in zip(a, b))
        if name in TOLERANCES:
            ok = diff <= TOLERANCES[name]
            verdict = (f"{'within' if ok else 'OUTSIDE'} {TOLERANCES[name]} of the other's scale "
                       f"(max |diff| / max |other| {diff:.3e}; bit-identical {same})")
        else:
            ok = same
            verdict = "bit-identical" if same else f"DIFFERS (max |diff| / max |other| {diff:.3e})"
        print(f"{name}: {verdict}", flush=True)
        bad += not ok
    for name in TIMED + ((TRAIN_STEP,) if args.train_steps else ()) \
            + ((SERVE,) if args.serve_pairs else ()):
        print(f"{name} ms in turns (other, this, this, other): "
              f"other {[round(t[name], 4) for t in times['other']]} (median "
              f"{statistics.median(t[name] for t in times['other']):.4f}), this "
              f"{[round(t[name], 4) for t in times['this']]} (median "
              f"{statistics.median(t[name] for t in times['this']):.4f})", flush=True)
    if args.train_steps:
        _print_step_kernels(times)
    print(_card())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
