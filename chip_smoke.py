"""Smoke run of the PyTorch port (``se3et_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build the thirteen CUDA sources of ``se3et_tpu_torch/csrc`` (nvcc,
   sm_90a, all started together);
2. build four synthetic 3DMatch pairs at point_limit 20000 on the host
   (the port's numpy pipeline, exact neighbours), timed without and with
   the port's host influence, and say which host-ops route ran (``native``
   C++ library or ``numpy``);
3. hold each of the ten serving kernels against its plain PyTorch version
   at the slice's real shapes, in the working dtype (bf16 for K1-K3, K5-K7
   and K12-K14, float32 for K4), with its bound and, where one exists, the
   time of one PyTorch call computing the same function; for the fused
   convs K12-K14 also the time of the unfused route (K1 + matmul (+ K2)),
   and K1 at the shapes where it serves on the fused route (the stage 2-3
   convs) beside its stage-0 row; K2 at the s2 -> s3 skip (where it serves
   on the fused route) by events and by its device time (profiler), beside
   its times before the redesign, and at the three strided skips of the
   unfused route (bf16) and of training (float32), each beside its first
   design's time on the same inputs; K5 at
   its two self-layer shapes by events and device time beside its times
   before the redesign, with its total per served pair (as K1's); K6 and K7 by events over 20
   launches and by their device time (profiler), with their totals per
   served pair and their bounds, beside their times before the redesign,
   and for K7 the time of the two PyTorch calls that compute its function
   (``scaled_dot_product_attention`` with the key mask, then the weighted
   sum over key anchors); K4 the same way (events over 20 launches, device
   time), beside its bound, its chain floor from
   ``scripts/probe_sinkhorn.py`` and its first design's times; K13 the same
   way, beside its bound, the unfused route and its first design's times,
   with what its skip max must read on pair 0 (valid references, distinct
   rows per 64-row tile); K14 the same way (events over 20 launches,
   device time), beside the unfused route K1 + K2, its times before the
   redesign and its first design's time on the same inputs;
4. check that the kernel path (card) and the plain path (CPU) agree on two
   tiny float32 inputs: the materialised-attention cut and the flash cut
   (128-point coarse stage, 600 points), both through the fused convs
   K12/K13 in float32, the latter launching K5-K7 (coarse features and
   matching scores within 1e-3; the transform by
   ``selfcheck.registration_agreement``);
5. serve the four pairs at full se3ete.3dmatch width through
   ``SE3ETModel.forward`` (default routes: fused convs, flash attention)
   with seeded random weights, with every kernel's launch counter reset
   before and checked after (per pair K12 3, K13 1, K14 1, K1 5, K2 1 --
   the JAX package's split, ``scripts/fused_conv_split.py`` -- K5 5, K6 4,
   K7 4, the others > 0); ms/pair against the same weights on the unfused
   conv route (``serve_fused_conv=False``), served in turns, and the
   backbone features of the two routes on pair 0; then the section times
   from the ``stop_after`` cuts and the device time by kernel over one
   served pair (``torch.profiler``); then the captured forward
   (``engine/serving.py`` ``capture_forward``): captured on pair 0 with its
   launch counts checked against the eager pair's, every output of all
   four pairs replayed equal to the eager forward's bit for bit, the
   capture time and peak memory, eager and captured served in turns (8
   pairs each, host load printed before each turn), and the profile of one
   replayed pair, where every serving kernel must appear with its eager
   count per pair;
6. training: hold the four backward kernels (K8-K11) against their plain
   versions at the training shapes with their bounds, K8 (its form
   "tiles") at the seven training shapes on pair 0's neighbour sets by
   events and device time beside its first design in the same run (bit
   for bit against it and against a second call of itself), with its bound,
   the share of it, the re-read factor and its total per step, and its tile
   plan (merged on the card from the set's reverse index) against its plain
   version, with its build time; K1 in float32 (its form "rows") at the same
   seven shapes the same way (events and device time beside its first
   design in this run, bit for bit against it and against a second call of
   itself, bound, share, launches a step and the ``embedding_bag`` sum's
   time), with its total per step; K9 (its form "tiles") at the three
   strided skips the same way (events and device time beside its first
   design before the redesign and in this run, bit for bit against it and
   against a second call of itself, bound, share, re-read factor), with its
   total per step; K11 (its bf16 form
   "tc") at both self-layer shapes by events and device time (the kernel
   and the whole call, its products included) beside its first design's
   times before the redesign and in this run, and K10 (its bf16 form "tc")
   at d_emb (2, 1024, 1024, 256) the same way; one tiny float32
   training step on the card and on the CPU with the same weights and
   target noise, agreeing on the losses and every parameter's gradient;
   then ``make_train_step`` at full se3ete.3dmatch width (float32, the JAX
   training routes): one warm-up and three timed steps on the synthetic
   pairs with the backward kernels' launch counters reset before and
   checked after (K8 10, K9 3, K10 1, K11 5 per step; forward K1 10, K2 3,
   K3 1, K4 1, K5 5), finite losses and gradient norm, the step time, the
   forward + loss time alone, peak memory and a ``torch.profiler``
   breakdown of one step (kernels only: device-side profiler ranges such as
   ``Optimizer.step#AdamW.step`` are printed apart and left out of the sum
   and the idle share, here and in every profile; with K2's float32 line,
   K10's tc kernel, which must appear once, K8's tiles kernel and K1's rows
   kernel, 10 times each, K9's two tiles kernels 3 times each, K1's and
   K9's first designs never, and the device ms per launch of K8's tiles
   kernel, K9, the float32 K1 and K10);
7. the routes off the default one: K15 (device influence, its form
   "tiles") against its plain version at the seven (stage, neighbour set)
   shapes of pair 0 in bf16 and the model's mode, each bit for bit against
   its first design and a second call of itself, replayed from a CUDA graph
   of 20 calls (device time, no host), by events and by device time
   beside the first design in the same run, with its bound, and their sums
   over a pair (and over the four sets below 0.002 ms of bound); K16
   (``serve_femb``) at the self_eq (AH = 24, SH) and plain self (AH =
   4) shapes; tiny float32 card-vs-CPU runs with ``serve_femb=True`` and on
   a pyramid without host influence; the four pairs without host influence
   served in turns with the default route (per pair K15 7, every launch on
   its tiles form), then with
   ``serve_femb=True`` in turns with the default route (per pair K16 5, K3
   0, K5 0), with ms/pair, peak memory, the routes' differences on pair 0
   and a ``torch.profiler`` breakdown of one device-influence pair (K15's
   kernels counted by form) and one femb pair; the default and
   device-influence routes captured (K15 inside the graph) and replayed on
   the four pairs, bit for bit against eager, and served in turns, captured
   default / device influence / device influence / default, 8 pairs each;
   K16's two shapes by events and
   device time beside its first design's times and K5's (phase 3, now with
   its device time too), with their totals per served pair; the default
   and femb routes captured (each replay bit for bit against eager, the
   peak memory of each) and served in turns, captured default / femb /
   femb / default, 8 pairs each with the host load before each turn; then
   ``se3et_tpu_torch.entry.entry()`` once, with a finite transform, printed
   beside its largest matching score (7 K15 launches, all on its tiles form);
8. the registry's test path: ``se3eti.3dmatch`` through ``run_test``'s
   Tester (calibrated limits, the captured eval forward) on 4 synthetic
   pairs, with every counter set to 0 just before and read just after and
   an eager eval pair's counters held to ``SE3ETI_LAUNCHES``; every replayed
   output and metric bit for bit against the eager eval forward; the conv
   kernels K12, K13, K14, K1 and K2 against their plain versions at the
   shapes this path gave them (se3eti's caps, the calibrated widths); the
   same run on 2 pairs at the registry's neighbour widths (``--no_calibrate``);
   ``run_eval`` (lgr, svd) over the dumps, ``run_demo`` on
   ``se3ete.3dmatch.evalrot``, and K5 at the self_eq layers' shape (AH =
   24) without the SH term, on its ws form;
9. the wide-head family (head width 32: K5 and K16 on their ws forms, K6
   and K7 on their tc forms, K12's stage-2 convs (H 36) on its tc48
   form): a tiny float32 card-vs-CPU run of
   ``se3ete2.3dmatch``'s
   flash cut; ``se3ete2.3dmatch`` served at full width on 2 synthetic
   pairs of 30000 points (stage-0 sets at least half their 24576 cap, host
   influence, random weights from seed 7351): an eager pass held to
   ``SE3ETE2_LAUNCHES`` a pair, ``capture_forward`` with its counts and
   every replay bit for bit against eager, eager and captured in turns,
   peak memory and a replayed pair's profile (K6 on its tc kernel 4 times
   and K12 on its tc48 kernel twice, their first designs never); K5 at
   both self-layer
   shapes, K6, K7 and K3 at the path's shapes against their plain
   versions, replayed from a CUDA graph beside their bounds (K5, K6 and K7
   also beside their first designs in the same run, by events and replayed);
   K12, K13,
   K14, K1 and K2 at the family's conv shapes (K12's tc48 form at the
   stage-2 shape also beside its first design and the unfused route, by
   events and replayed, with its bound and the share of it reached, and the
   seconds these take); the ``serve_femb`` route: one eager pair (K16 5,
   K3 0, K5 0), captured (every replay bit for bit against eager), served
   in turns with the captured default route (default / femb / femb /
   default, 8 pairs each) and one replayed femb pair profiled (K16's ws
   kernel 5 times, its first design never, device ms per launch); K16 at
   both self-layer shapes against its plain version, by events and
   replayed beside its first design in the same run, with its bound and
   the totals per femb pair; then ``se3eti2.3dmatch`` through ``run_test``'s
   Tester on 4 pairs (counts, replays and metrics bit for bit against
   eager) and K5 at its self_eq shape without the SH term, beside its first
   design in the same run.  Prints the phase's wall time;
10. the wide-head family trained: K11 at head width 32 (its tc form in
   bf16, beside its first design on the same inputs; the first design in
   float32) against its plain version at se3ete2's self_eq shape (q (2,
   24, 1024, 32), emb (2, 1024, 1024, 128), SH), its plain self shape (AH
   4) and se3eti2's self_eq shape (AH 24, no SH), by events, device time
   (the kernel and the whole call) and, in bf16, replayed from a CUDA
   graph, beside its bound;
   a tiny float32 card-vs-CPU training step of se3ete2's flash cut;
   ``make_train_step`` at full se3ete2 width on phase 9's two pairs (one
   warm-up and three timed steps, every counter set to 0 just before and
   read just after, held to ``SE3ETE2_TRAIN_LAUNCHES`` a step; finite
   losses and gradient norm, ms/step, forward + loss ms, peak memory); the
   float32 K1 ("rows"), K8 and K9 ("tiles") and K10 (C 128, "tc") against
   their plain versions at the family's training shapes; the registry's
   ``trainval`` on ``se3eti2.3dmatch`` through ``runner.main`` (an epoch of
   2 steps, validation on 2 pairs, snapshots), ``--resume`` to epoch 2
   (each call's backward launches held to one epoch's), and ``test
   --snapshot .../latest`` on 2 pairs with finite metrics; last, the
   profile of one se3ete2 training step.  Prints the phase's wall time and
   the script's.

Prints timings, then the card's name and power limit, a JSON line with the
kernels, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is present or the port is
not importable.
"""

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_PAIRS = 4
# launches per served pair on the flash route: 5 self layers (one stacked
# launch each), 2 EQ cross layers x 2 directions for K6 and for K7
FLASH_LAUNCHES = {"rpe_self_attention": 5, "eq_attention_stats": 4,
                  "eq_attention_apply": 4}
# launches per served pair of the conv kernels on the fused route
# (serve_fused_conv): stage 0-1 same-level convs K12, the s0 -> s1 strided
# block K13, s1 -> s2 K14, s2 -> s3 K1 + K2, stage 2-3 same-level convs K1
FUSED_CONV_LAUNCHES = {"gather_wf_mm": 3, "gather_wf_max_mm": 1, "gather_wf_max": 1,
                       "gather_wf": 5, "neighbor_max": 1}
# launches per training step: 10 gathering convs (all but the ones-input
# first one), 3 strided skips, 1 embedding, 1 Sinkhorn, 5 self layers
TRAIN_LAUNCHES = {"gather_wf": 10, "neighbor_max": 3, "geometric_embedding": 1,
                  "sinkhorn": 1, "rpe_self_attention": 5, "gather_wf_bwd": 10,
                  "neighbor_max_bwd": 3, "geometric_embedding_bwd": 1,
                  "rpe_attention_bwd": 5, "gather_wf_mm": 0, "gather_wf_max_mm": 0,
                  "gather_wf_max": 0}
TRAIN_STEPS = 3
# K11's and K10's device kernels at the bf16 training shapes (their tc forms)
K11_KERNEL = "rpe_attention_bwd_tc_kernel"
K10_KERNEL = "embedding_bwd_tc_kernel"
# K10 at the training shape before its redesign (first design, bf16; NVIDIA
# H100 80GB HBM3, 700 W): ms by events, device ms of the kernel
K10_BEFORE = (6.7367, 6.4331)
# K8's device kernel at the training shapes (its tiles form), its time at
# the stage-0 shape before the redesign (first design; NVIDIA H100 80GB
# HBM3, 700 W: ms by events), and its training shapes on pair 0: (what,
# neighbour set, source stage, channels A*C of the conv's input, launches
# per step)
K8_KERNEL = "gather_wf_bwd_tiles_kernel"
K8_BEFORE = 0.6996
K8_SHAPES = (("stage-0 same", "neighbors_0", 0, 192, 1), ("s0 -> s1", "subsampling_0", 0, 192, 1),
             ("stage-1 same", "neighbors_1", 1, 384, 2), ("s1 -> s2", "subsampling_1", 1, 384, 1),
             ("stage-2 same", "neighbors_2", 2, 768, 2), ("s2 -> s3", "subsampling_2", 2, 768, 1),
             ("stage-3 same", "neighbors_3", 3, 1536, 2))
# K1's float32 device kernel at the training shapes (its rows form), its
# device time per launch before the redesign (the first design's mean over
# the 10 launches of a step profile; NVIDIA H100 80GB HBM3, 700 W), and its
# training shapes: the forwards of K8's ten convs
K1_F32_KERNEL = "gather_wf_rows_kernel"
K1_F32_FIRST_KERNEL = "gather_wf_kernel"
K1_F32_BEFORE = 0.3913
K1_F32_SHAPES = K8_SHAPES
# K9's device kernels at the training shapes (its tiles form: the shares,
# then the sums), its first design's, and its times before the redesign
# (the first design; NVIDIA H100 80GB HBM3, 700 W): ms by events at the
# s0 -> s1, s1 -> s2 and s2 -> s3 skips, device ms per launch (the mean of
# the step profile's 3, two kernels a launch)
K9_KERNELS = ("max_bwd_share_rows_kernel", "max_bwd_tiles_kernel")
K9_FIRST_KERNELS = ("share_kernel", "tie_sum_kernel")
K9_BEFORE = ((0.6020, 0.5769, 0.7396), 0.6159)
# the training kernels' device kernels in the step profile, with launches of
# their wrapper per step: K9 two kernels a launch
STEP_KERNELS = {"K8": ((K8_KERNEL,), 10),
                "K9": (K9_KERNELS, 3),
                "K1 (float32)": ((K1_F32_KERNEL,), 10), "K10": ((K10_KERNEL,), 1)}
# launches per served pair on the routes of phase 7: device influence (7
# (stage, neighbour set) pairs), and serve_femb (5 self layers, no
# embedding written, no K5)
DEVICE_INFLUENCE_LAUNCHES = {"influence": 7}
# K15's two device kernels: the tiles form and the first design; the first
# design's times before the redesign (NVIDIA H100 80GB HBM3, 700 W): the
# stage-0 same-level set by events, and device ms per pair (7 launches at a
# mean of 0.0596)
K15_KERNEL, K15_FIRST_KERNEL = "influence_tiles_kernel", "influence_kernel"
K15_BEFORE = (0.1517, 7 * 0.0596)
FEMB_LAUNCHES = {"rpe_self_attention_femb": 5, "geometric_embedding": 0,
                 "rpe_self_attention": 0}
# K4's chain floor per launch at the serving shape: its rows form with each
# dot product cut to one load (log, exp, shuffle and barrier left), measured
# by scripts/probe_sinkhorn.py (``no_dot``) on an NVIDIA H100 80GB HBM3, 700 W
K4_CHAIN_FLOOR_MS = 0.0524
# the CUDA kernels of the default serving route (K1-K7, K12-K14 in bf16, K4
# in float32), whose device time per launch the pair profile always prints
SERVING_KERNELS = ("gather_wf_tc_kernel", "neighbor_max_rows_kernel", "embedding_tc_kernel",
                   "sinkhorn_rows_kernel", "rpe_attention_ws_kernel", "eq_stats_tc_kernel",
                   "eq_apply_tc_kernel", "gather_wf_mm_tc_kernel", "gather_wf_mm_tc48_kernel",
                   "panels_kernel",
                   "gather_wf_max_mm_tc_kernel", "gather_wf_mm_kernel", "gather_wf_max_kernel",
                   "gather_wf_max_tc_kernel")

# the device kernel each serving wrapper launches on the default route, and
# its launches per pair there
SERVING_DEVICE_KERNELS = {
    "gather_wf": "gather_wf_tc_kernel", "neighbor_max": "neighbor_max_rows_kernel",
    "geometric_embedding": "embedding_tc_kernel", "sinkhorn": "sinkhorn_rows_kernel",
    "rpe_self_attention": "rpe_attention_ws_kernel", "eq_attention_stats": "eq_stats_tc_kernel",
    "eq_attention_apply": "eq_apply_tc_kernel", "gather_wf_mm": "gather_wf_mm_tc_kernel",
    "gather_wf_max_mm": "gather_wf_max_mm_tc_kernel", "gather_wf_max": "gather_wf_max_tc_kernel"}
SERVING_LAUNCHES = {**FLASH_LAUNCHES, **FUSED_CONV_LAUNCHES, "geometric_embedding": 1,
                    "sinkhorn": 1}
# pairs per turn when the eager and the captured forward are served in turns
CAPTURED_TURN_PAIRS = 8
# phase 8: the registry's test path on SE3ET-I, and the demo's experiment
TEST_EXPERIMENT, DEMO_EXPERIMENT = "se3eti.3dmatch", "se3ete.3dmatch.evalrot"
TEST_PAIRS = 4
# pairs of phase 8's second Tester run, at the registry's neighbour widths
# (cut from 4 when phase 9 came, to hold the script's time)
NO_CALIBRATE_PAIRS = 2
# launches per served se3eti.3dmatch pair: the backbone's as on se3ete's
# default route, one embedding, three self_eq layers (K5 at AH = 24 without
# the SH term, one launch over both clouds each), plain dense cross layers
# (no K6 / K7), one Sinkhorn; host influence (no K15), no serve_femb
SE3ETI_LAUNCHES = {**FUSED_CONV_LAUNCHES, "geometric_embedding": 1, "sinkhorn": 1,
                   "rpe_self_attention": 3, "eq_attention_stats": 0, "eq_attention_apply": 0,
                   "influence": 0, "rpe_self_attention_femb": 0}
# eager warm-up forwards before capture_forward records the graph
CAPTURE_WARMUP = 3
# phase 9: the wide-head family (head width 32) served captured, and
# through the registry's test path
WIDE_EXPERIMENT, WIDE_TEST_EXPERIMENT = "se3ete2.3dmatch", "se3eti2.3dmatch"
WIDE_PAIRS, WIDE_TEST_PAIRS = 2, 4
# launches per served pair of the conv kernels at the family's widths
# (init_dim 32; nn/epn.py's gates: K12 takes A*Cout <= 384, K13 A*Cout <=
# 192 with a skip payload): the stage-0 to stage-2 same-level convs K12
# (1 + 2 + 2), the s0 -> s1 and s1 -> s2 strided blocks K13, s2 -> s3 K14,
# the stage-3 same-level convs K1; no K2
WIDE_CONV_LAUNCHES = {"gather_wf_mm": 5, "gather_wf_max_mm": 2, "gather_wf_max": 1,
                      "gather_wf": 2, "neighbor_max": 0}
# launches per served se3ete2 pair: the convs, one embedding, 5 self layers
# (K5: 2 self_eq at AH = 24 with the SH term, 3 plain at AH = 4), 2 EQ
# cross layers x 2 directions for K6 and for K7, one Sinkhorn
SE3ETE2_LAUNCHES = {**WIDE_CONV_LAUNCHES, **FLASH_LAUNCHES, "geometric_embedding": 1,
                    "sinkhorn": 1, "influence": 0, "rpe_self_attention_femb": 0}
# and per se3eti2 pair: three self_eq layers (K5 at AH = 24 without the SH
# term), plain dense cross layers (no K6 / K7)
SE3ETI2_LAUNCHES = {**WIDE_CONV_LAUNCHES, "geometric_embedding": 1, "sinkhorn": 1,
                    "rpe_self_attention": 3, "eq_attention_stats": 0, "eq_attention_apply": 0,
                    "influence": 0, "rpe_self_attention_femb": 0}
# the device kernels of K5 (its ws form, the rpe_attention_ws_kernel<AH, 32>
# instances), K6 (its tc form, the eq_stats_tc_kernel<32, ...> instances)
# and K7 (its tc form, the eq_apply_tc_kernel<32> instance) at head width 32
WIDE_DEVICE_KERNELS = {"rpe_self_attention": "rpe_attention_ws_kernel",
                       "eq_attention_stats": "eq_stats_tc_kernel",
                       "eq_attention_apply": "eq_apply_tc_kernel"}
# K6's first design (the CUDA-core kernel), which no se3ete2 pair launches
K6_FIRST_KERNEL = "eq_stats_kernel"
# K16's ws form, which takes the 5 self layers of a se3ete2 serve_femb pair
# (rpe_attention_femb_ws_kernel<AH, 32>), and its first design there
# (rpe_attention_core.cuh's CUDA-core kernel), which no such pair launches
K16_WS_KERNEL, K16_FIRST_KERNEL = "rpe_attention_femb_ws_kernel", "rpe_attention_kernel"
# K12's tc48 form, which takes se3ete2's two stage-2 convs (H 36) a pair,
# and its first design, which no se3ete2 pair launches
K12_TC48_KERNEL, K12_FIRST_KERNEL = "gather_wf_mm_tc48_kernel", "gather_wf_mm_kernel"
SE3ETE2_K12_TC48_LAUNCHES = 2
# phase 10: the wide-head family trained.  Launches per se3ete2 training
# step, read from the code as TRAIN_LAUNCHES (the same blocks at half the
# channels): 10 gathering convs (K1 in float32, K8), 3 strided skips (K2,
# K9), one embedding (K3, K10 on its tc form at C 128), one Sinkhorn, 5 self
# layers (K5 / K11: 2 at AH = 24 with the SH term, 3 at AH = 4; at head
# width 32 K5 on its ws form with the row log-sum-exp, K11 on its tc form
# with 32's plan); the EQ cross layers are materialised
SE3ETE2_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES}
# and of the backward kernels per se3eti2 step: three self_eq layers (K11 at
# AH = 24 without the SH term)
SE3ETI2_TRAIN_BWD_LAUNCHES = {"gather_wf_bwd": 10, "neighbor_max_bwd": 3,
                              "geometric_embedding_bwd": 1, "rpe_attention_bwd": 3}
# se3ete2's training shapes of K8 and of the float32 K1 in K8_SHAPES' layout
# (A*C of the conv's input at the family's widths, half se3ete's), and the
# A*C of its three strided skips (K9)
SE3ETE2_K8_SHAPES = (("stage-0 same", "neighbors_0", 0, 96, 1),
                     ("s0 -> s1", "subsampling_0", 0, 96, 1),
                     ("stage-1 same", "neighbors_1", 1, 192, 2),
                     ("s1 -> s2", "subsampling_1", 1, 192, 1),
                     ("stage-2 same", "neighbors_2", 2, 384, 2),
                     ("s2 -> s3", "subsampling_2", 2, 384, 1),
                     ("stage-3 same", "neighbors_3", 3, 768, 2))
SE3ETE2_SKIP_AC = (6 * 64, 6 * 128, 6 * 256)
# K11's first design's device kernel (float32; in bf16 timed beside the tc
# form, never in a training step)
K11_FIRST_KERNEL = "rpe_attention_bwd_kernel"
# trainval on se3eti2: steps an epoch (and validation pairs), test pairs
TRAINVAL_STEPS, TRAINVAL_TEST_PAIRS = 2, 2
T_START = time.perf_counter()


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _print_check(res):
    lib = "none" if res.library_ms is None else f"{res.library_ms:.4f} ms"
    route = "" if res.route_ms is None else f", unfused route {res.route_ms:.4f} ms"
    if res.two_calls_ms is not None:
        route += f", two PyTorch calls {res.two_calls_ms:.4f} ms"
    print(f"kernel {res.name}: {res.shape} max_abs_err={res.max_abs_err:.3e} "
          f"(tol {res.tol:.3e}) kernel {res.ms:.4f} ms, plain {res.plain_ms:.4f} ms, "
          f"bound {res.bound_ms:.4f} ms ({res.bound_by}), library {lib}{route}", flush=True)


def _tiny_card_vs_cpu(name, cfg, num_points, extent, dev, host_influence=True):
    """One tiny pair (without host influence unless ``host_influence``)
    through the CPU (plain versions) and the card (kernels) in float32;
    returns the launches the card run made.  Checked within
    1e-3: the transformer's coarse features on valid rows and the matching
    scores on valid entries.  The transform by
    ``selfcheck.registration_agreement``: the registration is discontinuous
    in its scores (top-k picks, inlier masks; on the 600-point flash input
    noise of 1e-5 on the scores moves the transform by 1.3e-3 on the CPU),
    so it is held within 1e-3 only where both runs make the same decisions
    and their inliers determine the fit, and otherwise must be a proper
    rigid transform aligning the CPU run's inliers within the acceptance
    radius."""
    import torch

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    tiny = synthetic_pair(0, cfg.pipeline, cfg.model if host_influence else None, num_points,
                          extent)
    model = SE3ETModel(cfg.model, seed=0, device="cpu")
    want = model(pyramid_to_tensors(tiny, "cpu"))
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    got = model.to(dev)(pyramid_to_tensors(tiny, dev))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    coarse = torch.from_numpy(tiny[f"masks_{cfg.pipeline.num_stages - 1}"])
    f_err = max(float((got[k].cpu() - want[k])[coarse[i]].abs().max())
                for i, k in enumerate(("ref_feats_c", "src_feats_c")))
    s_valid = torch.isfinite(want["matching_scores"]) & (want["matching_scores"] > -1e6)
    s_err = float((got["matching_scores"].cpu() - want["matching_scores"])[s_valid].abs().max())
    t_ok, t_text = selfcheck.registration_agreement(
        {k: v.cpu() for k, v in got.items() if torch.is_tensor(v)}, want,
        cfg.model.acceptance_radius)
    print(f"tiny fp32 card vs cpu ({name}): |d coarse feats| {f_err:.2e} (tol 1e-3), "
          f"|d matching_scores| {s_err:.2e} (tol 1e-3), transform: {t_text}; "
          f"launches {launches}", flush=True)
    if not (f_err <= 1e-3 and s_err <= 1e-3 and t_ok):
        raise RuntimeError(f"kernel path and plain path disagree on the tiny {name} input")
    idle = [n for n in ("gather_wf_mm", "gather_wf_max_mm") if launches[n] == 0]
    if idle:
        raise RuntimeError(f"tiny {name} run did not take the fused convs: {idle}")
    return launches


def _profile(run, what="one pair", top=15, also=()):
    """Device time by kernel over one call of ``run`` (torch.profiler),
    against its wall time: the ``top`` kernels, then any other whose name
    holds a string of ``also``.  Returns {"wall", "kernels", "idle",
    "counts": {kernel name: launches}}, or None where the profiler recorded
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # kernels (device-side events) only: operator rows would count them
    # twice, and the device-side spans of user annotations and profiler
    # ranges (``Optimizer.step#AdamW.step``: its kernels and the host's gaps
    # between them) are not kernels; such a span is marked as one, or has a
    # host-side event of the same name
    rows = prof.key_averages()
    host = {e.key for e in rows if e.device_type != DeviceType.CUDA}
    device = [e for e in rows if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if getattr(e, "is_user_annotation", False) or e.key in host]
    events = [e for e in device if not any(e is r for r in spans)]
    if not events:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return None
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    device_ms = sum(getattr(e, attr) for e in events) / 1e3
    print(f"profile ({what}, profiler on): wall {wall:.2f} ms, kernels {device_ms:.2f} ms, "
          f"device idle {max(0.0, 1 - device_ms / wall):.1%}", flush=True)
    print("  device-side ranges, not kernels (left out of the sum and the idle share): "
          + (", ".join(f"{e.key[:60]} {getattr(e, attr) / 1e3:.3f} ms" for e in spans)
             or "none"), flush=True)
    ranked = sorted(events, key=lambda e: getattr(e, attr), reverse=True)
    for i, e in enumerate(ranked):
        if i < top or any(a in e.key for a in also):
            print(f"  {getattr(e, attr) / 1e3:8.3f} ms  {e.count:5d} launches  "
                  f"{getattr(e, attr) / 1e3 / max(e.count, 1):.4f} ms each  {e.key[:90]}",
                  flush=True)
    return {"wall": wall, "kernels": device_ms, "idle": max(0.0, 1 - device_ms / wall),
            "counts": {e.key: e.count for e in events},
            "ms": {e.key: getattr(e, attr) / 1e3 for e in events}}


def _tiny_train_card_vs_cpu(cfg, extent, dev):
    """One tiny float32 training step (``tiny_flash_config`` with the
    training routes on) through ``make_train_step`` on the CPU (plain
    versions) and on the card (kernels), same weights and Gumbel target
    noise.  Gated: the losses within rtol 1e-3, and every parameter's
    gradient within 5e-2 of its norm + 5e-5 (1e-2 over all of them): the
    bf16 embedding differs by an ulp between K3 and its plain version, which
    moves ReLU / max kinks downstream (the same tolerance the CPU tests
    state against the JAX step)."""
    import numpy as np
    import torch

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import make_optimizer
    from se3et_tpu_torch.experiments.configs import tiny_flash_config
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    tiny = tiny_flash_config(cfg)
    mcfg = dataclasses.replace(tiny.model, train_fused_conv=True, train_fused_embedding=True,
                               train_fused_attention=True)
    data = synthetic_pair(0, tiny.pipeline, mcfg, 600, extent)
    n_coarse = data[f"points_{tiny.pipeline.num_stages - 1}"].shape[1]
    noise = torch.from_numpy(np.random.RandomState(11).gumbel(
        size=(n_coarse, n_coarse)).astype(np.float32))
    runs = {}
    for where in ("cpu", dev):
        model = SE3ETModel(mcfg, seed=5, device=where)
        step = make_train_step(model, tiny.loss, make_optimizer(model.parameters(),
                                                                tiny.optim, 10))
        for w in selfcheck.WRAPPERS.values():
            w.launches = 0
        losses = step(pyramid_to_tensors(data, where), target_noise=noise.to(where))
        runs[str(where)] = (
            {k: float(v) for k, v in losses.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: w.launches for n, w in selfcheck.WRAPPERS.items()})
    (want_l, want_g, _), (got_l, got_g, launches) = runs["cpu"], runs[str(dev)]
    l_err = max(abs(got_l[k] - want_l[k]) / max(abs(want_l[k]), 1e-30)
                for k in ("c_loss", "f_loss", "loss"))
    errs = {n: (float(torch.linalg.norm(got_g[n] - w)), float(torch.linalg.norm(w)))
            for n, w in want_g.items()}
    worst = max(errs, key=lambda n: errs[n][0] / (5e-2 * errs[n][1] + 5e-5))
    tot = (sum(e * e for e, _ in errs.values()) ** 0.5,
           sum(r * r for _, r in errs.values()) ** 0.5)
    print(f"tiny fp32 training step card vs cpu: losses {got_l} vs {want_l} (max rel "
          f"{l_err:.2e}, tol 1e-3); gradients |dg|/|g| over all {tot[0] / tot[1]:.2e} "
          f"(tol 1e-2), worst tensor {worst} |dg| {errs[worst][0]:.3e} |g| "
          f"{errs[worst][1]:.3e}; launches {launches}", flush=True)
    bad = [n for n, (e, r) in errs.items() if not e <= 5e-2 * r + 5e-5]
    if not (l_err <= 1e-3 and tot[0] <= 1e-2 * tot[1]) or bad:
        raise RuntimeError(f"training step: card and CPU disagree ({bad})")
    idle = [n for n in selfcheck.TRAINING if launches[n] == 0]
    if idle:
        raise RuntimeError(f"tiny training step did not launch {idle}")


def _training(cfg, pairs, extent, dev):
    """Phase 6 on ``cfg``, the serving cut, which trains on the JAX training
    routes; returns the backward kernels' check results."""
    import torch

    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import make_optimizer
    from se3et_tpu_torch.nn.loss import overall_loss
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    m = cfg.model
    p0 = pyramid_to_tensors(pairs[0], dev)
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    heads, head_dim = m.num_heads, m.gt_hidden_dim // m.num_heads
    # K8 at each training shape on pair 0's neighbour sets, beside its first
    # design (bit for bit, and its times in this run)
    k8 = [(what, launches, selfcheck.check_gather_wf_bwd(
        p0[key], p0[f"points_{src}"].shape[1], ac, device_kernel=K8_KERNEL, first=True))
        for what, key, src, ac, launches in K8_SHAPES]
    if sum(n for _, n, _ in k8) != TRAIN_LAUNCHES["gather_wf_bwd"]:
        raise RuntimeError("K8_SHAPES does not cover the step's K8 launches")
    # K1 in float32 (its rows form) at the same ten convs, beside its first
    # design (bit for bit, and its times in this run)
    k1 = [(what, launches, selfcheck.check_gather_wf(
        p0[key], p0[f"points_{src}"].shape[1], ac, dtype=torch.float32,
        device_kernel=K1_F32_KERNEL, first=True))
        for what, key, src, ac, launches in K1_F32_SHAPES]
    if sum(n for _, n, _ in k1) != TRAIN_LAUNCHES["gather_wf"]:
        raise RuntimeError("K1_F32_SHAPES does not cover the step's K1 launches")
    # K9 at the three strided skips: x (2, Ns, A*128 << i) over stage i's
    # points, beside its first design (bit for bit, and its times in this run)
    k9 = [selfcheck.check_neighbor_max_bwd(p0[f"subsampling_{i}"],
                                           p0[f"points_{i}"].shape[1], 6 * 128 << i,
                                           device_kernel="max_bwd_", first=True)
          for i in range(3)]
    checks = {
        # stage-0 bottleneck conv: x (2, 20000, A*32), K = 15
        "gather_wf_bwd": k8[0][2],
        # its forward in float32, K1's rows form
        "gather_wf (float32)": k1[0][2],
        # stage-1 strided skip: x (2, 20000, A*128)
        "neighbor_max_bwd": k9[0],
        # the bf16 cotangent of training's bf16 embedding (its tc form)
        "geometric_embedding_bwd": selfcheck.check_embedding_bwd(
            pts_c, masks_c, c=m.gt_hidden_dim, k=m.angle_k, sigma_d=m.sigma_d,
            sigma_a=m.sigma_a, device_kernel=K10_KERNEL, first=True),
        # self_eq layers (A*H anchor-heads with the SH term); training feeds
        # K5/K11 the embedding's dtype, bf16
        "rpe_attention_bwd": selfcheck.check_rpe_attention_bwd(
            pts_c, masks_c, m.kanchor * heads, c=head_dim, cc=m.gt_hidden_dim,
            device_kernel=K11_KERNEL, first=True),
    }
    extra = [selfcheck.check_rpe_attention_bwd(pts_c, masks_c, heads, c=head_dim,
                                               cc=m.gt_hidden_dim, with_sh=False,
                                               device_kernel=K11_KERNEL, first=True)]
    extra += k9[1:]
    for res in list(checks.values()) + extra + [r for _, _, r in k8[1:] + k1[1:]]:
        _print_check(res)
    # K8 ("tiles") at the seven shapes: events and device ms beside the first
    # design in this run, the bound, the share of it and the re-read factor
    for what, launches, res in k8:
        print(f"K8 {what} (x {launches} a step) {res.shape}: events {res.ms:.4f} ms (first "
              f"design in this run {_ms(res.first_ms)}"
              + (f", before the redesign {K8_BEFORE:.4f}" if what == "stage-0 same" else "")
              + f"), device: the kernel {_ms(res.device_ms)} ms, the whole call "
              f"{_ms(res.call_device_ms)} ms, the first design's call "
              f"{_ms(res.first_device_ms)} ms; bound {res.bound_ms:.4f} ms ({res.bound_by}), "
              f"{res.bound_ms / res.ms:.1%} of it by events; re-read factor {res.reread:.3f}; "
              f"bit for bit against the first design and itself: {res.bitwise}; tile plan "
              f"from the reverse index {_ms(res.plan_ms)} ms, equal to its plain version: "
              f"{res.plan_ok}", flush=True)
    per_step = {name: sum(n * v for _, n, v in vals) for name, vals in (
        ("events", [(w, n, r.ms) for w, n, r in k8]),
        ("first design events", [(w, n, r.first_ms) for w, n, r in k8]),
        ("device", [(w, n, r.device_ms or math.nan) for w, n, r in k8]),
        ("first design device", [(w, n, r.first_device_ms or math.nan) for w, n, r in k8]),
        ("bound", [(w, n, r.bound_ms) for w, n, r in k8]))}
    # one plan a neighbour set a step (its convs share it)
    per_step["tile plans (7 sets)"] = sum(r.plan_ms or math.nan for _, _, r in k8)
    print("K8 per step (10 launches, ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items()) + " (predicted: stage-0 call 0.22-0.30 "
        "ms by events, 1.5-2.3 device ms a step)", flush=True)
    if any(r.form != "tiles" for _, _, r in k8):
        raise RuntimeError(f"K8 took another form than tiles at a training shape: "
                           f"{[(w, r.form) for w, _, r in k8 if r.form != 'tiles']}")
    if not all(r.bitwise and r.ok for _, _, r in k8):
        raise RuntimeError(f"K8 differs from its first design or its plain version: "
                           f"{[w for w, _, r in k8 if not (r.bitwise and r.ok)]}")
    # K1 in float32 ("rows") at the seven shapes, the same way
    for what, launches, res in k1:
        print(f"K1 float32 {what} (x {launches} a step) {res.shape}: events {res.ms:.4f} ms "
              f"(first design in this run {_ms(res.first_ms)}), device: the kernel "
              f"{_ms(res.device_ms)} ms, the first design's {_ms(res.first_device_ms)} ms; "
              f"bound {res.bound_ms:.4f} ms ({res.bound_by}), {res.bound_ms / res.ms:.1%} of it "
              f"by events; bit for bit against the first design and itself: {res.bitwise}; "
              f"embedding_bag sum {_ms(res.library_ms)} ms", flush=True)
    per_step = {name: sum(n * v for _, n, v in vals) for name, vals in (
        ("events", [(w, n, r.ms) for w, n, r in k1]),
        ("first design events", [(w, n, r.first_ms) for w, n, r in k1]),
        ("device", [(w, n, r.device_ms or math.nan) for w, n, r in k1]),
        ("first design device", [(w, n, r.first_device_ms or math.nan) for w, n, r in k1]),
        ("bound", [(w, n, r.bound_ms) for w, n, r in k1]))}
    print("K1 float32 per step (10 launches, ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items())
        + f" (before the redesign {10 * K1_F32_BEFORE:.4f} device)", flush=True)
    if any(r.form != "rows" for _, _, r in k1):
        raise RuntimeError(f"K1 took another form than rows at a float32 training shape: "
                           f"{[(w, r.form) for w, _, r in k1 if r.form != 'rows']}")
    if not all(r.bitwise and r.ok for _, _, r in k1):
        raise RuntimeError(f"K1 (float32) differs from its first design or its plain version: "
                           f"{[w for w, _, r in k1 if not (r.bitwise and r.ok)]}")
    # K11 at both training shapes beside its first design: its times before
    # the redesign (NVIDIA H100 80GB HBM3, 700 W: 19.7523 / 9.3540 ms by
    # events, 6.1515 device ms of the self_eq kernel) and in this run
    for res, before in ((checks["rpe_attention_bwd"], 19.7523), (extra[0], 9.3540)):
        print(f"K11 {res.shape}: events {res.ms:.4f} ms (first design {before:.4f}; in this "
              f"run {_ms(res.first_ms)}), device: the kernel {_ms(res.device_ms)} ms, the "
              f"whole call {_ms(res.call_device_ms)} ms, the first design's kernel "
              f"{_ms(res.first_device_ms)} ms; bound {res.bound_ms:.4f} ms ({res.bound_by})",
              flush=True)
    # K10 beside its first design, before the redesign and in this run
    res = checks["geometric_embedding_bwd"]
    print(f"K10 {res.shape}: events {res.ms:.4f} ms (before the redesign {K10_BEFORE[0]:.4f}; "
          f"first design in this run {_ms(res.first_ms)}), device: the kernel "
          f"{_ms(res.device_ms)} ms (before {K10_BEFORE[1]:.4f}; predicted 0.45-0.9), the "
          f"whole call {_ms(res.call_device_ms)} ms, the first design's kernel "
          f"{_ms(res.first_device_ms)} ms; bound {res.bound_ms:.4f} ms ({res.bound_by})",
          flush=True)
    # K9 ("tiles") at the three skips: events and device ms beside the first
    # design before the redesign and in this run, the bound and the share of it
    for i, res in enumerate(k9):
        print(f"K9 s{i} -> s{i + 1} (x 1 a step) {res.shape}: events {res.ms:.4f} ms (first "
              f"design before the redesign {K9_BEFORE[0][i]:.4f}, in this run "
              f"{_ms(res.first_ms)}), device: the two kernels {_ms(res.device_ms)} ms, the "
              f"whole call {_ms(res.call_device_ms)} ms, the first design's call "
              f"{_ms(res.first_device_ms)} ms; bound {res.bound_ms:.4f} ms ({res.bound_by}), "
              f"{res.bound_ms / res.ms:.1%} of it by events; re-read factor {res.reread:.3f}; "
              f"bit for bit against the first design and itself: {res.bitwise}", flush=True)
    per_step = {name: sum(vals) for name, vals in (
        ("events", [r.ms for r in k9]), ("first design events", [r.first_ms for r in k9]),
        ("device", [r.device_ms or math.nan for r in k9]),
        ("first design device", [r.first_device_ms or math.nan for r in k9]),
        ("bound", [r.bound_ms for r in k9]))}
    print("K9 per step (3 launches, ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items())
        + f" (before the redesign {3 * K9_BEFORE[1]:.4f} device; predicted 0.19-0.33 ms a "
        "launch by events, 0.6-0.9 device ms a step)", flush=True)
    if any(r.form != "tiles" for r in k9):
        raise RuntimeError(f"K9 took another form than tiles at a training skip: "
                           f"{[r.shape for r in k9 if r.form != 'tiles']}")
    if not all(r.bitwise and r.ok for r in k9):
        raise RuntimeError(f"K9 differs from its first design or its plain version: "
                           f"{[r.shape for r in k9 if not (r.bitwise and r.ok)]}")
    bad = [r.name for r in list(checks.values()) + extra if not r.ok]
    if bad:
        raise RuntimeError(f"training kernels disagree with their plain versions: {bad}")
    del p0

    _tiny_train_card_vs_cpu(cfg, extent, dev)

    # full width: make_train_step on the synthetic pairs
    model = SE3ETModel(m, seed=cfg.seed)
    step = make_train_step(model, cfg.loss, make_optimizer(model.parameters(), cfg.optim,
                                                            len(pairs)))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    step(inputs[-1], generator=gen)  # warm-up
    torch.cuda.synchronize()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(inputs[i % len(inputs)], generator=gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    vals = [{k: float(v) for k, v in ls.items()} for ls in losses]
    if not all(math.isfinite(x) for v in vals for x in v.values()):
        raise RuntimeError(f"non-finite training losses or gradient norm: {vals}")
    expected = {n: c * TRAIN_STEPS for n, c in TRAIN_LAUNCHES.items()}
    if any(launches[n] != c for n, c in expected.items()):
        raise RuntimeError(f"training step launched {launches}, expected {expected}")
    for name in selfcheck.TRAINING:
        checks[name].launches = launches[name]
    checks["gather_wf (float32)"].launches = launches["gather_wf"]
    # forward + loss alone (the graph built, no backward), to split the step
    fwd_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(inputs[0], train=True, with_registration=False, generator=gen)
        overall_loss(out, inputs[0], cfg.loss)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    print(f"train forward + loss (no backward) ms: {[round(x, 2) for x in fwd_ms]} "
          f"(median {statistics.median(fwd_ms):.2f})", flush=True)
    print(f"train ms/step: {[round(x, 2) for x in step_ms]} (median "
          f"{statistics.median(step_ms):.2f}); losses {vals}; launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    # one step's profile, with the training kernels' device ms per launch;
    # K10's tc kernel must appear once, K8's tiles kernel and K1's rows
    # kernel 10 times each, K9's two tiles kernels 3 times each, and K1's
    # and K9's first designs never (a profile that lists one short is taken
    # once more)
    also = ("neighbor_max_rows_kernel", K11_KERNEL, K1_F32_FIRST_KERNEL) + K9_FIRST_KERNELS \
        + tuple(name for names, _ in STEP_KERNELS.values() for name in names)
    want = {K10_KERNEL: TRAIN_LAUNCHES["geometric_embedding_bwd"],
            K8_KERNEL: TRAIN_LAUNCHES["gather_wf_bwd"],
            K1_F32_KERNEL: TRAIN_LAUNCHES["gather_wf"], K1_F32_FIRST_KERNEL: 0,
            **dict.fromkeys(K9_KERNELS, TRAIN_LAUNCHES["neighbor_max_bwd"]),
            **dict.fromkeys(K9_FIRST_KERNELS, 0)}
    for _ in range(2):
        prof = _profile(lambda: step(inputs[0], generator=gen), what="one training step",
                        top=25, also=also)
        if prof is None:
            return checks
        seen = {name: sum(c for key, c in prof["counts"].items()
                          if re.search(rf"\b{name}\b", key))
                for name in want}
        if seen == want:
            break
    else:
        raise RuntimeError(f"the step profile lists {seen}, expected {want}")
    per_launch = {
        what: sum(ms for key, ms in prof["ms"].items()
                  if any(re.search(rf"\b{n}\b", key) for n in names)) / count
        for what, (names, count) in STEP_KERNELS.items()}
    print("step profile, device ms per launch: " + ", ".join(
        f"{what} {ms:.4f} (x {STEP_KERNELS[what][1]})" for what, ms in per_launch.items())
        + f"; K8 per step {per_launch['K8'] * STEP_KERNELS['K8'][1]:.4f} ms, K1 float32 per "
        f"step {per_launch['K1 (float32)'] * STEP_KERNELS['K1 (float32)'][1]:.4f} ms (before "
        f"the redesign {10 * K1_F32_BEFORE:.4f}), K9 per step "
        f"{per_launch['K9'] * STEP_KERNELS['K9'][1]:.4f} ms (before the redesign "
        f"{3 * K9_BEFORE[1]:.4f})", flush=True)
    return checks


def _serve_turns(routes, order, npairs):
    """Serve every pair on each route of ``order`` in turn (``routes``: name
    -> (model, inputs)); returns ({route: ms per pair}, {route: launches
    summed over its turns}).  Counters are set to 0 just before each turn
    and read just after it."""
    import torch

    from se3et_tpu_torch.ops.kernels import selfcheck

    ms = {r: [] for r in routes}
    launches = {r: dict.fromkeys(selfcheck.WRAPPERS, 0) for r in routes}
    for route in order:
        net, inputs = routes[route]
        for w in selfcheck.WRAPPERS.values():
            w.launches = 0
        for td in inputs[:npairs]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(td)
            torch.cuda.synchronize()
            ms[route].append((time.perf_counter() - t0) * 1e3)
            tf = out["estimated_transform"]
            if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
                raise RuntimeError(f"bad estimated_transform on the {route} route: {tf}")
        for n, w in selfcheck.WRAPPERS.items():
            launches[route][n] += w.launches
    return ms, launches


def _bits(t):
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def _require_bitwise(what, got, want):
    """Every output key of ``want`` in ``got`` with the same dtype, shape
    and bits (NaNs and signed zeros included)."""
    import torch

    differ = [k for k, v in want.items() if torch.is_tensor(v) and not (
        got[k].dtype == v.dtype and got[k].shape == v.shape
        and torch.equal(_bits(got[k]), _bits(v)))]
    if set(got) != set(want) or differ:
        raise RuntimeError(f"{what}: the replay differs from the eager forward in "
                           f"{differ or sorted(set(got) ^ set(want))}")


def _capture_checked(route, model, inputs, per_pair):
    """``capture_forward`` on pair 0 of ``inputs`` with every counter set to
    0 just before and read just after: the capture must record ``per_pair``
    launches (and the warm-up forwards as many each), then every pair's
    replay must equal the eager forward bit for bit.  Returns the captured
    forward."""
    import torch

    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.ops.kernels import selfcheck

    eager = [model(td) for td in inputs]
    warmup = 3
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    served = capture_forward(model, inputs[0], warmup=warmup)
    counted = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    want = dict.fromkeys(selfcheck.WRAPPERS, 0)
    want.update(per_pair)
    if served.launches != want or counted != {n: (warmup + 1) * c for n, c in want.items()}:
        raise RuntimeError(f"capture of the {route} route recorded {served.launches} "
                           f"(counted {counted}), expected {want} per pair")
    for i, td in enumerate(inputs):
        _require_bitwise(f"{route} route, pair {i}", served(td), eager[i])
    torch.cuda.synchronize()
    print(f"captured {route} route: {len(inputs)} pairs replayed, every output equal to the "
          f"eager forward bit for bit; capture {served.capture_ms:.1f} ms; launches recorded "
          f"at capture {dict((n, c) for n, c in served.launches.items() if c)}", flush=True)
    return served


def _captured(model, inputs, dev, eager_peak):
    """Phase 5's captured forward: checks, peak memory, turns, profile."""
    import torch

    from se3et_tpu_torch.ops.kernels import selfcheck

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    per_pair = dict.fromkeys(selfcheck.ROUTES, 0)
    per_pair.update(SERVING_LAUNCHES)
    served = _capture_checked("default", model, inputs, per_pair)
    peak = torch.cuda.max_memory_allocated(dev)
    gc.collect()
    held = torch.cuda.memory_allocated(dev) - resident
    print(f"captured default route: max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({(peak - resident) / 2**30:.2f} above the {resident / 2**30:.2f} GiB resident; "
          f"eager serving in this run {eager_peak / 2**30:.2f} GiB); the graph's static inputs "
          f"and outputs hold {held / 2**30:.2f} GiB; reserved "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB", flush=True)

    routes = {"eager": model, "captured": served}
    ms = {r: [] for r in routes}
    for route in ("eager", "captured", "captured", "eager"):
        load = os.getloadavg()
        turn = []
        for i in range(CAPTURED_TURN_PAIRS):
            td = inputs[i % len(inputs)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = routes[route](td)
            torch.cuda.synchronize()
            turn.append((time.perf_counter() - t0) * 1e3)
            tf = out["estimated_transform"]
            if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
                raise RuntimeError(f"bad estimated_transform on the {route} forward: {tf}")
        ms[route] += turn
        print(f"turn {route}: host load {[round(x, 2) for x in load]}; ms/pair "
              f"{[round(x, 2) for x in turn]}", flush=True)
    print("serve ms/pair in turns (eager, captured, captured, eager; "
          f"{CAPTURED_TURN_PAIRS} pairs each): " + "; ".join(
              f"{r} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f})"
              for r, v in ms.items()), flush=True)

    # every serving kernel in the replay's profile, with its count per pair
    # (a second profile where the first lists one short: a profile of an
    # eager pair once listed no K14 launch)
    for attempt in (1, 2):
        prof = _profile(lambda: served(inputs[0]), what="one replayed pair",
                        also=SERVING_KERNELS)
        if prof is None:
            raise RuntimeError("the profiler recorded no device time over a replay")
        seen = {n: sum(c for key, c in prof["counts"].items()
                       if re.search(rf"\b{k}\b", key))
                for n, k in SERVING_DEVICE_KERNELS.items()}
        short = {n: (seen[n], SERVING_LAUNCHES[n]) for n in seen if seen[n] != SERVING_LAUNCHES[n]}
        print(f"replay profile (attempt {attempt}): serving kernels {seen}", flush=True)
        if not short:
            break
    if short:
        raise RuntimeError(f"replayed pair's profile: kernels (listed, expected) {short}")
    return served


def _require_launches(route, launches, per_pair, pairs_served):
    want = {n: c * pairs_served for n, c in per_pair.items()}
    got = {n: launches[n] for n in want}
    if got != want:
        raise RuntimeError(f"the {route} route launched {got}, expected {want}")


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def _captured_femb(model, femb, inputs, dev):
    """Phase 7's captured routes: the default and the femb route each
    captured (launch counts at capture, every replay equal to eager bit for
    bit), with the peak memory above the resident over its checks and
    capture, then served in turns (default, femb, femb, default; 8 pairs
    each, host load printed before each turn)."""
    import torch

    from se3et_tpu_torch.ops.kernels import selfcheck

    served, peak = {}, {}
    for route, net in (("default", model), ("femb", femb)):
        per_pair = dict.fromkeys(selfcheck.ROUTES, 0)
        per_pair.update(SERVING_LAUNCHES)
        if route == "femb":
            per_pair.update(FEMB_LAUNCHES)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        served[route] = _capture_checked(route, net, inputs, per_pair)
        peak[route] = (torch.cuda.max_memory_allocated(dev) - resident) / 2**30
    ms = _captured_turns({r: (fn, inputs) for r, fn in served.items()},
                         ("default", "femb", "femb", "default"))
    print("serve ms/pair in turns (captured default, femb, femb, default; "
          f"{CAPTURED_TURN_PAIRS} pairs each): " + "; ".join(
              f"{r} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f}), "
              f"peak {peak[r]:.2f} GiB above the resident over its checks and capture"
              for r, v in ms.items()), flush=True)


def _captured_turns(served, order):
    """Serve ``CAPTURED_TURN_PAIRS`` pairs on each captured route of
    ``order`` in turn (``served``: route -> (captured forward, inputs)),
    the host load printed before each turn; returns {route: ms per pair}."""
    import torch

    ms = {r: [] for r in served}
    for route in order:
        fn, inputs = served[route]
        load = os.getloadavg()
        turn = []
        for i in range(CAPTURED_TURN_PAIRS):
            td = inputs[i % len(inputs)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(td)
            torch.cuda.synchronize()
            turn.append((time.perf_counter() - t0) * 1e3)
            tf = out["estimated_transform"]
            if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
                raise RuntimeError(f"bad estimated_transform on the captured {route} route: {tf}")
        ms[route] += turn
        print(f"turn captured {route}: host load {[round(x, 2) for x in load]}; ms/pair "
              f"{[round(x, 2) for x in turn]}", flush=True)
    return ms


def _captured_device_influence(model, inputs, bare):
    """Phase 7's captured device-influence route: it and the default route
    captured (launch counts at capture, every replay equal to eager bit for
    bit; K15 inside the graph), then served in turns (default, device
    influence, device influence, default; 8 pairs each)."""
    from se3et_tpu_torch.ops.kernels import selfcheck

    per_pair = dict.fromkeys(selfcheck.ROUTES, 0)
    per_pair.update(SERVING_LAUNCHES)
    served = {"default": (_capture_checked("default", model, inputs, per_pair), inputs)}
    per_pair.update(DEVICE_INFLUENCE_LAUNCHES)
    served["device influence"] = (_capture_checked("device-influence", model, bare, per_pair),
                                  bare)
    ms = _captured_turns(served, ("default", "device influence", "device influence",
                                  "default"))
    print("serve ms/pair in turns (captured default, device influence, device influence, "
          f"default; {CAPTURED_TURN_PAIRS} pairs each): " + "; ".join(
              f"{r} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f})"
              for r, v in ms.items()), flush=True)


def _influence_sets(num_stages):
    """The (stage, neighbour set) pairs whose influence a device-influence
    pair computes, in the backbone's order (``nn/epn.py`` ``forward``):
    (label, query points, source points, neighbours, radius and sigma
    multiple of the stage-0 ones)."""
    sets = [("stage-0 same", "points_0", "points_0", "neighbors_0", 1)]
    for st in range(1, num_stages):
        mult = 2 ** (st - 1)
        sets += [(f"s{st - 1} -> s{st}", f"points_{st}", f"points_{st - 1}",
                  f"subsampling_{st - 1}", mult),
                 (f"stage-{st} same", f"points_{st}", f"points_{st}", f"neighbors_{st}",
                  2 * mult)]
    return sets


def _print_k15(k15):
    """K15's tiles form at each set beside its first design in this run, and
    the sums over a pair (one launch a set).  Events time the wrapper call
    (the host's, at the small sets); replayed ms, the calls replayed from a
    CUDA graph, time the device as the captured route runs it; the
    profiler's device ms are printed too, but its later sessions in a
    process lose kernels (PERF.md, lessons), so they run low here."""
    for label, res in k15:
        print(f"K15 {label} {res.shape}: replayed {res.replay_ms:.4f} ms (first design "
              f"{res.first_replay_ms:.4f}); events {res.ms:.4f} ms ({res.first_ms:.4f}); "
              f"profiler device {_ms(res.device_ms)} ms ({_ms(res.first_device_ms)}); bound "
              f"{res.bound_ms:.4f} ms ({res.bound_by}), {res.bound_ms / res.replay_ms:.1%} of it "
              f"replayed; both outputs bit for bit the first design's: {res.bitwise}",
              flush=True)
    rows = [r for _, r in k15]

    def total(attr):
        vals = [getattr(r, attr) for r in rows]
        return None if None in vals else sum(vals)

    print(f"K15 per device-influence pair ({len(rows)} launches): replayed "
          f"{total('replay_ms'):.4f} ms (first design in this run {total('first_replay_ms'):.4f};"
          f" device before the redesign {K15_BEFORE[1]:.4f}); events {_ms(total('ms'))} ms "
          f"({_ms(total('first_ms'))}); profiler device {_ms(total('device_ms'))} ms "
          f"({_ms(total('first_device_ms'))}); bound {total('bound_ms'):.4f} ms", flush=True)
    rows = rows[-4:]
    print(f"K15 at the four sets below 0.002 ms of bound: replayed {total('replay_ms'):.4f} ms "
          f"(first design {total('first_replay_ms'):.4f}), bound {total('bound_ms'):.4f} ms",
          flush=True)


def _routes(cfg, pairs, bare_pairs, extent, dev, k5):
    """Phase 7: K15 and K16 checked against their plain versions (K15 at
    the seven sets of pair 0 beside its first design; K16 beside its first
    design's times and ``k5``, K5's phase-3 checks at the same two shapes),
    tiny card-vs-CPU runs of both routes, both routes served at full width
    in turns with the default route, both captured and served in turns
    with the captured default route, and ``entry()``; returns the
    checks."""
    import torch

    from se3et_tpu_torch.data.influence import _kernel_points_for
    from se3et_tpu_torch.entry import entry
    from se3et_tpu_torch.experiments.configs import tiny_flash_config
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    m = cfg.model
    p0 = pyramid_to_tensors(bare_pairs[0], dev)
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    heads, head_dim = m.num_heads, m.gt_hidden_dim // m.num_heads
    emb_kw = dict(c=head_dim, cc=m.gt_hidden_dim, k=m.angle_k, sigma_d=m.sigma_d,
                  sigma_a=m.sigma_a)
    # K15 at the seven (stage, neighbour set) pairs of pair 0, in the
    # backbone's order and radius / sigma schedule, beside its first design
    k15 = [(label, selfcheck.check_influence(
        p0[q], p0[s], p0[nbr], _kernel_points_for(m, m.init_radius * mult),
        m.init_sigma * mult, mode=m.epn.kp_influence, reps=20, device_kernel=K15_KERNEL,
        first=True, replay=True))
        for label, q, s, nbr, mult in _influence_sets(cfg.pipeline.num_stages)]
    checks = {
        "influence": k15[0][1],
        # self_eq layers: A*H anchor-heads with the SH term
        "rpe_self_attention_femb": selfcheck.check_rpe_attention_femb(
            pts_c, masks_c, m.kanchor * heads, reps=10,
            device_kernel="rpe_attention_femb_ws_kernel", **emb_kw),
    }
    extra = [res for _, res in k15[1:]] + [
        # plain self layers: H heads, no SH term
        selfcheck.check_rpe_attention_femb(pts_c, masks_c, heads, with_sh=False, reps=10,
                                           device_kernel="rpe_attention_femb_ws_kernel",
                                           **emb_kw),
    ]
    for res in list(checks.values()) + extra:
        _print_check(res)
    _print_k15(k15)
    # K16 beside its first design's times (NVIDIA H100 80GB HBM3, 700 W: by
    # events 1.6898 / 0.7501 ms, device 1.6046 / 0.6943) and K5's at the
    # same shapes in this run, with their totals per served pair (2 self_eq
    # and 3 plain self launches)
    k16 = [(2, checks["rpe_self_attention_femb"], (1.6898, 1.6046), k5[0]),
           (3, extra[-1], (0.7501, 0.6943), k5[1])]
    for _, res, first, k5res in k16:
        print(f"K16 {res.shape}: events {res.ms:.4f} ms (first design {first[0]:.4f}), device "
              f"{_ms(res.device_ms)} ms ({first[1]:.4f}); K5 at this shape: events "
              f"{k5res.ms:.4f} ms, device {_ms(k5res.device_ms)} ms; bound {res.bound_ms:.4f} "
              f"ms ({res.bound_by})", flush=True)
    per_pair = {who: [sum(n * getattr(r, attr) for n, r in rows)
                      if all(getattr(r, attr) is not None for _, r in rows) else None
                      for attr in ("ms", "device_ms")]
                for who, rows in (("K16", [(n, r) for n, r, _, _ in k16]),
                                  ("K5", [(n, r) for n, _, _, r in k16]))}
    print(f"K16 per served pair (5 launches): events {_ms(per_pair['K16'][0])} ms, device "
          f"{_ms(per_pair['K16'][1])} ms (first design 5.2907 device); K5 events "
          f"{_ms(per_pair['K5'][0])}, device {_ms(per_pair['K5'][1])} ms", flush=True)
    bad = [r.name for r in list(checks.values()) + extra if not r.ok]
    bad += [f"influence {label} (form {r.form}, bit for bit {r.bitwise})" for label, r in k15
            if r.form != "tiles" or not r.bitwise]
    if bad:
        raise RuntimeError(f"route kernels disagree with their plain versions or first "
                           f"designs: {bad}")
    del p0

    tiny = tiny_flash_config(cfg)
    femb_tiny = dataclasses.replace(tiny, model=dataclasses.replace(tiny.model, serve_femb=True))
    launches = _tiny_card_vs_cpu("flash, serve_femb", femb_tiny, 600, extent, dev)
    _require_launches("tiny femb", launches, FEMB_LAUNCHES, 1)
    launches = _tiny_card_vs_cpu("flash, device influence", tiny, 600, extent, dev,
                                 host_influence=False)
    _require_launches("tiny device-influence", launches, DEVICE_INFLUENCE_LAUNCHES, 1)

    # full width: the same weights on the default, device-influence and
    # femb routes (what training left behind collected first)
    gc.collect()
    torch.cuda.empty_cache()
    model = SE3ETModel(m, seed=cfg.seed).eval()
    femb = SE3ETModel(dataclasses.replace(m, serve_femb=True), seed=cfg.seed).eval()
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    bare = [pyramid_to_tensors(p, dev) for p in bare_pairs]
    routes = {"default": (model, inputs), "device influence": (model, bare),
              "femb": (femb, inputs)}
    _serve_turns(routes, ("default", "device influence", "femb"), NUM_PAIRS)  # warm-up
    tiles0 = selfcheck.WRAPPERS["influence"].tiles_launches
    ms, launches = _serve_turns(routes, ("default", "device influence", "device influence",
                                         "default"), NUM_PAIRS)
    _require_launches("device-influence", launches["device influence"],
                      DEVICE_INFLUENCE_LAUNCHES, 2 * NUM_PAIRS)
    if launches["default"]["influence"]:
        raise RuntimeError("the default route (host influence) launched K15")
    tiles = selfcheck.WRAPPERS["influence"].tiles_launches - tiles0
    if tiles != launches["device influence"]["influence"]:
        raise RuntimeError(f"the device-influence route launched K15 {tiles} times on its "
                           f"tiles form of {launches['device influence']['influence']}")
    checks["influence"].launches = launches["device influence"]["influence"] // 2
    print("serve ms/pair in turns (device influence): " + "; ".join(
        f"{r} {[round(x, 2) for x in ms[r]]} (median {statistics.median(ms[r]):.2f})"
        for r in ("default", "device influence")) + f"; K15 launches {tiles} over "
        f"{2 * NUM_PAIRS} pairs, every one on its tiles form", flush=True)
    a = model(inputs[0], stop_after="backbone")
    b = model(bare[0], stop_after="backbone")
    mask = inputs[0]["masks_3"]
    d = float((a["feats_c"] - b["feats_c"])[mask].abs().max()) / float(
        a["feats_c"][mask].abs().max())
    print(f"backbone feats_c, device vs host influence (pair 0, valid rows, bf16): "
          f"max|diff| / max|host| = {d:.3e}", flush=True)
    prof = _profile(lambda: model(bare[0]), what="one pair, device-influence route", top=40,
                    also=(K15_KERNEL, K15_FIRST_KERNEL))
    if prof is not None:
        seen = {k: sum(c for key, c in prof["counts"].items() if re.search(rf"\b{k}\b", key))
                for k in (K15_KERNEL, K15_FIRST_KERNEL)}
        print(f"K15 device kernels in the profiled pair: {seen}", flush=True)
    _captured_device_influence(model, inputs, bare)
    del a, b, routes["device influence"], bare
    gc.collect()
    torch.cuda.empty_cache()

    ms, launches = _serve_turns(routes, ("default", "femb", "femb", "default"), NUM_PAIRS)
    _require_launches("femb", launches["femb"], FEMB_LAUNCHES, 2 * NUM_PAIRS)
    checks["rpe_self_attention_femb"].launches = \
        launches["femb"]["rpe_self_attention_femb"] // 2
    peak, resident = {}, {}
    for route in ("default", "femb"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident[route] = torch.cuda.memory_allocated(dev) / 2**30
        _serve_turns(routes, (route,), NUM_PAIRS)
        peak[route] = torch.cuda.max_memory_allocated(dev) / 2**30
    print("serve ms/pair in turns (femb): " + "; ".join(
        f"{r} {[round(x, 2) for x in ms[r]]} (median {statistics.median(ms[r]):.2f}), "
        f"max_memory_allocated {peak[r]:.2f} GiB ({peak[r] - resident[r]:.2f} above the "
        f"{resident[r]:.2f} GiB resident)" for r in ("default", "femb")), flush=True)
    a = model(inputs[0], stop_after="transformer")
    b = femb(inputs[0], stop_after="transformer")
    for i, key in enumerate(("ref_feats_c", "src_feats_c")):
        mask = inputs[0]["masks_3"][i]
        d = float((b[key] - a[key])[mask].abs().max()) / float(a[key][mask].abs().max())
        print(f"transformer {key}, femb vs default route (pair 0, valid rows, bf16): "
              f"max|diff| / max|default| = {d:.3e}", flush=True)
    del a, b
    _profile(lambda: femb(inputs[0]), what="one pair, femb route")
    _captured_femb(model, femb, inputs, dev)
    del model, femb, inputs, routes

    fn, (net, data) = entry()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    tiles0 = selfcheck.WRAPPERS["influence"].tiles_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(net, data)
    torch.cuda.synchronize()
    tf = out["estimated_transform"]
    scores = out["matching_scores"]
    top = float(scores[torch.isfinite(scores) & (scores > -1e6)].max())
    print(f"entry(): largest matching score {top:.4f}, estimated_transform\n"
          f"{tf.cpu().numpy()}", flush=True)
    if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
        raise RuntimeError(f"entry(): bad estimated_transform {tf}")
    tiles = selfcheck.WRAPPERS["influence"].tiles_launches - tiles0
    if selfcheck.WRAPPERS["influence"].launches != 7 or tiles != 7:
        raise RuntimeError(f"entry() did not compute the influence on the card's tiles form: "
                           f"{selfcheck.WRAPPERS['influence'].launches} K15 launches, {tiles} "
                           f"on its tiles form")
    print(f"entry(): {(time.perf_counter() - t0) * 1e3:.1f} ms (first call), "
          f"estimated_transform finite, K15 launches "
          f"{selfcheck.WRAPPERS['influence'].launches}, {tiles} on its tiles form", flush=True)
    return checks


def _remove(path):
    import shutil

    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def _tester_split(what, pairs, inputs, served, dev, eager=None):
    """The Tester's ms/pair split over the pairs twice: the copy-in of a
    host pyramid, and the replay of a pair already on the card (copy into
    the static buffers, replay, outputs cloned); with ``eager``, the eager
    eval forward beside them."""
    import torch

    from se3et_tpu_torch.nn.model import pyramid_to_tensors

    fns = {"copy-in": lambda p, td: pyramid_to_tensors(p, dev),
           "replay": lambda p, td: served(td)}
    if eager is not None:
        fns["eager"] = lambda p, td: eager(td)
    split = {k: [] for k in fns}
    for _ in range(2):
        for p, td in zip(pairs, inputs):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn(p, td)
                torch.cuda.synchronize()
                split[k].append((time.perf_counter() - t1) * 1e3)
    print(f"{what}: ms/pair over the {len(pairs)} pairs twice: " + "; ".join(
        f"{k} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f})"
        for k, v in split.items()), flush=True)


def _test_path(dev):
    """Phase 8: ``se3eti.3dmatch`` through the registry's test path at full
    width: ``runner.prepare_test`` (calibrated limits, seeded weights, the
    captured eval forward) and ``Tester.run`` over 4 synthetic pairs, as
    ``run_test`` drives them, with every counter set to 0 just before and
    read just after; an eager eval pair's counters against
    ``SE3ETI_LAUNCHES``; every output and metric of the replays bit for bit
    against the eager eval forward; the conv kernels at the shapes of pair
    0 (:func:`_conv_checks`); one more ``Tester.run`` at the
    registry's neighbour widths (``--no_calibrate``) on 2 pairs, timed; ``run_eval``
    (lgr, svd) over the dumps and ``run_demo`` on
    ``se3ete.3dmatch.evalrot``; K5 at the self_eq layers' shape without the
    SH term.  Returns {name: CheckResult}."""
    import torch

    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.experiments import configs, runner
    from se3et_tpu_torch.nn.model import pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import rpe_attention, selfcheck

    cfg = configs.make_cfg(TEST_EXPERIMENT)
    # from no calibration cache, no dumps and no snapshots of an earlier run
    for stale in ("neighbor_limits.json", "features", "snapshots"):
        _remove(os.path.join(cfg.output_dir, stale))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    tester, loader, benchmark = runner.prepare_test(cfg, ["--max_pairs", str(TEST_PAIRS)])
    setup_s = time.perf_counter() - t0
    pairs = []

    def kept():
        for data, meta in loader:
            pairs.append(dict(data))
            yield data, meta

    summary = tester.run(kept(), benchmark=benchmark)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0 - setup_s
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(cfg.output_dir, "neighbor_limits.json")) as f:
        limits = tuple(json.load(f))
    served = tester.captured
    sets = {k: v.shape[1:] for k, v in pairs[0].items()
            if k.startswith(("neighbors_", "subsampling_"))} if pairs else {}
    print(f"phase 8 {TEST_EXPERIMENT}: calibrated neighbor limits {limits}; (rows, H) of each "
          f"neighbour set {sets}; set-up (calibration, weights, model) {setup_s:.1f} s, "
          f"{len(pairs)} pairs served in {run_s:.1f} s", flush=True)
    if len(pairs) != TEST_PAIRS or served is None:
        raise RuntimeError(f"run_test served {len(pairs)} pairs, captured {served}")

    # an eager eval pair's counters: the table the run is held to
    eager = make_forward(tester.model, tester.eval_cfg)
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    want = [eager(td) for td in inputs[:1]]
    torch.cuda.synchronize()
    per_pair = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    print(f"phase 8: one eager eval pair launched {dict((n, c) for n, c in per_pair.items() if c)}",
          flush=True)
    table = dict.fromkeys(selfcheck.WRAPPERS, 0)
    table.update(SE3ETI_LAUNCHES)
    if per_pair != table:
        raise RuntimeError(f"an eager se3eti pair launched {per_pair}, expected {table}")
    # the run: the warm-up forwards and the capture count, replays do not
    runs = CAPTURE_WARMUP + 1
    if served.launches != table or launches != {n: runs * c for n, c in table.items()}:
        raise RuntimeError(f"run_test launched {launches}, recorded {served.launches} at "
                           f"capture; expected {table} a forward over {runs} forwards")
    # the self_eq layers' shape takes K5's ws form (chosen by shape alone)
    m = tester.model_cfg
    form = rpe_attention.rpe_attention_form(m.kanchor * m.num_heads, m.gt_hidden_dim // m.num_heads,
                                            m.gt_hidden_dim, torch.bfloat16)
    if form != "ws":
        raise RuntimeError(f"K5 at the se3eti self_eq shape takes its {form!r} form, not 'ws'")
    print(f"phase 8: run_test launched {runs} x the table ({CAPTURE_WARMUP} warm-up forwards "
          f"and the capture; replays count nothing), K5 on its ws form", flush=True)

    # every output and metric of the replays bit for bit against eager
    want += [eager(td) for td in inputs[1:]]
    for i, td in enumerate(inputs):
        got = served(td)
        _require_bitwise(f"captured eval forward, pair {i}", got, want[i])
        _require_bitwise(f"captured eval metrics, pair {i}", got["metrics"], want[i]["metrics"])
        bad = [k for k, v in got["metrics"].items() if not bool(torch.isfinite(v))]
        if bad:
            raise RuntimeError(f"pair {i}: metrics not finite: {bad}")
    torch.cuda.synchronize()
    print(f"phase 8: {TEST_PAIRS} pairs replayed, every output and metric equal to the eager "
          f"eval forward bit for bit, metrics finite; Tester "
          f"{summary['seconds_per_pair'] * 1e3:.2f} ms/pair (copy-in + replay + synchronise, "
          f"first pair left out); capture {served.capture_ms:.1f} ms; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.2f} above the resident); "
          f"metrics {dict((k, round(v, 4)) for k, v in summary.items())}", flush=True)
    _tester_split("phase 8", pairs, inputs, served, dev, eager)
    del want, eager
    checks = _conv_checks("se3eti", SE3ETI_CONV_SHAPES, inputs[0], launches, runs)

    # the same run at the registry's neighbour widths (no calibration): the
    # synthetic pairs' calibrated widths are far below them
    tester_u, loader_u, _ = runner.prepare_test(
        cfg, ["--max_pairs", str(NO_CALIBRATE_PAIRS), "--no_calibrate"])
    sets_u, pairs_u = {}, []

    def kept_u():
        for data, meta in loader_u:
            sets_u.update((k, v.shape[1:]) for k, v in data.items()
                          if k.startswith(("neighbors_", "subsampling_")))
            pairs_u.append(dict(data))
            yield data, meta

    summary_u = tester_u.run(kept_u(), save_features=False, benchmark=benchmark)
    print(f"phase 8 at the registry's widths {sets_u} (--no_calibrate): "
          f"Tester {summary_u['seconds_per_pair'] * 1e3:.2f} ms/pair (copy-in + replay + "
          f"synchronise, first pair left out); metrics "
          f"{dict((k, round(v, 4)) for k, v in summary_u.items())}", flush=True)
    if not all(math.isfinite(v) for v in summary_u.values()):
        raise RuntimeError(f"run_test --no_calibrate: metrics not finite: {summary_u}")
    _tester_split("phase 8 at the registry's widths", pairs_u,
                  [pyramid_to_tensors(p, dev) for p in pairs_u], tester_u.captured, dev)
    del tester_u, pairs_u

    for method in ("lgr", "svd"):
        result = runner.run_eval(cfg, ["--method", method])
        print(f"phase 8: run_eval --method {method} overall "
              f"{dict((k, round(v, 4)) for k, v in result['overall'].items())}", flush=True)
        if not all(math.isfinite(v) for v in result["overall"].values()):
            raise RuntimeError(f"run_eval {method}: metrics not finite")
    t0 = time.perf_counter()
    errors = runner.run_demo(configs.make_cfg(DEMO_EXPERIMENT), [])
    print(f"phase 8: run_demo {DEMO_EXPERIMENT} (random weights: the values show the path "
          f"runs) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{tag} RRE {rre:.3f} deg, RTE {rte:.4f} m" for tag, (rre, rte) in errors.items()),
          flush=True)
    if set(errors) != {"original", "rotated src"} or not all(
            math.isfinite(v) for pair in errors.values() for v in pair):
        raise RuntimeError(f"run_demo: {errors}")

    # K5 at the self_eq layers' shape without the SH term (pair 0), and
    # with it (se3ete's self_eq layers) on the same points: replayed from a
    # CUDA graph beside the profiler's device time, which runs low late in
    # a process
    k5 = [selfcheck.check_rpe_attention(
        inputs[0]["points_3"], inputs[0]["masks_3"], m.kanchor * m.num_heads,
        c=m.gt_hidden_dim // m.num_heads, cc=m.gt_hidden_dim, with_sh=with_sh, reps=10,
        device_kernel="rpe_attention_ws_kernel", replay=True) for with_sh in (False, True)]
    res = k5[0]
    res.launches = launches["rpe_self_attention"]
    _print_check(res)
    for r in k5:
        dev_ms = "not measured" if r.device_ms is None else f"{r.device_ms:.4f}"
        print(f"K5 {r.shape}: events {r.ms:.4f} ms, replayed {r.replay_ms:.4f} ms, profiler "
              f"device {dev_ms} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}), "
              f"{r.bound_ms / r.replay_ms:.1%} of it replayed", flush=True)
    print(f"K5 per served se3eti pair (3 launches): replayed {3 * res.replay_ms:.4f} ms, bound "
          f"{3 * res.bound_ms:.4f} ms", flush=True)
    if not all(r.ok for r in k5):
        raise RuntimeError("K5 at AH = 24 disagrees with its plain version")
    checks["rpe_self_attention (se3eti self_eq, no SH)"] = res
    return checks


# the conv kernels on the se3eti path: (name, what, neighbour set, source
# stage, A*C of the conv's input, A*C of its output (K12, K13), of the
# skip payload (K13, K14, K2), launches a forward), at the widths of phase
# 3's checks at se3ete's shapes
SE3ETI_CONV_SHAPES = (
    ("gather_wf_mm", "stage-0 same", "neighbors_0", 0, 6 * 32, 6 * 32, 0, 1),
    ("gather_wf_mm", "stage-1 same", "neighbors_1", 1, 6 * 64, 6 * 64, 0, 2),
    ("gather_wf_max_mm", "s0 -> s1", "subsampling_0", 0, 6 * 32, 6 * 32, 6 * 128, 1),
    ("gather_wf_max", "s1 -> s2", "subsampling_1", 1, 6 * 64, 0, 6 * 256, 1),
    ("gather_wf", "stage-2 same", "neighbors_2", 2, 6 * 128, 0, 0, 2),
    ("gather_wf", "s2 -> s3", "subsampling_2", 2, 6 * 128, 0, 0, 1),
    ("gather_wf", "stage-3 same", "neighbors_3", 3, 6 * 256, 0, 0, 2),
    ("neighbor_max", "s2 -> s3 skip", "subsampling_2", 2, 0, 0, 6 * 512, 1),
)


# the conv kernels on the se3ete2 path at the family's widths (half
# se3ete's), in the same layout; K2 is not on it (its skips ride K13 and
# K14) and is held at the s2 -> s3 skip payload the unfused route would give
# it
SE3ETE2_CONV_SHAPES = (
    ("gather_wf_mm", "stage-0 same", "neighbors_0", 0, 6 * 16, 6 * 16, 0, 1),
    ("gather_wf_max_mm", "s0 -> s1", "subsampling_0", 0, 6 * 16, 6 * 16, 6 * 64, 1),
    ("gather_wf_mm", "stage-1 same", "neighbors_1", 1, 6 * 32, 6 * 32, 0, 2),
    ("gather_wf_max_mm", "s1 -> s2", "subsampling_1", 1, 6 * 32, 6 * 32, 6 * 128, 1),
    ("gather_wf_mm", "stage-2 same", "neighbors_2", 2, 6 * 64, 6 * 64, 0, 2),
    ("gather_wf_max", "s2 -> s3", "subsampling_2", 2, 6 * 64, 0, 6 * 256, 1),
    ("gather_wf", "stage-3 same", "neighbors_3", 3, 6 * 128, 0, 0, 2),
    ("neighbor_max", "s2 -> s3 skip, unfused route", "subsampling_2", 2, 0, 0, 6 * 256, 0),
)


def _conv_checks(tag, shapes, p0, launches, runs):
    """The conv kernels (K12, K13, K14, K1, K2) against their plain versions
    at the shapes a path gave them (K12 where it takes its tc48 form also
    beside its first design and the unfused route, by events and replayed,
    printed with its bound and share): pair 0's neighbour sets, at the widths
    of ``shapes`` (name, what, neighbour set, source stage, A*C of the
    conv's input, A*C of its output (K12, K13), of the skip payload (K13,
    K14, K2), launches a forward), each printed with its (rows, H, AC,
    AC2).  Each row's launches are ``runs`` x its launches a forward; their
    sum per kernel is the run's counter.  Returns {name: CheckResult} of
    the shapes the path launched; raises on any disagreement."""
    import torch

    from se3et_tpu_torch.ops.kernels import selfcheck
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    ns = [p0[f"points_{i}"].shape[1] for i in range(4)]
    held, per_kernel = {}, {}
    for name, what, nset, st, ac, ac_out, ac2, n in shapes:
        nbr = p0[nset]
        print(f"{tag} conv {name} {what}: rows {nbr.shape[1]} over {ns[st]}, H {nbr.shape[2]}, "
              f"AC {ac}, AC2 {ac2}, {n} a forward", flush=True)
        t0 = time.perf_counter()
        tc48 = name == "gather_wf_mm" and \
            wc.gather_wf_mm_form(nbr.shape[2], torch.bfloat16, ac_out) == "tc48"
        if name == "gather_wf":
            res = selfcheck.check_gather_wf(nbr, ns[st], ac)
        elif name == "neighbor_max":
            res = selfcheck.check_neighbor_max(nbr, ns[st], ac2)
        else:
            # K12's tc48 form beside its first design and the unfused route,
            # by events and replayed
            res = selfcheck.check_fused_conv(name, nbr, ns[st], ac, ac_out=ac_out, ac2=ac2,
                                             first=tc48, replay=tc48)
        res.launches = runs * n
        per_kernel[name] = per_kernel.get(name, 0) + res.launches
        _print_check(res)
        if tc48:
            print(f"{tag} K12 {what} (H {nbr.shape[2]}, {res.form} form): {res.ms:.4f} ms by "
                  f"events (first design in this run {res.first_ms:.4f}; unfused route "
                  f"{res.route_ms:.4f}), replayed {res.replay_ms:.4f} (first design "
                  f"{res.first_replay_ms:.4f}, {res.first_replay_ms / res.replay_ms:.1f}x; "
                  f"unfused route {res.route_replay_ms:.4f}); bound {res.bound_ms:.4f} "
                  f"({res.bound_by}), {res.bound_ms / res.replay_ms:.1%} of it replayed; "
                  f"per {tag} pair {n} x replayed {n * res.replay_ms:.4f} ms (first design "
                  f"{n * res.first_replay_ms:.4f}); check and timings "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        held[f"{name} ({tag} {what}, H {nbr.shape[-1]})"] = res
    if any(launches[name] != c for name, c in per_kernel.items()):
        raise RuntimeError(f"the run launched {launches}, its shapes {per_kernel}")
    # the kernels line carries the path's rows (a shape held off the path
    # is printed above only)
    checks = {k: r for k, r in held.items() if r.launches}
    bad = [k for k, r in held.items() if not r.ok]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at {tag}'s shapes: {bad}")
    return checks


def _print_replayed(res):
    if res.replay_ms is not None:
        print(f"  replayed {res.replay_ms:.4f} ms, bound {res.bound_ms:.4f} ms "
              f"({res.bound_by}), {res.bound_ms / res.replay_ms:.1%} of it", flush=True)


def _print_k5_32(what, res):
    """K5 at head width 32 on its ws form beside its first design in this
    run (events, replayed)."""
    print(f"phase 9 K5 at {what} (ws form): {res.ms:.4f} ms by events (first design in this "
          f"run {res.first_ms:.4f}), replayed {res.replay_ms:.4f} ({res.first_replay_ms:.4f}), "
          f"{res.first_replay_ms / res.replay_ms:.1f}x the first design replayed; bound "
          f"{res.bound_ms:.4f} ({res.bound_by}), {res.bound_ms / res.replay_ms:.1%} of it "
          f"replayed", flush=True)


def _wide_head(dev):
    """Phase 9: the wide-head family (head width 32) at full width.  (a)
    ``se3ete2.3dmatch`` served captured: a tiny float32 card-vs-CPU run of
    its flash cut; synthetic pairs whose stage-0 sets fill at least half
    their cap, random weights from the experiment's seed; an eager pass
    whose counters (set to 0 just before, read just after) are held to
    ``SE3ETE2_LAUNCHES`` a pair; ``capture_forward`` (counts at capture,
    every replay bit for bit against eager); eager and captured served in
    turns, peak memory and one replayed pair's profile; K5 (both self-layer
    shapes), K6, K7 and K3 at the path's shapes against their plain
    versions, with their times replayed from a CUDA graph (K5, K6 and K7
    beside their first designs); the conv kernels
    at the family's shapes (:func:`_conv_checks`; K12's tc48 form beside
    its first design and the unfused route); the ``serve_femb`` route: one
    eager pair (K16 5, K3 0, K5 0), captured, served in turns with the
    default route and one replayed pair profiled; K16 at both shapes
    beside its first design.  (b) ``se3eti2.3dmatch``
    through ``run_test``'s Tester (calibrated limits, the captured eval
    forward) with counters set to 0 just before and read just after, every
    replayed output and metric bit for bit against eager, and K5 at its
    self_eq shape without the SH term beside its first design.  Returns
    ({name: CheckResult}, the se3ete2 pairs)."""
    import torch

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.experiments import configs, runner
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import eq_attention, rpe_attention, selfcheck

    t_phase = time.perf_counter()
    cfg = configs.serving_config(configs.make_cfg(WIDE_EXPERIMENT))
    m = cfg.model
    heads, hw, cc = m.num_heads, m.gt_hidden_dim // m.num_heads, m.gt_hidden_dim
    ah = m.kanchor * heads
    forms = {"K5 self_eq": rpe_attention.rpe_attention_form(ah, hw, cc, torch.bfloat16),
             "K5 self": rpe_attention.rpe_attention_form(heads, hw, cc, torch.bfloat16),
             "K16": rpe_attention.rpe_attention_form(ah, hw, cc, torch.bfloat16, femb=True),
             "K6": eq_attention.eq_attention_stats_form(heads, hw, torch.bfloat16),
             "K7": eq_attention.eq_attention_apply_form(heads, hw, torch.bfloat16)}
    print(f"phase 9 {WIDE_EXPERIMENT}: head width {hw}, C {cc}, AH {ah} / {heads}; forms "
          f"{forms}", flush=True)
    want_forms = {"K5 self_eq": "ws", "K5 self": "ws", "K16": "ws", "K6": "tc", "K7": "tc"}
    if hw != 32 or forms != want_forms:
        raise RuntimeError(f"the wide-head family's attention takes {forms} at head width {hw}:"
                           f" expected {want_forms}")
    extent = configs.synthetic_extent(cfg.data.dataset)
    launches = _tiny_card_vs_cpu("flash se3ete2", configs.tiny_flash_config(cfg), 600, extent,
                                 dev)
    short = {n: c for n, c in FLASH_LAUNCHES.items() if launches[n] != c}
    if short:
        raise RuntimeError(f"tiny flash se3ete2 run did not take the flash kernels: {short}")

    # (a) se3ete2 at full width: pairs of point_limit points, host influence
    pairs, host_ms = [], []
    for i in range(WIDE_PAIRS):
        t0 = time.perf_counter()
        pairs.append(synthetic_pair(i, cfg.pipeline, m, cfg.data.point_limit, extent,
                                    seed=cfg.seed))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    cap0 = cfg.pipeline.stage_caps[0]
    valid = [[int(v) for v in p["masks_0"].sum(axis=1)] for p in pairs]
    print(f"phase 9: {WIDE_PAIRS} pairs of {cfg.data.point_limit} points, caps "
          f"{cfg.pipeline.stage_caps}, host pyramid + influence ms/pair "
          f"{[round(x, 1) for x in host_ms]}; stage-0 valid points per cloud {valid}; "
          f"(rows, H) of pair 0's sets "
          f"{dict((k, v.shape[1:]) for k, v in pairs[0].items() if k.startswith(('neighbors_', 'subsampling_')))}",
          flush=True)
    if min(min(v) for v in valid) < cap0 // 2:
        raise RuntimeError(f"stage-0 sets {valid} fill less than half their cap {cap0}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    model = SE3ETModel(m, seed=cfg.seed).eval()
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    table = dict.fromkeys(selfcheck.WRAPPERS, 0)
    table.update(SE3ETE2_LAUNCHES)
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    outs = [model(td) for td in inputs]
    torch.cuda.synchronize()
    counted = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    if counted != {n: WIDE_PAIRS * c for n, c in table.items()}:
        raise RuntimeError(f"{WIDE_PAIRS} eager se3ete2 pairs launched {counted}, expected "
                           f"{table} a pair")
    for out in outs:
        tf = out["estimated_transform"]
        if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
            raise RuntimeError(f"se3ete2: bad estimated_transform {tf}")
    eager_peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 9: eager se3ete2 pairs launched {dict((n, c) for n, c in counted.items() if c)}"
          f" ({WIDE_PAIRS} pairs, the table's); max_memory_allocated "
          f"{eager_peak / 2**30:.2f} GiB", flush=True)
    del outs
    # the main path's run: capture_forward on pair 0 (3 warm-up forwards and
    # the capture), every replay bit for bit against eager
    served = _capture_checked("se3ete2 default", model, inputs, SE3ETE2_LAUNCHES)
    runs = CAPTURE_WARMUP + 1
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    if launches != {n: runs * c for n, c in table.items()}:
        raise RuntimeError(f"the se3ete2 capture launched {launches}, expected {runs} x {table}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 9: captured se3ete2: max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({(peak - resident) / 2**30:.2f} above the resident, eager and capture)", flush=True)
    ms = _captured_turns({"eager": (model, inputs), "captured": (served, inputs)},
                         ("eager", "captured", "captured", "eager"))
    print(f"phase 9 se3ete2 ms/pair in turns (eager, captured, captured, eager; "
          f"{CAPTURED_TURN_PAIRS} pairs each): " + "; ".join(
              f"{r} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f})"
              for r, v in ms.items()), flush=True)
    # K6 on its tc kernel in the replayed pair and K12's two stage-2 convs
    # (H 36) on tc48, their first designs never (a second profile where the
    # first lists one short)
    k6 = WIDE_DEVICE_KERNELS["eq_attention_stats"]
    want_seen = {k6: FLASH_LAUNCHES["eq_attention_stats"], K6_FIRST_KERNEL: 0,
                 K12_TC48_KERNEL: SE3ETE2_K12_TC48_LAUNCHES, K12_FIRST_KERNEL: 0}
    for attempt in (1, 2):
        prof = _profile(lambda: served(inputs[0]), what="one replayed se3ete2 pair",
                        also=tuple(WIDE_DEVICE_KERNELS.values()) + (
                            K6_FIRST_KERNEL, K12_TC48_KERNEL, K12_FIRST_KERNEL))
        if prof is None:
            raise RuntimeError("the profiler recorded no device time over a se3ete2 replay")
        seen = {name: sum(c for key, c in prof["counts"].items()
                          if re.search(rf"\b{name}\b", key))
                for name in want_seen}
        print(f"phase 9 replay profile (attempt {attempt}): {seen}", flush=True)
        if seen == want_seen:
            break
    else:
        raise RuntimeError(f"a replayed se3ete2 pair launched {seen}, expected {want_seen}")

    # the kernels at the path's shapes (pair 0's coarse points), by events
    # and replayed from a CUDA graph
    p0 = inputs[0]
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    k5 = {"self_eq": (2, selfcheck.check_rpe_attention(
              pts_c, masks_c, ah, c=hw, cc=cc, reps=10, replay=True, first=True)),
          "self": (3, selfcheck.check_rpe_attention(
              pts_c, masks_c, heads, c=hw, cc=cc, with_sh=False, reps=10, replay=True,
              first=True))}
    checks = {}
    for what, (n, res) in k5.items():
        res.launches = runs * n
        checks[f"rpe_self_attention (se3ete2 {what}, head width {hw})"] = res
        _print_k5_32(f"se3ete2 {what}", res)
    print(f"phase 9 K5 per se3ete2 pair (2 + 3 launches): replayed "
          f"{sum(n * r.replay_ms for n, r in k5.values()):.4f} ms (first design in this run "
          f"{sum(n * r.first_replay_ms for n, r in k5.values()):.4f}), bound "
          f"{sum(n * r.bound_ms for n, r in k5.values()):.4f} ms", flush=True)
    for name, fn in (("eq_attention_stats", selfcheck.check_eq_stats),
                     ("eq_attention_apply", selfcheck.check_eq_apply)):
        kw = dict(two_calls=True) if name == "eq_attention_apply" else {}
        res = fn(masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=hw, reps=20, replay=True,
                 first=True, **kw)
        res.launches = launches[name]
        checks[f"{name} (se3ete2, head width {hw})"] = res
    k6 = checks[f"eq_attention_stats (se3ete2, head width {hw})"]
    per_pair = FLASH_LAUNCHES["eq_attention_stats"]
    print(f"phase 9 K6 at head width {hw} ({forms['K6']} form): {k6.ms:.4f} ms by events "
          f"(first design in this run {k6.first_ms:.4f}), replayed {k6.replay_ms:.4f} "
          f"({k6.first_replay_ms:.4f}), {k6.first_replay_ms / k6.replay_ms:.1f}x the first "
          f"design replayed; bound {k6.bound_ms:.4f} ({k6.bound_by}), "
          f"{k6.bound_ms / k6.replay_ms:.1%} of it replayed; per se3ete2 pair {per_pair} x "
          f"replayed {per_pair * k6.replay_ms:.4f} ms (first design "
          f"{per_pair * k6.first_replay_ms:.4f})", flush=True)
    k7 = checks[f"eq_attention_apply (se3ete2, head width {hw})"]
    print(f"phase 9 K7 at head width {hw} ({forms['K7']} form): {k7.ms:.4f} ms by events "
          f"(first design in this run {k7.first_ms:.4f}), replayed {k7.replay_ms:.4f} "
          f"({k7.first_replay_ms:.4f}); two "
          f"PyTorch calls {k7.two_calls_ms:.4f}; bound {k7.bound_ms:.4f} ({k7.bound_by}), "
          f"{k7.bound_ms / k7.replay_ms:.1%} of it replayed; per se3ete2 pair "
          f"{FLASH_LAUNCHES['eq_attention_apply']} x replayed "
          f"{FLASH_LAUNCHES['eq_attention_apply'] * k7.replay_ms:.4f} ms "
          f"(first design {FLASH_LAUNCHES['eq_attention_apply'] * k7.first_replay_ms:.4f})",
          flush=True)
    res = selfcheck.check_embedding(pts_c, masks_c, c=cc, k=m.angle_k, sigma_d=m.sigma_d,
                                    sigma_a=m.sigma_a)
    res.launches = launches["geometric_embedding"]
    checks[f"geometric_embedding (se3ete2, C {cc})"] = res
    for res in checks.values():
        _print_check(res)
        _print_replayed(res)
    if sum(r.launches for n, r in checks.items() if n.startswith("rpe_self_attention (")) \
            != launches["rpe_self_attention"]:
        raise RuntimeError(f"K5's rows do not sum to the run's {launches['rpe_self_attention']}")
    checks.update(_conv_checks("se3ete2", SE3ETE2_CONV_SHAPES, p0, launches, runs))

    # the serve_femb route: K16 (its ws form with head width 32's plan) in
    # place of K3 + K5; one eager pair counted, then captured (replays bit
    # for bit), served in turns with the default route, one replayed pair
    # profiled; then K16 at both self-layer shapes beside its first design
    femb = SE3ETModel(dataclasses.replace(m, serve_femb=True), seed=cfg.seed).eval()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    out = femb(p0)
    torch.cuda.synchronize()
    counted = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    want = dict(table, **FEMB_LAUNCHES)
    if counted != want or not bool(torch.isfinite(out["estimated_transform"]).all()):
        raise RuntimeError(f"a se3ete2 femb pair launched {counted}, expected {want}")
    print(f"phase 9: a se3ete2 serve_femb pair launched "
          f"{dict((n, c) for n, c in counted.items() if c)}", flush=True)
    del out
    served_femb = _capture_checked("se3ete2 femb", femb, inputs, want)
    ms = _captured_turns({"default": (served, inputs), "femb": (served_femb, inputs)},
                         ("default", "femb", "femb", "default"))
    print(f"phase 9 se3ete2 ms/pair in turns (captured default, femb, femb, default; "
          f"{CAPTURED_TURN_PAIRS} pairs each): " + "; ".join(
              f"{r} median {statistics.median(v):.2f} (range {min(v):.2f}-{max(v):.2f})"
              for r, v in ms.items()), flush=True)
    want_seen = {K16_WS_KERNEL: FEMB_LAUNCHES["rpe_self_attention_femb"], K16_FIRST_KERNEL: 0}
    for attempt in (1, 2):
        prof = _profile(lambda: served_femb(inputs[0]), what="one replayed se3ete2 femb pair",
                        also=(K16_WS_KERNEL, K16_FIRST_KERNEL))
        if prof is None:
            raise RuntimeError("the profiler recorded no device time over a se3ete2 femb replay")
        seen = {name: sum(c for key, c in prof["counts"].items()
                          if re.search(rf"\b{name}\b", key))
                for name in want_seen}
        print(f"phase 9 femb replay profile (attempt {attempt}): {seen}", flush=True)
        if seen == want_seen:
            break
    else:
        raise RuntimeError(f"a replayed se3ete2 femb pair launched {seen}, expected {want_seen}")
    k16_device = {key: t for key, t in prof["ms"].items()
                  if re.search(rf"\b{K16_WS_KERNEL}\b", key)}
    print(f"phase 9 K16 device ms in the replayed femb pair: " + ", ".join(
        f"{t:.4f} over {prof['counts'][key]} launches ({key[:70]})"
        for key, t in k16_device.items()), flush=True)
    del femb, served_femb
    k16 = {}
    for what, n, a, with_sh in (("self_eq", 2, ah, True), ("self", 3, heads, False)):
        res = selfcheck.check_rpe_attention_femb(pts_c, masks_c, a, c=hw, cc=cc, k=m.angle_k,
                                                 sigma_d=m.sigma_d, sigma_a=m.sigma_a,
                                                 with_sh=with_sh, reps=5, replay=True,
                                                 first=True)
        res.launches = n
        _print_check(res)
        _print_replayed(res)
        print(f"phase 9 K16 at se3ete2 {what} (ws form): {res.ms:.4f} ms by events (first "
              f"design in this run {res.first_ms:.4f}), replayed {res.replay_ms:.4f} "
              f"({res.first_replay_ms:.4f}), {res.first_replay_ms / res.replay_ms:.1f}x the "
              f"first design replayed; bound {res.bound_ms:.4f} ({res.bound_by}), "
              f"{res.bound_ms / res.replay_ms:.1%} of it replayed", flush=True)
        k16[what] = (n, res)
        checks[f"rpe_self_attention_femb (se3ete2 {what}, head width {hw})"] = res
    print(f"phase 9 K16 per se3ete2 femb pair (2 + 3 launches): replayed "
          f"{sum(n * r.replay_ms for n, r in k16.values()):.4f} ms (first design in this run "
          f"{sum(n * r.first_replay_ms for n, r in k16.values()):.4f}), bound "
          f"{sum(n * r.bound_ms for n, r in k16.values()):.4f} ms", flush=True)
    bad = [k for k, r in checks.items() if not r.ok]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at head width {hw}: "
                           f"{bad}")
    del model, served, inputs, p0
    wide_a = time.perf_counter() - t_phase

    # (b) se3eti2 through run_test's Tester, from no calibration cache, no
    # dumps and no snapshots of an earlier run
    cfg_i = configs.make_cfg(WIDE_TEST_EXPERIMENT)
    for stale in ("neighbor_limits.json", "features", "snapshots"):
        _remove(os.path.join(cfg_i.output_dir, stale))
    gc.collect()
    torch.cuda.synchronize()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    tester, loader, benchmark = runner.prepare_test(cfg_i, ["--max_pairs", str(WIDE_TEST_PAIRS)])
    pairs_i = []

    def kept():
        for data, meta in loader:
            pairs_i.append(dict(data))
            yield data, meta

    summary = tester.run(kept(), benchmark=benchmark)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    table = dict.fromkeys(selfcheck.WRAPPERS, 0)
    table.update(SE3ETI2_LAUNCHES)
    served = tester.captured
    if len(pairs_i) != WIDE_TEST_PAIRS or served is None or served.launches != table \
            or launches != {n: runs * c for n, c in table.items()}:
        raise RuntimeError(f"run_test on {WIDE_TEST_EXPERIMENT} served {len(pairs_i)} pairs, "
                           f"launched {launches}, recorded {served and served.launches}; "
                           f"expected {runs} x {table}")
    eager = make_forward(tester.model, tester.eval_cfg)
    inputs = [pyramid_to_tensors(p, dev) for p in pairs_i]
    for i, td in enumerate(inputs):
        want, got = eager(td), served(td)
        _require_bitwise(f"captured se3eti2 eval forward, pair {i}", got, want)
        _require_bitwise(f"captured se3eti2 eval metrics, pair {i}", got["metrics"],
                         want["metrics"])
        if not all(bool(torch.isfinite(v)) for v in got["metrics"].values()):
            raise RuntimeError(f"se3eti2 pair {i}: metrics not finite")
    torch.cuda.synchronize()
    print(f"phase 9 {WIDE_TEST_EXPERIMENT}: run_test launched {runs} x "
          f"{dict((n, c) for n, c in table.items() if c)}; (rows, H) of pair 0's sets "
          f"{dict((k, v.shape[1:]) for k, v in pairs_i[0].items() if k.startswith(('neighbors_', 'subsampling_')))}; "
          f"{WIDE_TEST_PAIRS} pairs replayed equal to the eager eval forward bit for bit, "
          f"metrics finite; Tester {summary['seconds_per_pair'] * 1e3:.2f} ms/pair (copy-in + "
          f"replay + synchronise, first pair left out); capture {served.capture_ms:.1f} ms; "
          f"metrics {dict((k, round(v, 4)) for k, v in summary.items())}", flush=True)
    _tester_split(f"phase 9 {WIDE_TEST_EXPERIMENT}", pairs_i, inputs, served, dev, eager)
    res = selfcheck.check_rpe_attention(inputs[0]["points_3"], inputs[0]["masks_3"], ah, c=hw,
                                        cc=cc, with_sh=False, reps=10, replay=True, first=True)
    res.launches = launches["rpe_self_attention"]
    _print_check(res)
    _print_replayed(res)
    _print_k5_32("se3eti2 self_eq", res)
    print(f"phase 9 K5 per se3eti2 pair (3 launches): replayed {3 * res.replay_ms:.4f} ms "
          f"(first design in this run {3 * res.first_replay_ms:.4f}), bound "
          f"{3 * res.bound_ms:.4f} ms", flush=True)
    if not res.ok:
        raise RuntimeError("K5 at se3eti2's self_eq shape disagrees with its plain version")
    checks[f"rpe_self_attention (se3eti2 self_eq, no SH, head width {hw})"] = res
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s ((a) se3ete2 {wide_a:.1f} s)",
          flush=True)
    return checks, pairs


def _wide_training(dev, pairs):
    """Phase 10: the wide-head family trained on the card.  K11 at head
    width 32 (its tc form in bf16, the first design in float32) against
    its plain version at se3ete2's self_eq shape (AH = 24, SH), its plain
    self shape (AH = 4) and se3eti2's self_eq shape (AH = 24, no SH), by
    events, device time (the kernel and the whole call) and, in bf16,
    replayed from a CUDA graph, with its bound, the bf16 first design timed
    beside the tc form on the same inputs;
    a tiny float32 card-vs-CPU training step of se3ete2's flash cut;
    ``make_train_step`` at full se3ete2 width on phase 9's pairs (one
    warm-up and three timed steps, counters set to 0 just before and read
    just after, held to ``SE3ETE2_TRAIN_LAUNCHES``; ms/step, forward + loss
    ms, peak memory); the float32 K1, K8, K9 and K10 against their plain
    versions at the family's training shapes; ``trainval`` on se3eti2
    through ``main`` (an epoch of 2 steps with validation on 2 pairs and
    snapshots, then ``--resume`` to epoch 2, each call's backward launches
    held to ``SE3ETI2_TRAIN_BWD_LAUNCHES``), then ``test --snapshot
    .../latest`` on 2 pairs with finite metrics; last, the profile of one
    se3ete2 training step (K11's tc kernel 5 times, its first design and
    K5's never).  Returns {name: CheckResult} of the path's rows."""
    import torch

    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import make_optimizer
    from se3et_tpu_torch.experiments import configs, runner
    from se3et_tpu_torch.nn.loss import overall_loss
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import embedding, rpe_attention, selfcheck

    t_phase = time.perf_counter()
    cfg = configs.serving_config(configs.make_cfg(WIDE_EXPERIMENT))
    m = cfg.model
    heads, hw, cc = m.num_heads, m.gt_hidden_dim // m.num_heads, m.gt_hidden_dim
    ah = m.kanchor * heads
    forms = {f"K11 AH {a} {dt}": rpe_attention.rpe_attention_bwd_form(a, hw, cc, dt)
             for a in (ah, heads) for dt in (torch.bfloat16, torch.float32)}
    forms["K10 C 128 bf16"] = embedding.geometric_embedding_bwd_form(cc, torch.bfloat16)
    print(f"phase 10 {WIDE_EXPERIMENT} training: head width {hw}, C {cc}; forms {forms}",
          flush=True)
    if any(v != ("tc" if k.endswith("bfloat16") else "cuda")
           for k, v in forms.items() if k.startswith("K11")) \
            or forms["K10 C 128 bf16"] != "tc":
        raise RuntimeError(f"the wide-head family's training takes {forms}")
    _tiny_train_card_vs_cpu(cfg, configs.synthetic_extent(cfg.data.dataset), dev)
    split = {"tiny step": time.perf_counter() - t_phase}

    # se3ete2's training step at full width on phase 9's pairs
    gc.collect()
    torch.cuda.synchronize()
    model = SE3ETModel(m, seed=cfg.seed)
    step = make_train_step(model, cfg.loss, make_optimizer(model.parameters(), cfg.optim,
                                                            len(pairs)))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    step(inputs[-1], generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(inputs[i % len(inputs)], generator=gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    vals = [{k: float(v) for k, v in ls.items()} for ls in losses]
    if not all(math.isfinite(x) for v in vals for x in v.values()):
        raise RuntimeError(f"se3ete2: non-finite training losses or gradient norm: {vals}")
    table = dict.fromkeys(selfcheck.WRAPPERS, 0)
    table.update(SE3ETE2_TRAIN_LAUNCHES)
    if launches != {n: TRAIN_STEPS * c for n, c in table.items()}:
        raise RuntimeError(f"{TRAIN_STEPS} se3ete2 training steps launched {launches}, "
                           f"expected {table} a step")
    fwd_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(inputs[0], train=True, with_registration=False, generator=gen)
        overall_loss(out, inputs[0], cfg.loss)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    print(f"phase 10 se3ete2 train ms/step: {[round(x, 2) for x in step_ms]} (median "
          f"{statistics.median(step_ms):.2f}); forward + loss (no backward) "
          f"{[round(x, 2) for x in fwd_ms]} (median {statistics.median(fwd_ms):.2f}); losses "
          f"{vals}; launches {dict((n, c) for n, c in launches.items() if c)} ({TRAIN_STEPS} "
          f"steps, the table's); max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    split["full-width step"] = time.perf_counter() - t_phase - sum(split.values())

    # the training kernels at the family's shapes (pair 0), against their
    # plain versions; K11 on its tc form beside its first design in the same
    # run (its whole call before the redesign beside), and in float32 (off
    # the path: training feeds it the embedding's dtype, bf16)
    p0 = inputs[0]
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    checks, held = {}, []
    for what, a, with_sh, per_step, before in (("se3ete2 self_eq", ah, True, 2, 7.9302),
                                               ("se3ete2 self", heads, False, 3, 4.6064),
                                               ("se3eti2 self_eq", ah, False, None, 6.9067)):
        for dt in (torch.bfloat16, torch.float32):
            bf = dt == torch.bfloat16
            res = selfcheck.check_rpe_attention_bwd(
                pts_c, masks_c, a, c=hw, cc=cc, with_sh=with_sh, dtype=dt,
                device_kernel=K11_KERNEL if bf else K11_FIRST_KERNEL, first=bf, replay=bf)
            _print_check(res)
            first = (f"; the first design in this run: events {res.first_ms:.4f} ms, its "
                     f"kernel {_ms(res.first_device_ms)} ms (its whole call before the "
                     f"redesign {before:.4f} device ms)") if bf else ""
            replayed = f", replayed {res.replay_ms:.4f} ms" if bf else ""
            print(f"K11 {what} {res.shape}: events {res.ms:.4f} ms, device: the kernel "
                  f"{_ms(res.device_ms)} ms, the whole call {_ms(res.call_device_ms)} ms"
                  f"{replayed}; bound {res.bound_ms:.4f} ms ({res.bound_by}), "
                  f"{res.bound_ms / res.ms:.1%} of it by events; plain {res.plain_ms:.4f} ms; "
                  f"library none{first}", flush=True)
            held.append(res)
            if dt == torch.bfloat16:
                res.launches = TRAIN_STEPS * per_step if per_step else 0
                checks[f"rpe_attention_bwd ({what}, head width {hw})"] = res
    split["K11 checks"] = time.perf_counter() - t_phase - sum(split.values())
    k8 = [(what, n, selfcheck.check_gather_wf_bwd(p0[key], p0[f"points_{src}"].shape[1], ac))
          for what, key, src, ac, n in SE3ETE2_K8_SHAPES]
    k1 = [(what, n, selfcheck.check_gather_wf(p0[key], p0[f"points_{src}"].shape[1], ac,
                                              dtype=torch.float32))
          for what, key, src, ac, n in SE3ETE2_K8_SHAPES]
    for name, rows in (("gather_wf_bwd", k8), ("gather_wf", k1)):
        if sum(n for _, n, _ in rows) != SE3ETE2_TRAIN_LAUNCHES[name]:
            raise RuntimeError(f"SE3ETE2_K8_SHAPES does not cover the step's {name} launches")
    for what, n, res in k8:
        res.launches = TRAIN_STEPS * n
        checks[f"gather_wf_bwd (se3ete2 {what})"] = res
    for what, n, res in k1:
        res.launches = TRAIN_STEPS * n
        checks[f"gather_wf (float32, se3ete2 {what})"] = res
    for i, ac in enumerate(SE3ETE2_SKIP_AC):
        res = selfcheck.check_neighbor_max_bwd(p0[f"subsampling_{i}"],
                                               p0[f"points_{i}"].shape[1], ac)
        res.launches = TRAIN_STEPS
        checks[f"neighbor_max_bwd (se3ete2 s{i} -> s{i + 1})"] = res
    res = selfcheck.check_embedding_bwd(pts_c, masks_c, c=cc, k=m.angle_k, sigma_d=m.sigma_d,
                                        sigma_a=m.sigma_a, device_kernel=K10_KERNEL)
    res.launches = TRAIN_STEPS
    checks[f"geometric_embedding_bwd (se3ete2, C {cc})"] = res
    for name, res in checks.items():
        if not name.startswith("rpe_attention_bwd"):
            _print_check(res)
    forms = {name: res.form for name, res in checks.items() if res.form is not None}
    print(f"phase 10: forms at se3ete2's training shapes {forms}", flush=True)
    want = {"gather_wf_bwd": "tiles", "gather_wf": "rows", "neighbor_max_bwd": "tiles"}
    off = {k: f for k, f in forms.items() if f != want[k.split(" (")[0]]}
    if off:
        raise RuntimeError(f"training kernels took other forms at se3ete2's shapes: {off}")
    bad = [r.name + " " + r.shape for r in list(checks.values()) + held if not r.ok]
    if bad:
        raise RuntimeError(f"training kernels disagree with their plain versions at head "
                           f"width {hw}: {bad}")
    per_step = {"K11 (events)": sum(n * r.ms for n, r in ((2, held[0]), (3, held[2]))),
                "K11 (device)": sum(n * (r.device_ms or math.nan)
                                    for n, r in ((2, held[0]), (3, held[2]))),
                "K11 calls (device)": sum(n * (r.call_device_ms or math.nan)
                                          for n, r in ((2, held[0]), (3, held[2]))),
                "K11 first design (events)": sum(n * r.first_ms
                                                 for n, r in ((2, held[0]), (3, held[2]))),
                "K11 bound": sum(n * r.bound_ms for n, r in ((2, held[0]), (3, held[2]))),
                "K8 (events)": sum(n * r.ms for _, n, r in k8),
                "K1 float32 (events)": sum(n * r.ms for _, n, r in k1)}
    print("phase 10 se3ete2 per step (ms): " + ", ".join(f"{k} {v:.4f}"
                                                       for k, v in per_step.items()),
          flush=True)
    split["K1, K8, K9, K10 checks"] = time.perf_counter() - t_phase - sum(split.values())

    # se3eti2 through the registry's trainval (its calibrated limits, cached
    # by phase 9), --resume, then test from the snapshot
    t0 = time.perf_counter()
    cfg_i = configs.make_cfg(WIDE_TEST_EXPERIMENT)
    for stale in ("snapshots", "events", "features"):
        _remove(os.path.join(cfg_i.output_dir, stale))
    args = ["--max_steps_per_epoch", str(TRAINVAL_STEPS)]
    runs = []
    for extra in (["--max_epoch", "1"], ["--max_epoch", "2", "--resume"]):
        gc.collect()
        torch.cuda.synchronize()
        for w in selfcheck.WRAPPERS.values():
            w.launches = 0
        trainer = runner.main([WIDE_TEST_EXPERIMENT, "trainval"] + extra + args)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
        want = {n: TRAINVAL_STEPS * c for n, c in SE3ETI2_TRAIN_BWD_LAUNCHES.items()}
        if {n: launches[n] for n in want} != want:
            raise RuntimeError(f"trainval {extra} launched {launches}, expected {want} of the "
                               "backward kernels (one epoch)")
        runs.append((trainer.epoch, trainer.iteration, launches))
        del trainer
    if [r[:2] for r in runs] != [(1, TRAINVAL_STEPS), (2, 2 * TRAINVAL_STEPS)]:
        raise RuntimeError(f"trainval then --resume reached (epoch, iteration) "
                           f"{[r[:2] for r in runs]}")
    se3eti2_k11 = runs[0][2]["rpe_attention_bwd"] + runs[1][2]["rpe_attention_bwd"]
    checks[f"rpe_attention_bwd (se3eti2 self_eq, head width {hw})"].launches = se3eti2_k11
    with open(os.path.join(cfg_i.output_dir, "events", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    val = [e for e in events if "val/loss" in e]
    if len(val) != 2 or not all(math.isfinite(v) for e in val for v in e.values()):
        raise RuntimeError(f"trainval's validation lines: {val}")
    snap = os.path.join(cfg_i.output_dir, "snapshots", "latest")
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    summary = runner.main([WIDE_TEST_EXPERIMENT, "test", "--snapshot", snap, "--max_pairs",
                           str(TRAINVAL_TEST_PAIRS)])
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in summary.values()):
        raise RuntimeError(f"test from the trained snapshot: metrics {summary}")
    t_trainval = time.perf_counter() - t0
    split["trainval and test"] = t_trainval
    print(f"phase 10 {WIDE_TEST_EXPERIMENT}: trainval (epoch 1, {TRAINVAL_STEPS} steps, "
          f"validation on {TRAINVAL_STEPS} pairs) then --resume to epoch 2: (epoch, "
          f"iteration) {[r[:2] for r in runs]}, backward launches per call "
          f"{[{n: r[2][n] for n in SE3ETI2_TRAIN_BWD_LAUNCHES} for r in runs]}; validation "
          f"{[{k: round(v, 4) for k, v in e.items() if k.startswith('val/')} for e in val]}; "
          f"test --snapshot latest on {TRAINVAL_TEST_PAIRS} pairs: "
          f"{dict((k, round(v, 4)) for k, v in summary.items())}; {t_trainval:.1f} s",
          flush=True)

    # last in the phase (a profiler session makes later ones in the process
    # lossy): one se3ete2 training step's device time by kernel.  K11's tc
    # kernel runs 5 times; K11's first design and K5's (the CUDA-core
    # kernel) never (a profile that lists one short is taken once more)
    k5_ws = WIDE_DEVICE_KERNELS["rpe_self_attention"]
    also = (K11_KERNEL, K11_FIRST_KERNEL, K8_KERNEL, K1_F32_KERNEL, K10_KERNEL, k5_ws) \
        + K9_KERNELS
    want = {K11_KERNEL: SE3ETE2_TRAIN_LAUNCHES["rpe_attention_bwd"], K11_FIRST_KERNEL: 0,
            "rpe_attention_kernel": 0}
    for _ in range(2):
        prof = _profile(lambda: step(inputs[0], generator=gen),
                        what="one se3ete2 training step", top=20, also=also)
        if prof is None:
            break
        seen = {name: sum(c for key, c in prof["counts"].items()
                          if re.search(rf"\b{name}\b", key))
                for name in want}
        if seen == want:
            break
    else:
        raise RuntimeError(f"the se3ete2 step profile lists {seen}, expected {want}")
    if prof is not None:
        per = {what: sum(ms for key, ms in prof["ms"].items()
                         if any(re.search(rf"\b{n}\b", key) for n in names))
               for what, names in (("K11", (K11_KERNEL,)), ("K8", (K8_KERNEL,)),
                                   ("K1 float32", (K1_F32_KERNEL,)), ("K9", K9_KERNELS),
                                   ("K10", (K10_KERNEL,)), ("K5", (k5_ws,)))}
        print(f"phase 10 se3ete2 step profile (launches {seen}), device ms per step: "
              + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    split["profile"] = time.perf_counter() - t_phase - sum(split.values())
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()) + ")", flush=True)
    return checks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from se3et_tpu_torch.data import host_ops
    from se3et_tpu_torch.data.influence import precompute_influence
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, synthetic_extent, tiny_config, tiny_flash_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import _build, selfcheck

    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)

    # 1. kernels
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel sources in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 2. host pyramids, without influence (the device-influence route of
    # phase 7) and with the host's influence added (every other phase)
    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    extent = synthetic_extent(cfg.data.dataset)
    pairs, bare_pairs, pyramid_ms, influence_ms = [], [], [], []
    for i in range(NUM_PAIRS):
        t0 = time.perf_counter()
        bare_pairs.append(synthetic_pair(i, cfg.pipeline, None, cfg.data.point_limit, extent,
                                         seed=cfg.seed))
        t1 = time.perf_counter()
        pairs.append(precompute_influence(dict(bare_pairs[-1]), cfg.model))
        t2 = time.perf_counter()
        pyramid_ms.append((t1 - t0) * 1e3)
        influence_ms.append((t2 - t1) * 1e3)
    host_ms = [a + b for a, b in zip(pyramid_ms, influence_ms)]
    valid = [int(pairs[0][f"masks_{s}"].sum()) for s in range(cfg.pipeline.num_stages)]
    print(f"host ops route: {'native' if host_ops._USE_NATIVE else 'numpy'}; "
          f"host pyramid ms/pair (no influence): {[round(x, 1) for x in pyramid_ms]} "
          f"(median {statistics.median(pyramid_ms):.1f}); + host influence "
          f"{[round(x, 1) for x in influence_ms]} (median "
          f"{statistics.median(influence_ms):.1f}); pyramid+influence median "
          f"{statistics.median(host_ms):.1f}; pair 0 valid points per stage {valid}",
          flush=True)

    # 3. kernels against their plain versions at the slice's shapes
    m = cfg.model
    p0 = pyramid_to_tensors(pairs[0], dev)
    ns0, ns1, ns2, ns3 = (p0[f"points_{i}"].shape[1] for i in range(4))
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    heads, head_dim = m.num_heads, m.gt_hidden_dim // m.num_heads
    checks = {
        # stage 2-3 same-level convs and the s2 -> s3 strided conv: K1 +
        # matmul; at the stage-0 shape for comparison with PR 1-3
        "gather_wf": selfcheck.check_gather_wf(p0["neighbors_0"], ns0, 6 * 32),
        # K2 where it serves on the fused route: the s2 -> s3 skip max (A*512)
        "neighbor_max": selfcheck.check_neighbor_max(
            p0["subsampling_2"], ns2, 6 * 512, reps=20,
            device_kernel="neighbor_max_rows_kernel", first=True),
        "geometric_embedding": selfcheck.check_embedding(
            pts_c, masks_c, c=m.gt_hidden_dim, k=m.angle_k, sigma_d=m.sigma_d,
            sigma_a=m.sigma_a),
        "sinkhorn": selfcheck.check_sinkhorn(
            b=m.num_correspondences, m=m.num_points_in_patch + 1,
            n=m.num_points_in_patch + 1, iters=m.num_sinkhorn_iterations, device=dev,
            reps=20, device_kernel="sinkhorn_rows_kernel"),
        # self_eq layers: A*H anchor-heads with the SH term
        "rpe_self_attention": selfcheck.check_rpe_attention(
            pts_c, masks_c, m.kanchor * heads, c=head_dim, cc=m.gt_hidden_dim, reps=10,
            device_kernel="rpe_attention_ws_kernel"),
        # 20 launches per timing: with 3 the first call's host time shows
        "eq_attention_stats": selfcheck.check_eq_stats(
            masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim, reps=20,
            device_kernel="eq_stats_tc_kernel"),
        "eq_attention_apply": selfcheck.check_eq_apply(
            masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim, reps=20,
            device_kernel="eq_apply_tc_kernel", two_calls=True),
        # stage-0 bottleneck conv (mid 32: A*Cin = A*Cout = 192)
        "gather_wf_mm": selfcheck.check_fused_conv("gather_wf_mm", p0["neighbors_0"], ns0,
                                                   6 * 32, ac_out=6 * 32),
        # s0 -> s1 strided bottleneck: conv mid 32, skip payload A*128
        "gather_wf_max_mm": selfcheck.check_fused_conv(
            "gather_wf_max_mm", p0["subsampling_0"], ns0, 6 * 32, ac_out=6 * 32,
            ac2=6 * 128, reps=20, device_kernel="gather_wf_max_mm_tc_kernel"),
        # s1 -> s2 strided bottleneck: conv mid 64, skip payload A*256
        "gather_wf_max": selfcheck.check_fused_conv(
            "gather_wf_max", p0["subsampling_1"], ns1, 6 * 64, ac2=6 * 256, reps=20,
            device_kernel="gather_wf_max_tc_kernel", first=True),
    }
    extra = [
        # stage-1 bottleneck convs (mid 64: A*Cin = A*Cout = 384)
        selfcheck.check_fused_conv("gather_wf_mm", p0["neighbors_1"], ns1, 6 * 64,
                                   ac_out=6 * 64),
        # rotation-supervision max (not on the serving path)
        selfcheck.check_eq_stats(masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim,
                                 with_sup=True),
    ]
    # K5 at its two self-layer shapes, with its launches per pair and its
    # times before the redesign (NVIDIA H100 80GB HBM3, 700 W): 2 self_eq
    # layers (A*H anchor-heads, SH term), 3 plain self layers (H heads)
    k5_serving = [(2, checks["rpe_self_attention"], 0.8990),
                  (3, selfcheck.check_rpe_attention(pts_c, masks_c, heads, c=head_dim,
                                                    cc=m.gt_hidden_dim, with_sh=False,
                                                    reps=10,
                                                    device_kernel="rpe_attention_ws_kernel"),
                   0.6492)]
    extra.append(k5_serving[1][1])
    # K1 where it serves on the fused route, with its launches per pair:
    # the stage-2 bottleneck convs (x2, A*128), the s2 -> s3 strided conv
    # (A*128), the stage-3 bottleneck convs (x2, A*256)
    k1_serving = [(2, selfcheck.check_gather_wf(p0["neighbors_2"], ns2, 6 * 128)),
                  (1, selfcheck.check_gather_wf(p0["subsampling_2"], ns2, 6 * 128)),
                  (2, selfcheck.check_gather_wf(p0["neighbors_3"], ns3, 6 * 256))]
    extra += [res for _, res in k1_serving]
    # K2 at the three strided skips of the unfused route (bf16) and of
    # training (float32): s0 -> s1 (A*128), s1 -> s2 (A*256), s2 -> s3
    # (A*512), each beside its first design on the same inputs
    k2_skips = [(f"s{i} -> s{i + 1}", dtype,
                 selfcheck.check_neighbor_max(p0[f"subsampling_{i}"], ns, 6 * 128 << i,
                                              dtype=dtype, reps=20, first=True))
                for dtype in (torch.bfloat16, torch.float32)
                for i, ns in enumerate((ns0, ns1, ns2))
                if not (dtype == torch.bfloat16 and i == 2)]  # the serving check above
    extra += [res for _, _, res in k2_skips]
    for res in list(checks.values()) + extra:
        _print_check(res)
    print(f"K1 per served pair ({sum(n for n, _ in k1_serving)} launches at the stage 2-3 "
          f"shapes): {sum(n * r.ms for n, r in k1_serving):.4f} ms (PR 6: 2.28), bound "
          f"{sum(n * r.bound_ms for n, r in k1_serving):.4f} ms", flush=True)
    # K2 beside its times before the redesign (NVIDIA H100 80GB HBM3, 700 W:
    # 0.3142 ms by events, 0.3372 device at the serving shape) and its first
    # design's in this run
    res = checks["neighbor_max"]
    dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
    print(f"K2 s2 -> s3 {res.shape}: events {res.ms:.4f} ms (first design 0.3142; in this run "
          f"{res.first_ms:.4f}), device {dev_ms} ms (0.3372); bound {res.bound_ms:.4f} ms "
          f"({res.bound_by}); embedding_bag max {res.library_ms:.4f} ms", flush=True)
    for label, dtype, res in k2_skips:
        print(f"K2 {label} {res.shape}: events {res.ms:.4f} ms, first design in this run "
              f"{res.first_ms:.4f} ms; bound {res.bound_ms:.4f} ms ({res.bound_by}); "
              f"embedding_bag max {res.library_ms:.4f} ms", flush=True)
    for _, res, before in k5_serving:
        dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
        print(f"K5 {res.shape}: {res.ms:.4f} ms (first design: {before:.4f}), device {dev_ms} "
              f"ms, bound {res.bound_ms:.4f} ms", flush=True)
    print(f"K5 per served pair ({sum(n for n, _, _ in k5_serving)} launches): "
          f"{sum(n * r.ms for n, r, _ in k5_serving):.4f} ms (first design: 3.745), bound "
          f"{sum(n * r.bound_ms for n, r, _ in k5_serving):.4f} ms", flush=True)
    # K6 at the EQ cross layers' shape, beside its times before the redesign
    # (NVIDIA H100 80GB HBM3, 700 W: 0.5218 ms by events, 0.4376 device)
    # and K7 (0.4686 ms by events, 0.4242 device)
    for label, name, before in (("K6", "eq_attention_stats", (0.5218, 0.4376)),
                                ("K7", "eq_attention_apply", (0.4686, 0.4242))):
        res, per_pair = checks[name], FLASH_LAUNCHES[name]
        dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
        pair_ms = "not measured" if res.device_ms is None else f"{per_pair * res.device_ms:.4f}"
        print(f"{label} {res.shape}: events {res.ms:.4f} ms (first design {before[0]:.4f}), "
              f"device {dev_ms} ms ({before[1]:.4f}); per served pair ({per_pair} launches) "
              f"device {pair_ms} ms ({per_pair * before[1]:.4f}); bound {res.bound_ms:.4f} ms "
              f"({res.bound_by})", flush=True)
    # K4 beside its chain floor (the probe's loop without dot products: log,
    # exp, shuffle and barrier) and its first design's times (NVIDIA H100
    # 80GB HBM3, 700 W: 0.6490 ms by events, 0.6381 device)
    res = checks["sinkhorn"]
    dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
    print(f"K4 {res.shape}: events {res.ms:.4f} ms (first design 0.6490), device {dev_ms} ms "
          f"(0.6381); bound {res.bound_ms:.4f} ms ({res.bound_by}); chain floor "
          f"{K4_CHAIN_FLOOR_MS:.4f} ms (scripts/probe_sinkhorn.py)", flush=True)
    # K13 beside the unfused route and its first design's times (NVIDIA H100
    # 80GB HBM3, 700 W: 0.6695 ms by events, 0.6282 device), with what its
    # skip max must read
    res = checks["gather_wf_max_mm"]
    dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
    reuse = selfcheck.skip_reuse(p0["subsampling_0"], ns0)
    print(f"K13 {res.shape}: events {res.ms:.4f} ms (first design 0.6695), device {dev_ms} ms "
          f"(0.6282); unfused route {res.route_ms:.4f} ms; bound {res.bound_ms:.4f} ms "
          f"({res.bound_by}); skip max reads {reuse['valid']} valid rows, {reuse['distinct']} "
          f"distinct per 64-row tile, {reuse['live_tiles']} of {reuse['tiles']} tiles with a "
          f"valid neighbour", flush=True)
    # K14 beside the unfused route (K1 + K2) and its first design's times
    # (NVIDIA H100 80GB HBM3, 700 W: 0.3485 ms by events, 0.3284 device), and
    # the first design in this run
    res = checks["gather_wf_max"]
    dev_ms = "not measured" if res.device_ms is None else f"{res.device_ms:.4f}"
    print(f"K14 {res.shape}: events {res.ms:.4f} ms (first design 0.3485; in this run "
          f"{res.first_ms:.4f}), device {dev_ms} ms (0.3284); unfused route K1 + K2 "
          f"{res.route_ms:.4f} ms; bound {res.bound_ms:.4f} ms ({res.bound_by})", flush=True)
    bad = [r.name for r in list(checks.values()) + extra if not r.ok]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    del p0

    # 4. kernel path (card) vs plain path (CPU) on tiny inputs, float32
    _tiny_card_vs_cpu("materialised", tiny_config(cfg), 250, extent, dev)
    launches = _tiny_card_vs_cpu("flash", tiny_flash_config(cfg), 600, extent, dev)
    short = {n: c for n, c in FLASH_LAUNCHES.items() if launches[n] != c}
    if short:
        raise RuntimeError(f"tiny flash run did not take the flash kernels: {short}")

    # 5. serve the pairs at full width
    model = SE3ETModel(cfg.model, seed=cfg.seed).eval()
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    for td in inputs:  # warm-up: cuBLAS handles, allocator pools, clocks
        model(td)
    torch.cuda.synchronize()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    device_ms, outs = [], []
    for td in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(td)
        torch.cuda.synchronize()
        device_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for out in outs:
        tf = out["estimated_transform"]
        if tf.shape != (4, 4) or not bool(torch.isfinite(tf).all()):
            raise RuntimeError(f"bad estimated_transform {tf}")
    idle = [n for n in selfcheck.SERVING if launches[n] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched by the main path: {idle}")
    expected = {n: c * NUM_PAIRS for n, c in {**FLASH_LAUNCHES, **FUSED_CONV_LAUNCHES}.items()}
    expected.update(dict.fromkeys(selfcheck.ROUTES, 0))  # host influence, no serve_femb
    if any(launches[n] != c for n, c in expected.items()):
        raise RuntimeError(f"serving launched {launches}, expected {expected}")
    for name in selfcheck.SERVING:
        checks[name].launches = launches[name]
    print(f"serve ms/pair: {[round(x, 2) for x in device_ms]} (median "
          f"{statistics.median(device_ms):.2f}); launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)

    # the same weights on the unfused conv route (K1 + matmul (+ K2)), served
    # in turns with the fused route: unfused, fused, fused, unfused
    unfused = SE3ETModel(dataclasses.replace(cfg.model, serve_fused_conv=False),
                         seed=cfg.seed).eval()
    for td in inputs:
        unfused(td)
    turns = {"fused": [], "unfused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        net = model if route == "fused" else unfused
        for td in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(td)
            torch.cuda.synchronize()
            turns[route].append((time.perf_counter() - t0) * 1e3)
    print("serve ms/pair in turns: " + "; ".join(
        f"{r} {[round(x, 2) for x in v]} (median {statistics.median(v):.2f})"
        for r, v in turns.items()), flush=True)
    a, b = model(inputs[0], stop_after="backbone"), unfused(inputs[0], stop_after="backbone")
    for key, mask in (("feats_f", inputs[0]["masks_1"]), ("feats_c", inputs[0]["masks_3"])):
        d = float((a[key] - b[key])[mask].abs().max()) / float(b[key][mask].abs().max())
        print(f"backbone {key}, fused vs unfused route (pair 0, valid rows, bf16): "
              f"max|diff| / max|unfused| = {d:.3e}", flush=True)
    del unfused, a, b

    # section times from the stop_after cut points (pair 0, median of 3)
    prefix = {}
    for cut in ("backbone", "transformer", "matching", "sinkhorn", ""):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(inputs[0], stop_after=cut)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        prefix[cut or "full"] = round(statistics.median(ts), 2)
    print(f"prefix ms (pair 0): {prefix}", flush=True)
    print("estimated_transform pair 0:",
          np.array2string(outs[0]["estimated_transform"].cpu().numpy(), precision=4),
          flush=True)

    _profile(lambda: model(inputs[0]), also=SERVING_KERNELS)

    # the captured forward against the eager one
    served = _captured(model, inputs, dev, peak)
    del model, outs, served

    # 6. training
    checks.update(_training(cfg, pairs, extent, dev))

    # 7. the device-influence and femb routes, and entry()
    checks.update(_routes(cfg, pairs, bare_pairs, extent, dev,
                          [res for _, res, _ in k5_serving]))

    # 8. the registry's test path: se3eti.3dmatch through run_test's Tester,
    # run_eval, run_demo
    checks.update(_test_path(dev))

    # 9. the wide-head family at head width 32: se3ete2 served captured,
    # se3eti2 through run_test's Tester
    wide_checks, wide_pairs = _wide_head(dev)
    checks.update(wide_checks)

    # 10. the wide-head family trained: se3ete2's training step at full
    # width on phase 9's pairs, se3eti2 through trainval, --resume and test
    checks.update(_wide_training(dev, wide_pairs))
    del wide_pairs

    kernels = []
    for name, res in checks.items():
        source, replaces = selfcheck.SOURCES[name.split(" (")[0]]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": res.launches,
               "max_abs_err": res.max_abs_err, "ms": res.ms,
               "plain_ms": res.plain_ms, "bound_ms": res.bound_ms,
               "bound_by": res.bound_by, "library_ms": res.library_ms}
        # yardsticks measured beside some kernels: device time (profiler),
        # the unfused route (K12-K14), the first design (K2, K11, K14, K15),
        # K8's tile plan's build, K15's calls replayed from a CUDA graph
        row.update({key: getattr(res, key) for key in ("device_ms", "route_ms", "first_ms",
                                                       "call_device_ms", "first_device_ms",
                                                       "plan_ms", "replay_ms", "first_replay_ms",
                                                       "route_replay_ms")
                    if getattr(res, key) is not None})
        kernels.append(row)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
