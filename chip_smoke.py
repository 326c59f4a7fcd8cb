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
   and K1 and K2 at the shapes where they serve on the fused route (the
   stage 2-3 convs and the s2 -> s3 skip) beside their stage-0 rows;
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
   served pair (``torch.profiler``);
6. training: hold the four backward kernels (K8-K11) against their plain
   versions at the training shapes with their bounds; one tiny float32
   training step on the card and on the CPU with the same weights and
   target noise, agreeing on the losses and every parameter's gradient;
   then ``make_train_step`` at full se3ete.3dmatch width (float32, the JAX
   training routes): one warm-up and three timed steps on the synthetic
   pairs with the backward kernels' launch counters reset before and
   checked after (K8 10, K9 3, K10 1, K11 5 per step; forward K1 10, K2 3,
   K3 1, K4 1, K5 5), finite losses and gradient norm, the step time, the
   forward + loss time alone, peak memory and a ``torch.profiler``
   breakdown of one step;
7. the routes off the default one: K15 (device influence) against its plain
   version at the stage-0 same-level and the stage-1 strided set of pair 0,
   K16 (``serve_femb``) at the self_eq (AH = 24, SH) and plain self (AH =
   4) shapes; tiny float32 card-vs-CPU runs with ``serve_femb=True`` and on
   a pyramid without host influence; the four pairs without host influence
   served in turns with the default route (per pair K15 7), then with
   ``serve_femb=True`` in turns with the default route (per pair K16 5, K3
   0, K5 0), with ms/pair, peak memory, the routes' differences on pair 0
   and a ``torch.profiler`` breakdown of one femb pair; then
   ``se3et_tpu_torch.entry.entry()`` once, with a finite transform, printed
   beside its largest matching score.

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
# launches per served pair on the routes of phase 7: device influence (7
# (stage, neighbour set) pairs), and serve_femb (5 self layers, no
# embedding written, no K5)
DEVICE_INFLUENCE_LAUNCHES = {"influence": 7}
FEMB_LAUNCHES = {"rpe_self_attention_femb": 5, "geometric_embedding": 0,
                 "rpe_self_attention": 0}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _print_check(res):
    lib = "none" if res.library_ms is None else f"{res.library_ms:.4f} ms"
    route = "" if res.route_ms is None else f", unfused route {res.route_ms:.4f} ms"
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


def _profile(run, what="one pair", top=15):
    """Device time by kernel over one call of ``run`` (torch.profiler),
    against its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # kernels (device-side events) only: operator rows would count them twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    device_ms = sum(getattr(e, attr) for e in events) / 1e3
    print(f"profile ({what}, profiler on): wall {wall:.2f} ms, kernels {device_ms:.2f} ms, "
          f"device idle {max(0.0, 1 - device_ms / wall):.1%}", flush=True)
    for e in sorted(events, key=lambda e: getattr(e, attr), reverse=True)[:top]:
        print(f"  {getattr(e, attr) / 1e3:8.3f} ms  {e.count:5d} launches  {e.key[:90]}",
              flush=True)


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
    ns0 = p0["points_0"].shape[1]
    heads, head_dim = m.num_heads, m.gt_hidden_dim // m.num_heads
    checks = {
        # stage-0 bottleneck conv: x (2, 20000, A*32), K = 15
        "gather_wf_bwd": selfcheck.check_gather_wf_bwd(p0["neighbors_0"], ns0, 6 * 32),
        # stage-1 strided skip: x (2, 20000, A*128)
        "neighbor_max_bwd": selfcheck.check_neighbor_max_bwd(p0["subsampling_0"], ns0,
                                                             6 * 128),
        "geometric_embedding_bwd": selfcheck.check_embedding_bwd(
            pts_c, masks_c, c=m.gt_hidden_dim, k=m.angle_k, sigma_d=m.sigma_d,
            sigma_a=m.sigma_a),
        # self_eq layers (A*H anchor-heads with the SH term); training feeds
        # K5/K11 the embedding's dtype, bf16
        "rpe_attention_bwd": selfcheck.check_rpe_attention_bwd(
            pts_c, masks_c, m.kanchor * heads, c=head_dim, cc=m.gt_hidden_dim),
    }
    extra = [selfcheck.check_rpe_attention_bwd(pts_c, masks_c, heads, c=head_dim,
                                               cc=m.gt_hidden_dim, with_sh=False)]
    for res in list(checks.values()) + extra:
        _print_check(res)
    bad = [r.name for r in list(checks.values()) + extra if not r.ok]
    if bad:
        raise RuntimeError(f"backward kernels disagree with their plain versions: {bad}")
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
    _profile(lambda: step(inputs[0], generator=gen), what="one training step", top=25)
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


def _require_launches(route, launches, per_pair, pairs_served):
    want = {n: c * pairs_served for n, c in per_pair.items()}
    got = {n: launches[n] for n in want}
    if got != want:
        raise RuntimeError(f"the {route} route launched {got}, expected {want}")


def _routes(cfg, pairs, bare_pairs, extent, dev):
    """Phase 7: K15 and K16 checked against their plain versions, tiny
    card-vs-CPU runs of both routes, both routes served at full width in
    turns with the default route, and ``entry()``; returns the checks."""
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
    kp0 = _kernel_points_for(m, m.init_radius)
    checks = {
        # stage-0 same-level set at the stage-0 radius and sigma
        "influence": selfcheck.check_influence(p0["points_0"], p0["points_0"],
                                               p0["neighbors_0"], kp0, m.init_sigma,
                                               mode=m.epn.kp_influence, reps=20),
        # self_eq layers: A*H anchor-heads with the SH term
        "rpe_self_attention_femb": selfcheck.check_rpe_attention_femb(
            pts_c, masks_c, m.kanchor * heads, reps=10, **emb_kw),
    }
    extra = [
        # the s0 -> s1 strided set (stage-1 queries over stage-0 points)
        selfcheck.check_influence(p0["points_1"], p0["points_0"], p0["subsampling_0"], kp0,
                                  m.init_sigma, mode=m.epn.kp_influence, reps=20),
        # plain self layers: H heads, no SH term
        selfcheck.check_rpe_attention_femb(pts_c, masks_c, heads, with_sh=False, reps=10,
                                           **emb_kw),
    ]
    for res in list(checks.values()) + extra:
        _print_check(res)
    bad = [r.name for r in list(checks.values()) + extra if not r.ok]
    if bad:
        raise RuntimeError(f"route kernels disagree with their plain versions: {bad}")
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
    ms, launches = _serve_turns(routes, ("default", "device influence", "device influence",
                                         "default"), NUM_PAIRS)
    _require_launches("device-influence", launches["device influence"],
                      DEVICE_INFLUENCE_LAUNCHES, 2 * NUM_PAIRS)
    if launches["default"]["influence"]:
        raise RuntimeError("the default route (host influence) launched K15")
    checks["influence"].launches = launches["device influence"]["influence"] // 2
    print("serve ms/pair in turns (device influence): " + "; ".join(
        f"{r} {[round(x, 2) for x in ms[r]]} (median {statistics.median(ms[r]):.2f})"
        for r in ("default", "device influence")), flush=True)
    a = model(inputs[0], stop_after="backbone")
    b = model(bare[0], stop_after="backbone")
    mask = inputs[0]["masks_3"]
    d = float((a["feats_c"] - b["feats_c"])[mask].abs().max()) / float(
        a["feats_c"][mask].abs().max())
    print(f"backbone feats_c, device vs host influence (pair 0, valid rows, bf16): "
          f"max|diff| / max|host| = {d:.3e}", flush=True)
    _profile(lambda: model(bare[0]), what="one pair, device-influence route", top=40)
    del a, b, routes["device influence"], bare

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
    del model, femb, inputs, routes

    fn, (net, data) = entry()
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
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
    if selfcheck.WRAPPERS["influence"].launches != 7:
        raise RuntimeError("entry() did not compute the influence on the card")
    print(f"entry(): {(time.perf_counter() - t0) * 1e3:.1f} ms (first call), "
          f"estimated_transform finite, K15 launches "
          f"{selfcheck.WRAPPERS['influence'].launches}", flush=True)
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
    extent = synthetic_extent(cfg.dataset)
    pairs, bare_pairs, pyramid_ms, influence_ms = [], [], [], []
    for i in range(NUM_PAIRS):
        t0 = time.perf_counter()
        bare_pairs.append(synthetic_pair(i, cfg.pipeline, None, cfg.point_limit, extent,
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
        "neighbor_max": selfcheck.check_neighbor_max(p0["subsampling_0"], ns0, 6 * 128),
        "geometric_embedding": selfcheck.check_embedding(
            pts_c, masks_c, c=m.gt_hidden_dim, k=m.angle_k, sigma_d=m.sigma_d,
            sigma_a=m.sigma_a),
        "sinkhorn": selfcheck.check_sinkhorn(
            b=m.num_correspondences, m=m.num_points_in_patch + 1,
            n=m.num_points_in_patch + 1, iters=m.num_sinkhorn_iterations, device=dev),
        # self_eq layers: A*H anchor-heads with the SH term
        "rpe_self_attention": selfcheck.check_rpe_attention(
            pts_c, masks_c, m.kanchor * heads, c=head_dim, cc=m.gt_hidden_dim),
        "eq_attention_stats": selfcheck.check_eq_stats(
            masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim),
        "eq_attention_apply": selfcheck.check_eq_apply(
            masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim),
        # stage-0 bottleneck conv (mid 32: A*Cin = A*Cout = 192)
        "gather_wf_mm": selfcheck.check_fused_conv("gather_wf_mm", p0["neighbors_0"], ns0,
                                                   6 * 32, ac_out=6 * 32),
        # s0 -> s1 strided bottleneck: conv mid 32, skip payload A*128
        "gather_wf_max_mm": selfcheck.check_fused_conv(
            "gather_wf_max_mm", p0["subsampling_0"], ns0, 6 * 32, ac_out=6 * 32,
            ac2=6 * 128),
        # s1 -> s2 strided bottleneck: conv mid 64, skip payload A*256
        "gather_wf_max": selfcheck.check_fused_conv("gather_wf_max", p0["subsampling_1"], ns1,
                                                    6 * 64, ac2=6 * 256),
    }
    extra = [
        # stage-1 bottleneck convs (mid 64: A*Cin = A*Cout = 384)
        selfcheck.check_fused_conv("gather_wf_mm", p0["neighbors_1"], ns1, 6 * 64,
                                   ac_out=6 * 64),
        # K1 and K2 where they serve on the fused route: the stage-2
        # bottleneck convs (x2, A*128), the s2 -> s3 strided conv (A*128)
        # and its skip max (A*512), the stage-3 bottleneck convs (x2, A*256)
        selfcheck.check_gather_wf(p0["neighbors_2"], ns2, 6 * 128),
        selfcheck.check_gather_wf(p0["subsampling_2"], ns2, 6 * 128),
        selfcheck.check_neighbor_max(p0["subsampling_2"], ns2, 6 * 512),
        selfcheck.check_gather_wf(p0["neighbors_3"], ns3, 6 * 256),
        # plain self layers: H heads, no SH term
        selfcheck.check_rpe_attention(pts_c, masks_c, heads, c=head_dim,
                                      cc=m.gt_hidden_dim, with_sh=False),
        # rotation-supervision max (not on the serving path)
        selfcheck.check_eq_stats(masks_c[0], masks_c[1], a=m.kanchor, h=heads, c=head_dim,
                                 with_sup=True),
    ]
    for res in list(checks.values()) + extra:
        _print_check(res)
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

    _profile(lambda: model(inputs[0]))
    del model, outs

    # 6. training
    checks.update(_training(cfg, pairs, extent, dev))

    # 7. the device-influence and femb routes, and entry()
    checks.update(_routes(cfg, pairs, bare_pairs, extent, dev))

    kernels = []
    for name, res in checks.items():
        source, replaces = selfcheck.SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": res.launches,
                        "max_abs_err": res.max_abs_err, "ms": res.ms,
                        "plain_ms": res.plain_ms, "bound_ms": res.bound_ms,
                        "bound_by": res.bound_by, "library_ms": res.library_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
