"""Smoke run of the PyTorch port (``se3et_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build the six CUDA sources of ``se3et_tpu_torch/csrc`` (nvcc, sm_90a,
   all started together);
2. build four synthetic 3DMatch pairs at point_limit 20000 on the host
   (the port's numpy pipeline, exact neighbours, the port's influence),
   and say which host-ops route ran (``native`` C++ library or ``numpy``);
3. hold each of the seven kernels against its plain PyTorch version at the
   slice's real shapes, in the working dtype (bf16 for K1-K3 and K5-K7,
   float32 for K4), with its bound and, where one exists, the time of one
   PyTorch call computing the same function;
4. check that the kernel path (card) and the plain path (CPU) agree on two
   tiny float32 inputs: the materialised-attention cut and the flash cut
   (128-point coarse stage, 600 points), the latter launching K5-K7
   (coarse features, matching scores and, on the first, the transform);
5. serve the four pairs at full se3ete.3dmatch width through
   ``SE3ETModel.forward`` (default route: flash attention) with seeded
   random weights, with every kernel's launch counter reset before and
   checked after (K5 20, K6 16, K7 16, the others > 0); then the section
   times from the ``stop_after`` cuts and the device time by kernel over
   one served pair (``torch.profiler``).

Prints timings, then the card's name and power limit, a JSON line with the
kernels, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is present or the port is
not importable.
"""

import json
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


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _print_check(res):
    lib = "none" if res.library_ms is None else f"{res.library_ms:.4f} ms"
    print(f"kernel {res.name}: {res.shape} max_abs_err={res.max_abs_err:.3e} "
          f"(tol {res.tol:.3e}) kernel {res.ms:.4f} ms, plain {res.plain_ms:.4f} ms, "
          f"bound {res.bound_ms:.4f} ms ({res.bound_by}), library {lib}", flush=True)


def _tiny_card_vs_cpu(name, cfg, num_points, extent, dev, gate_transform=True):
    """One tiny pair through the CPU (plain versions) and the card (kernels)
    in float32; returns the launches the card run made.  Checked within
    1e-3: the transformer's coarse features on valid rows, the matching
    scores on valid entries and, with ``gate_transform``, the estimated
    transform.  (On the 600-point flash input the registration is
    ill-conditioned: on the CPU, noise of 1e-5 on the matching scores moves
    the transform by 1.3e-3, so there it is printed, not gated.)"""
    import torch

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    tiny = synthetic_pair(0, cfg.pipeline, cfg.model, num_points, extent)
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
    t_err = float((got["estimated_transform"].cpu() - want["estimated_transform"]).abs().max())
    s_valid = torch.isfinite(want["matching_scores"]) & (want["matching_scores"] > -1e6)
    s_err = float((got["matching_scores"].cpu() - want["matching_scores"])[s_valid].abs().max())
    print(f"tiny fp32 card vs cpu ({name}): |d coarse feats| {f_err:.2e} (tol 1e-3), "
          f"|d matching_scores| {s_err:.2e} (tol 1e-3), |dT| {t_err:.2e} "
          f"({'tol 1e-3' if gate_transform else 'not gated'}); launches {launches}",
          flush=True)
    if not (f_err <= 1e-3 and s_err <= 1e-3 and (t_err <= 1e-3 or not gate_transform)):
        raise RuntimeError(f"kernel path and plain path disagree on the tiny {name} input")
    return launches


def _profile(model, data):
    """Device time by kernel over one served pair (torch.profiler), against
    the pair's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(data)
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
    print(f"profile (one pair, profiler on): wall {wall:.2f} ms, kernels {device_ms:.2f} ms, "
          f"device idle {max(0.0, 1 - device_ms / wall):.1%}", flush=True)
    for e in sorted(events, key=lambda e: getattr(e, attr), reverse=True)[:15]:
        print(f"  {getattr(e, attr) / 1e3:8.3f} ms  {e.count:5d} launches  {e.key[:90]}",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from se3et_tpu_torch.data import host_ops
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

    # 2. host pyramids
    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    extent = synthetic_extent(cfg.dataset)
    pairs, host_ms = [], []
    for i in range(NUM_PAIRS):
        t0 = time.perf_counter()
        pairs.append(synthetic_pair(i, cfg.pipeline, cfg.model, cfg.point_limit, extent,
                                    seed=cfg.seed))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    valid = [int(pairs[0][f"masks_{s}"].sum()) for s in range(cfg.pipeline.num_stages)]
    print(f"host ops route: {'native' if host_ops._USE_NATIVE else 'numpy'}; "
          f"host pyramid+influence ms/pair: {[round(x, 1) for x in host_ms]} "
          f"(median {statistics.median(host_ms):.1f}); pair 0 valid points per "
          f"stage {valid}", flush=True)

    # 3. kernels against their plain versions at the slice's shapes
    m = cfg.model
    p0 = pyramid_to_tensors(pairs[0], dev)
    ns0 = p0["points_0"].shape[1]
    pts_c, masks_c = p0["points_3"], p0["masks_3"]
    heads, head_dim = m.num_heads, m.gt_hidden_dim // m.num_heads
    checks = {
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
    }
    extra = [
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
    launches = _tiny_card_vs_cpu("flash", tiny_flash_config(cfg), 600, extent, dev,
                                 gate_transform=False)
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
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise RuntimeError(f"kernels not launched by the main path: {idle}")
    expected = {n: c * NUM_PAIRS for n, c in FLASH_LAUNCHES.items()}
    if any(launches[n] != c for n, c in expected.items()):
        raise RuntimeError(f"flash kernels launched {launches}, expected {expected}")
    print(f"serve ms/pair: {[round(x, 2) for x in device_ms]} (median "
          f"{statistics.median(device_ms):.2f}); launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)

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

    _profile(model, inputs[0])

    kernels = []
    for name, res in checks.items():
        source, replaces = selfcheck.SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
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
