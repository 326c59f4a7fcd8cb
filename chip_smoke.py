"""Smoke run of the PyTorch port (``se3et_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build the four CUDA kernels from ``se3et_tpu_torch/csrc`` (nvcc, sm_90a);
2. build four synthetic 3DMatch pairs at point_limit 20000 on the host
   (shared numpy pipeline, exact neighbours, the port's influence);
3. hold each kernel against its plain PyTorch version at the slice's real
   shapes, in the working dtype (bf16 for K1-K3, float32 for K4);
4. check that the kernel path (card) and the plain path (CPU) agree on a
   tiny input in float32;
5. serve the four pairs at full se3ete.3dmatch width through
   ``SE3ETModel.forward`` with seeded random weights, with every kernel's
   launch counter reset before and required > 0 after.

Prints timings, then the card's name and power limit, a JSON line with the
kernels, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is present or the port is
not importable.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_PAIRS = 4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, synthetic_extent, tiny_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import _build, selfcheck

    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)

    # 1. kernels
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. host pyramids
    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pairs, host_ms = [], []
    for i in range(NUM_PAIRS):
        t0 = time.perf_counter()
        pairs.append(synthetic_pair(i, cfg.pipeline, cfg.model, cfg.point_limit,
                                    synthetic_extent(cfg.dataset), seed=cfg.seed))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    valid = [int(pairs[0][f"masks_{s}"].sum()) for s in range(cfg.pipeline.num_stages)]
    print(f"host pyramid+influence ms/pair: {[round(x, 1) for x in host_ms]} "
          f"(median {statistics.median(host_ms):.1f}); pair 0 valid points per "
          f"stage {valid}", flush=True)

    # 3. kernels against their plain versions at the slice's shapes
    p0 = pyramid_to_tensors(pairs[0], dev)
    ns0 = p0["points_0"].shape[1]
    checks = {
        "gather_wf": selfcheck.check_gather_wf(p0["neighbors_0"], ns0, 6 * 32),
        "neighbor_max": selfcheck.check_neighbor_max(p0["subsampling_0"], ns0, 6 * 128),
        "geometric_embedding": selfcheck.check_embedding(
            p0["points_3"], p0["masks_3"], c=cfg.model.gt_hidden_dim,
            k=cfg.model.angle_k, sigma_d=cfg.model.sigma_d, sigma_a=cfg.model.sigma_a),
        "sinkhorn": selfcheck.check_sinkhorn(
            b=cfg.model.num_correspondences, m=cfg.model.num_points_in_patch + 1,
            n=cfg.model.num_points_in_patch + 1,
            iters=cfg.model.num_sinkhorn_iterations, device=dev),
    }
    for res in checks.values():
        print(f"kernel {res.name}: {res.shape} max_abs_err={res.max_abs_err:.3e} "
              f"(tol {res.tol:.3e}) kernel {res.ms:.4f} ms, plain {res.plain_ms:.4f} ms",
              flush=True)
    bad = [r.name for r in checks.values() if not r.ok]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")

    # 4. kernel path (card) vs plain path (CPU) on a tiny input, float32
    tiny_cfg = tiny_config(cfg)
    tiny = synthetic_pair(0, tiny_cfg.pipeline, tiny_cfg.model, 250,
                          synthetic_extent(cfg.dataset))
    model_cpu = SE3ETModel(tiny_cfg.model, seed=0)
    want = model_cpu(pyramid_to_tensors(tiny, "cpu"))
    got = model_cpu.to(dev)(pyramid_to_tensors(tiny, dev))
    t_err = float((got["estimated_transform"].cpu() - want["estimated_transform"]).abs().max())
    s_valid = torch.isfinite(want["matching_scores"]) & (want["matching_scores"] > -1e6)
    s_err = float((got["matching_scores"].cpu() - want["matching_scores"])[s_valid].abs().max())
    print(f"tiny fp32 card vs cpu: |dT| {t_err:.2e} (tol 1e-3), |d matching_scores| "
          f"{s_err:.2e} (tol 1e-3)", flush=True)
    if not (t_err <= 1e-3 and s_err <= 1e-3):
        raise RuntimeError("kernel path and plain path disagree on the tiny input")

    # 5. serve the pairs at full width
    model = SE3ETModel(cfg.model, seed=cfg.seed).to(dev).eval()
    inputs = [pyramid_to_tensors(p, dev) for p in pairs]
    for td in inputs:  # warm-up: cuBLAS handles, allocator pools, clocks
        model(td)
    torch.cuda.synchronize()
    for name in selfcheck.WRAPPERS:
        selfcheck.WRAPPERS[name].launches = 0
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

    kernels = []
    for name, res in checks.items():
        source, replaces = selfcheck.SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": res.max_abs_err, "ms": res.ms,
                        "plain_ms": res.plain_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
