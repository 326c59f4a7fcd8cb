"""Where K12's and K13's time goes: their phases, timed apart.

    python scripts/probe_gather_wf_mm.py      # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/gather_wf_mm.cu`` into
``se3et_tpu_torch/_build/probe/`` with ``-Xptxas -v`` (prints each kernel's
registers, shared memory and spills) and times with CUDA events:

* the bf16 tensor-core K12 through ``se3et_gather_wf_mm_bf16_phases`` at the
  stage-0 (x (2, 20000, 192), H 24) and stage-1 (x (2, 10000, 384), H 32)
  conv shapes on local random neighbours (``selfcheck.local_neighbors``),
  with its phases switched on and off: the whole kernel (gather, weight
  product, the last wave in half tiles), the same without the half tiles,
  the gather alone (its neighbour staging and H contraction) and the
  weight product alone (its ring of weight panels, on whatever the A tile
  holds);
* the bf16 tensor-core K13 through ``se3et_gather_wf_max_mm_tc_bf16_phases``
  at the s0 -> s1 serving shape (x (2, 20000, 192), nbr (2, 10000, 24),
  skip (2, 20000, 768), A*Cout 192) on local random neighbours and on pair
  0's ``subsampling_0`` (the synthetic se3ete.3dmatch pair of
  ``chip_smoke.py``): whole (the skip max first, by 16-byte loads of
  whole payload rows into registers), with the skip max alone (its floor:
  the same loads, nothing else), the conv alone, without the exit of
  padding tiles and without the half tiles, each checked against the
  plain skip max, beside K13's first design (``se3et_gather_wf_max_mm_bf16``)
  and K2 on the same payload.  On the pair it also prints what the skip
  must read (``selfcheck.skip_reuse``: valid references, distinct rows per
  64-row tile) and the rate of the skip max alone over those bytes.

The weight panels are laid out once, outside the timing.  Prints the card
and one line per (shape, phases).
"""

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, selfcheck  # noqa: E402
from se3et_tpu_torch.ops.kernels import windowed_conv as wc  # noqa: E402

# the kernel's phase bits
GATHER, PRODUCT, SPLIT_TAIL, SKIP, PAD_EXIT = 1, 2, 4, 8, 16
PHASES = {"kernel": GATHER | PRODUCT | SPLIT_TAIL, "no half tiles": GATHER | PRODUCT,
          "gather only": GATHER | SPLIT_TAIL, "product only": PRODUCT | SPLIT_TAIL}
CONV = GATHER | PRODUCT | SPLIT_TAIL
MAX_PHASES = {
    "kernel": CONV | SKIP | PAD_EXIT,
    "skip max alone": SPLIT_TAIL | SKIP | PAD_EXIT,
    "conv alone": CONV | PAD_EXIT,
    "no padding exit": CONV | SKIP,
    "no half tiles": GATHER | PRODUCT | SKIP | PAD_EXIT,
}
REPS = 20


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _build_probe():
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "gather_wf_mm_probe.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                           os.path.join(_build.CSRC_DIR, "gather_wf_mm.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    return ctypes.CDLL(so)


def _k12(lib, dev, g):
    fn = lib.se3et_gather_wf_mm_bf16_phases
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    k = 15
    for nq, ns, h, ac in ((20000, 20000, 24, 192), (10000, 10000, 32, 384)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, torch.bfloat16)
        infl = (torch.rand((2, nq, h, k), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(torch.bfloat16)
        rhs_t = (torch.randn((ac, k * ac), generator=g) * 0.02).to(dev, torch.bfloat16)
        panels = wc.mm_panels(rhs_t.t(), k, ac)
        out = torch.empty((2, nq, ac), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for name, phases in PHASES.items():
            def call(phases=phases, name=name):
                _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(),
                                panels.data_ptr(), out.data_ptr(), 2, ns, nq, h, h, k, ac, ac,
                                phases, stream), name)
            print(f"K12 x(2, {ns}, {ac}) nbr(2, {nq}, {h}): {name:13s} "
                  f"{selfcheck._time_ms(call, REPS):.4f} ms", flush=True)


def _pair_subsampling():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.point_limit,
                          synthetic_extent(cfg.dataset), seed=cfg.seed)
    return torch.as_tensor(pair["subsampling_0"]).to(torch.int32)


def _k13(lib, dev, g):
    fn = lib.se3et_gather_wf_max_mm_tc_bf16_phases
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    first = lib.se3et_gather_wf_max_mm_bf16
    first.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    k, nq, ns, h, ac, ac2 = 15, 10000, 20000, 24, 192, 768
    pair = _pair_subsampling()
    reuse = selfcheck.skip_reuse(pair, ns)
    print(f"pair 0 subsampling_0 {tuple(pair.shape)}: {reuse['valid']} valid references of "
          f"{pair.numel()} slots, {reuse['distinct']} distinct source rows over the "
          f"{reuse['tiles']} 64-row tiles ({reuse['live_tiles']} with a valid neighbour)",
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for label, nbr in (("local", torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev)
                                           for _ in range(2)])),
                       ("pair 0", pair.to(dev))):
        x = torch.randn((2, ns, ac), generator=g).to(dev, torch.bfloat16)
        infl = (torch.rand((2, nq, h, k), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(torch.bfloat16)
        rhs_t = (torch.randn((ac, k * ac), generator=g) * 0.02).to(dev, torch.bfloat16)
        panels = wc.mm_panels(rhs_t.t(), k, ac)
        x2 = torch.randn((2, ns, ac2), generator=g).to(dev, torch.bfloat16)
        out = torch.empty((2, nq, ac), device=dev)
        pooled = torch.empty((2, nq, ac2), dtype=torch.bfloat16, device=dev)
        tag = f"K13 {label} x(2, {ns}, {ac}) nbr(2, {nq}, {h}) skip(2, {ns}, {ac2})"
        times = {}
        want = wc.neighbor_max_plain(x2, nbr)
        for name, phases in MAX_PHASES.items():
            def call(phases=phases, name=name):
                _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(),
                                panels.data_ptr(), out.data_ptr(), x2.data_ptr(),
                                pooled.data_ptr(), 2, ns, nq, h, h, k, ac, ac, ac2, phases,
                                stream), name)
            pooled.zero_()
            call()
            same = "" if not phases & SKIP or torch.equal(pooled, want) else " POOLED DIFFERS"
            times[name] = selfcheck._time_ms(call, REPS)
            print(f"{tag}: {name:16s} {times[name]:.4f} ms{same}", flush=True)
        padded = wc._padded_influence(infl, h, torch.bfloat16)

        def call_first():
            _build.check(first(x.data_ptr(), nbr.data_ptr(), padded.data_ptr(),
                               rhs_t.data_ptr(), out.data_ptr(), x2.data_ptr(),
                               pooled.data_ptr(), 2, ns, nq, h, k, ac, ac, ac2, stream),
                         "first design")
        print(f"{tag}: {'first design':16s} {selfcheck._time_ms(call_first, REPS):.4f} ms",
              flush=True)
        print(f"{tag}: {'K2 on the payload':16s} "
              f"{selfcheck._time_ms(lambda: wc.neighbor_max(x2, nbr), REPS):.4f} ms",
              flush=True)
        if label == "pair 0":
            nbytes = reuse["valid"] * ac2 * 2 + 2 * nq * ac2 * 2
            t = times["skip max alone"]
            print(f"{tag}: skip max alone {t:.4f} ms for {nbytes / 1e6:.1f} MB (valid payload "
                  f"rows read + pooled written), {nbytes / t / 1e9:.2f} TB/s", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_mm: no CUDA device")
    print(_card())
    lib = _build_probe()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    _k12(lib, dev, g)
    _k13(lib, dev, g)


if __name__ == "__main__":
    main()
