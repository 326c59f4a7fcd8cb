"""Where K12's and K13's time goes: their phases, timed apart.

    python scripts/probe_gather_wf_mm.py [--tc48]   # on a CUDA card (nvcc needed)

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

* K12's tc48 form (bf16, 32 < H <= 48) at se3ete2's stage-2 conv (x (2,
  3072, 384), H 36, K 15, A*Cout 384) on local random neighbours and on
  pair 0's ``neighbors_2`` (the synthetic se3ete2.3dmatch pair of
  ``chip_smoke.py``), through ``se3et_gather_wf_mm_tc48_bf16_phases``:
  whole (checked against the plain version), the gather alone and the
  product alone, with ptxas's notes on serialised ``wgmma``; beside
  the first design (``se3et_gather_wf_mm_wide_bf16``) and the unfused
  route (K1's tc form + ``torch.matmul``), by events and replayed from a
  CUDA graph (``selfcheck.replay_ms``).  For each neighbour set it prints
  the plan (shared memory, tiles) and the gather's reuse: valid
  references, distinct source rows per 48-row tile and the most in one
  tile.  ``--tc48`` runs this part alone.

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


TC48_PHASES = {"kernel": GATHER | PRODUCT, "gather only": GATHER, "product only": PRODUCT}


def _compile(tag, defines=(), only=None):
    """Starts nvcc on gather_wf_mm.cu with ``defines``; returns (tag, .so,
    process)."""
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    # (nvcc splits option values at commas)
    so = os.path.join(out_dir, "gather_wf_mm_" + "".join(c if c.isalnum() else "_" for c in tag)
                      + ".so")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v",
                             "-o", so, os.path.join(_build.CSRC_DIR, "gather_wf_mm.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tag, so, proc, only


def _finish(tag, so, proc, only):
    """Waits for a build and prints ptxas's registers, shared memory and
    spills of its kernels (of those whose name holds ``only``)."""
    log, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"nvcc failed ({tag}):\n{log}")
    lines = log.splitlines()
    for line in lines:
        if "wgmma" in line.lower():  # ptxas's notes on serialised wgmma (C75xx)
            print(f"[{tag}] {line.strip()}", flush=True)
    for i, line in enumerate(lines):
        if "Compiling entry" in line and (only is None or only in line):
            info = [x.strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x or "stack" in x]
            print(f"[{tag}] {line.split(chr(39))[1][:90]}: {' | '.join(info)}", flush=True)
    return ctypes.CDLL(so)


def _build_probe():
    return _finish(*_compile("probe"))


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
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)
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


def _se3ete2_neighbors_2():
    """Pair 0's neighbors_2 of se3ete2.3dmatch, as chip_smoke.py serves it."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete2.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)
    return torch.as_tensor(pair["neighbors_2"]).to(torch.int32), pair["points_2"].shape[1]


def _tile_reuse(nbr, ns):
    """The gather's reuse within tc48's 48-row tiles of flattened (b, q)
    rows: valid references, distinct source rows summed over the tiles,
    the tiles, and the most distinct rows in one tile."""
    b, nq, h = nbr.shape
    valid = (nbr >= 0) & (nbr < ns)
    tile = (torch.arange(b * nq, device=nbr.device).reshape(b, nq, 1)
            // wc.MM_TC48_ROWS).expand(b, nq, h)
    cloud = torch.arange(b, device=nbr.device)[:, None, None].expand(b, nq, h)
    key = torch.unique((tile * (b * ns) + cloud * ns + nbr.long())[valid])
    per_tile = torch.bincount(key // (b * ns))
    return int(valid.sum()), int(key.numel()), -(-b * nq // wc.MM_TC48_ROWS), int(per_tile.max())


def _k12_tc48(dev, g):
    """tc48 at se3ete2's stage-2 conv: its phases beside the first design
    and the unfused route."""
    lib = _finish(*_compile("tc48", only="tc48"))
    k, ac, ac_out = 15, 384, 384
    pair_nbr, pair_ns = _se3ete2_neighbors_2()
    for label, nbr, ns in (("local", torch.cat([selfcheck.local_neighbors(3072, 3072, 36, g, dev)
                                                for _ in range(2)]), 3072),
                           ("pair 0", pair_nbr.to(dev), pair_ns)):
        b, nq, h = nbr.shape
        x = torch.randn((b, ns, ac), generator=g).to(dev, torch.bfloat16)
        infl = (torch.rand((b, nq, h, k), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(torch.bfloat16)
        rhs_t = (torch.randn((ac_out, k * ac), generator=g) * (k * ac) ** -0.5).to(
            dev, torch.bfloat16)
        panels = wc.mm_panels(rhs_t.t(), k, ac)
        want = wc.gather_wf_mm_plain(x, nbr, infl, rhs_t.t())
        scale = float(want.abs().max())
        out = torch.empty((b, nq, ac_out), device=dev)
        tag = f"K12 tc48 {label} x({b}, {ns}, {ac}) nbr({b}, {nq}, {h}) W({k * ac}, {ac_out})"
        plan = wc.gather_wf_mm_tc48_plan(h, k, ac_out, b * nq)
        print(f"{tag}: plan {plan._asdict()} (shared memory bytes, tiles, rows a tile, ring "
              f"slots, staging buffers a warp)", flush=True)
        valid, distinct, tiles, most = _tile_reuse(nbr, ns)
        print(f"{tag}: {valid} valid references of {nbr.numel()}, {distinct} distinct source "
              f"rows summed over the {tiles} 48-row tiles ({valid / distinct:.2f} references a "
              f"distinct row; at most {most} distinct in a tile)", flush=True)
        fn = lib.se3et_gather_wf_mm_tc48_bf16_phases
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name, phases in TC48_PHASES.items():
            def call(fn=fn, phases=phases, name=name):
                # the current stream at each call: replay_ms captures on
                # a stream of its own
                _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(),
                                panels.data_ptr(), out.data_ptr(), b, ns, nq, h, h, k, ac,
                                ac_out, phases, torch.cuda.current_stream().cuda_stream),
                             name)
            err = ""
            if name == "kernel":
                out.zero_()
                call()
                torch.cuda.synchronize()
                e = float((out - want).abs().max()) / scale
                err = f", error {e:.3e} of scale{'' if e < 1e-2 else ' DISAGREES'}"
            print(f"{tag}: {name:12s} "
                  f"{selfcheck._time_ms(call, REPS):.4f} ms, replayed "
                  f"{selfcheck.replay_ms(call):.4f}{err}", flush=True)
        first = lib.se3et_gather_wf_mm_wide_bf16
        first.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        padded = wc._padded_influence(infl, h, torch.bfloat16)
        rhs_c = rhs_t.contiguous()

        def call_first():
            _build.check(first(x.data_ptr(), nbr.data_ptr(), padded.data_ptr(), rhs_c.data_ptr(),
                               out.data_ptr(), b, ns, nq, h, k, ac, ac_out,
                               torch.cuda.current_stream().cuda_stream), "first")

        def unfused():
            return wc.gather_wf(x, nbr, infl) @ rhs_t.t()
        for name, fn_ in (("first design", call_first), ("unfused route", unfused)):
            print(f"{tag}: {name:13s} {selfcheck._time_ms(fn_, REPS):.4f} ms, replayed "
                  f"{selfcheck.replay_ms(fn_):.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_mm: no CUDA device")
    print(_card())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    if "--tc48" not in sys.argv[1:]:
        lib = _build_probe()
        _k12(lib, dev, g)
        _k13(lib, dev, g)
    _k12_tc48(dev, g)


if __name__ == "__main__":
    main()
