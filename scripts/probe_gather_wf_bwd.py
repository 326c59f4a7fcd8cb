"""Where K8's tiles form spends its time: ablations and cuts, timed in turns.

    python scripts/probe_gather_wf_bwd.py   # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/gather_wf_bwd.cu`` twelve times into
``se3et_tpu_torch/_build/probe_k8/``, compiled with ``-Xptxas -v``
(registers and spills of each printed, with the shared memory a warp takes
and the warps an SM holds by registers and shared memory).  Three are the
shipped cut (32 source rows a tile, 2 channels a lane, 2 runs in flight)
cut at one stage by ``GATHER_WF_BWD_TILES_STAGE``
(``csrc/gather_wf_bwd_tiles.cuh``):

* ``stream``: the dwf stream alone (each (tile, query) run's rows through
  the ring into registers);
* ``walk``: + the walk of every entry (influence rows staged and read, the
  sums in shared memory updated) without the FMA chains;
* ``form``: the whole form, as shipped;

and six are the whole form at other cuts (``GATHER_WF_BWD_TILES_T``,
``_VEC``, ``_RING``: tile rows, channels a lane, runs in flight).  Three
more build the tile plan's kernel with 8, 16 and 32 warps a tile
(``GATHER_WF_BWD_PLAN_SPLIT``; 64 as shipped).

On pair 0 of ``chip_smoke.py`` (se3ete.3dmatch's synthetic 3DMatch pair at
point_limit 20000) it takes the same-level sets of stages 0-3 (dwf (2,
20000, 2880), (2, 10000, 5760), (2, 2500, 11520), (2, 1024, 23040)), prints
the tile plan's re-read factor (distinct (tile, query) pairs over Nq), then
times each variant's kernel alone with CUDA events in turns (the list
forward, then backward; the smaller time kept), the whole K8 call and the
first design's call on the same inputs, each beside the bound (bytes, as
``selfcheck.check_gather_wf_bwd`` counts them) and the share of it
reached.  Also the peak device memory each form's call allocates (its
index built), and whether the shipped form and every cut equal the first
design bit for bit.

Last, the index builds of one training step on fresh neighbour tensors
(as every step of real training has): before the tiles form, one reverse
index for each of the seven sets K8 runs on (K9's three strided sets
share them); now, the same seven and a tile plan merged from each on the
card (``windowed_conv.tile_plan_from_reverse_index``).  Each is timed with
CUDA events over the whole list, in turns (before, now, now, before; REPS
each, the median kept), beside each set's reverse index, its plan from it
and the plan's plain version built by a sort of its own
(``windowed_conv.tile_plan``), and the device time alone of the reverse
index's kernels and of the plan kernel (``torch.profiler``); and the plan
kernel at each number of warps a tile, by events, held against the plain
version.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, selfcheck  # noqa: E402
from se3et_tpu_torch.ops.kernels import windowed_conv as wc  # noqa: E402

SHIPPED = (wc.GATHER_WF_BWD_TILE, 2, 2)  # (T, VEC, RING) as compiled by default
# name -> (GATHER_WF_BWD_TILES_STAGE, (T, VEC, RING))
VARIANTS = {"stream": (0, SHIPPED), "walk": (1, SHIPPED), "form": (2, SHIPPED)}
VARIANTS.update({f"T={t} VEC={v} R={r}": (2, (t, v, r)) for t, v, r in (
    (32, 2, 3), (32, 2, 4), (64, 2, 2), (64, 2, 3), (32, 4, 3), (32, 4, 4))})
PLAN_SPLITS = (8, 16, 32)  # GATHER_WF_BWD_PLAN_SPLIT; 64 as shipped
K = 15
REPS = 10
# an H100 SM: registers, shared memory for blocks (and 1 KB reserved a
# block), resident blocks
SM_REGS, SM_SMEM, SM_BLOCK_SMEM, SM_BLOCKS = 65536, 228 * 1024, 1024, 32


def _warps_per_sm(regs, smem):
    by_regs = SM_REGS // (-(-regs * 32 // 256) * 256)
    return min(SM_BLOCKS, by_regs, SM_SMEM // (smem + SM_BLOCK_SMEM))


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_k8")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (stage, (t, v, r))) in enumerate(VARIANTS.items()):
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DGATHER_WF_BWD_TILES_STAGE={stage}",
             f"-DGATHER_WF_BWD_TILES_T={t}", f"-DGATHER_WF_BWD_TILES_VEC={v}",
             f"-DGATHER_WF_BWD_TILES_RING={r}", "-Xptxas", "-v", "-o", lib,
             os.path.join(_build.CSRC_DIR, "gather_wf_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    plans = {}
    for g in PLAN_SPLITS:
        lib = os.path.join(out_dir, f"plan{g}.so")
        plans[g] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DGATHER_WF_BWD_PLAN_SPLIT={g}", "-o", lib,
             os.path.join(_build.CSRC_DIR, "gather_wf_bwd.cu")]))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        regs, spill = None, None
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "gather_wf_bwd_tiles_kernel" in line:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
        stage, (t, v, r) = VARIANTS[name]
        smem = (t * 32 * v + r * K * 32 * v + 2 * 32 * 16) * 4
        usage = (f"{regs.group(1) if regs else '?'} registers, "
                 f"{spill.group(1) if spill else '?'} bytes spilled, {smem} bytes of shared "
                 f"memory a warp"
                 + (f", {_warps_per_sm(int(regs.group(1)), smem)} warps an SM" if regs else ""))
        print(f"{name} (stage {stage}, T={t} VEC={v} R={r}): {usage}", flush=True)
        fn = ctypes.CDLL(lib).se3et_gather_wf_bwd_tiles_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, t)
    plan_fns = {}
    for g, (lib, proc) in plans.items():
        if proc.wait():
            sys.exit(f"nvcc failed for the plan kernel at {g} warps a tile")
        plan_fns[g] = ctypes.CDLL(lib).se3et_gather_wf_bwd_tile_plan
    plan_fns[64] = _build._library("gather_wf_bwd").se3et_gather_wf_bwd_tile_plan
    for fn in plan_fns.values():
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns, plan_fns


def _pair0():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)


def _peak_mb(fn, dev):
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20


def _events_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _kernels(fns, p, dev):
    """The variants, the K8 call and the first design at the four same-level
    shapes; the names of the shapes where a form differs from the first
    design."""
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    bad = []
    for name, key, src, ac in (("stage-0 same", "neighbors_0", 0, 192),
                               ("stage-1 same", "neighbors_1", 1, 384),
                               ("stage-2 same", "neighbors_2", 2, 768),
                               ("stage-3 same", "neighbors_3", 3, 1536)):
        nbr = torch.from_numpy(p[key]).to(dev)
        ns = p[f"points_{src}"].shape[1]
        b, nq, h = nbr.shape
        dwf = torch.randn((b, nq, K * ac), generator=g).to(dev)
        infl = torch.rand((b, nq, h, K), generator=g).to(dev) * (nbr < ns)[..., None]
        plans = {t: wc.tile_plan(nbr, ns, t) for t in {t for _, t in fns.values()}}
        outs = {v: torch.empty((b, ns, ac), device=dev) for v in fns}
        work = torch.empty(1, dtype=torch.int32, device=dev)

        def variant(v):
            fn, t = fns[v]
            ent, off = plans[t]

            def call():
                _build.check(fn(dwf.data_ptr(), infl.data_ptr(), ent.data_ptr(),
                                off.data_ptr(), outs[v].data_ptr(), work.data_ptr(), b, ns, nq,
                                h, h, K, ac, t, stream), f"gather_wf_bwd variant {v}")
            return call

        runs = {v: variant(v) for v in fns}
        runs["K8 call"] = lambda: wc.gather_wf_bwd(dwf, nbr, infl, ns)
        runs["first design call"] = lambda: wc._gather_wf_bwd(dwf, nbr, infl, ns, form="first")
        ms = {v: [] for v in runs}
        for order in (list(runs), list(runs)[::-1]):
            for v in order:
                ms[v].append(selfcheck._time_ms(runs[v], REPS))
        want = wc._gather_wf_bwd(dwf, nbr, infl, ns, form="first").view(torch.int32)
        same = torch.equal(wc.gather_wf_bwd(dwf, nbr, infl, ns).view(torch.int32), want)
        cuts = [v for v, (stage, _) in VARIANTS.items() if stage == 2]
        for v in cuts:
            runs[v]()
        cuts_same = all(torch.equal(outs[v].view(torch.int32), want) for v in cuts)
        peaks = {f: _peak_mb(lambda f=f: wc._gather_wf_bwd(dwf, nbr, infl, ns, form=f), dev)
                 for f in ("tiles", "first")}
        nbytes = (selfcheck._nbytes(dwf, infl) + 4 * (b * nq * h + b * (ns + 1))
                  + b * ns * ac * 4)
        bound, _ = selfcheck.bound(nbytes, 0.0, torch.float32)
        reread = selfcheck.tile_rereads(nbr, ns, wc.GATHER_WF_BWD_TILE)
        cells = [f"{v} {min(t):.4f} ms ({bound / min(t):.1%} of the bound)"
                 for v, t in ms.items()]
        print(f"{name}: dwf {tuple(dwf.shape)} nbr {tuple(nbr.shape)} Ns={ns}, valid slots "
              f"{int((nbr < ns).sum())}; re-read factor {reread:.3f} "
              f"(T={wc.GATHER_WF_BWD_TILE}); bound {bound:.4f} ms (bytes); " + "; ".join(cells)
              + f"; peak memory of the call: tiles {peaks['tiles']:.1f} MiB, first design "
              f"{peaks['first']:.1f} MiB (drop {peaks['first'] - peaks['tiles']:.1f}); tiles == "
              f"first design bit for bit: {same}; every cut == the first design: {cuts_same}",
              flush=True)
        if not (same and cuts_same):
            bad.append(name)
        del dwf, infl, outs
    return bad


def _index_builds(p, dev):
    """The index builds of one training step on fresh neighbour tensors,
    before the tiles form and now."""
    sets = {}
    for i in range(4):
        sets[f"neighbors_{i}"] = (torch.from_numpy(p[f"neighbors_{i}"]).to(dev),
                                  p[f"points_{i}"].shape[1])
    for i in range(3):  # strided: over the finer level's sources
        sets[f"subsampling_{i}"] = (torch.from_numpy(p[f"subsampling_{i}"]).to(dev),
                                    p[f"points_{i}"].shape[1])

    def plan(nbr, ns):
        _, nq, h = nbr.shape
        return wc.tile_plan_from_reverse_index(*wc.reverse_index(nbr, ns), nq, h, ns)

    def before():
        for nbr, ns in sets.values():
            wc.reverse_index(nbr, ns)

    def now():
        for nbr, ns in sets.values():
            plan(nbr, ns)

    before(), now()  # warm-up: the sorts' first calls
    ms = {"before": [], "now": []}
    for who in ("before", "now", "now", "before"):
        fn = before if who == "before" else now
        ms[who].extend(_events_ms(fn) for _ in range(REPS))
    per_set = {}
    for key, (nbr, ns) in sets.items():
        _, nq, h = nbr.shape
        rev = wc.reverse_index(nbr, ns)
        per_set[key] = [statistics.median(_events_ms(f) for _ in range(REPS)) for f in (
            lambda: wc.reverse_index(nbr, ns),
            lambda: wc.tile_plan_from_reverse_index(*rev, nq, h, ns),
            lambda: wc.tile_plan(nbr, ns, wc.GATHER_WF_BWD_TILE))]
    print(f"index builds of one step on fresh neighbour tensors (CUDA events, median of "
          f"{2 * REPS}): before (7 reverse indexes) {statistics.median(ms['before']):.4f} ms, "
          f"now (7 reverse indexes + 7 tile plans merged from them) "
          f"{statistics.median(ms['now']):.4f} ms; per set, reverse index / tile plan from it "
          f"/ the plan's plain version (a sort of its own) (median of {REPS}): "
          + ", ".join(f"{k} {a:.4f} / {b:.4f} / {c:.4f}" for k, (a, b, c) in per_set.items()),
          flush=True)
    # device time alone (torch.profiler; last, as a profiler session makes
    # later timing in the process less exact)
    dev_ms = {}
    for key, (nbr, ns) in sets.items():
        _, nq, h = nbr.shape
        rev = wc.reverse_index(nbr, ns)
        dev_ms[key] = (selfcheck.device_ms(lambda: wc.reverse_index(nbr, ns), ""),
                       selfcheck.device_ms(lambda: wc.tile_plan_from_reverse_index(
                           *rev, nq, h, ns), "tile_plan_kernel"))
    print("device ms per set (torch.profiler, mean of 10), the reverse index's kernels / the "
          "plan kernel: " + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in dev_ms.items())
          + f"; a step: {sum(a for a, _ in dev_ms.values()):.4f} / "
          f"{sum(b for _, b in dev_ms.values()):.4f}", flush=True)


def _plan_splits(plan_fns, p, dev):
    """The plan kernel at each number of warps a tile, per set by events;
    the names of the sets where one differs from the plain version."""
    stream = torch.cuda.current_stream().cuda_stream
    total, bad = {g: 0.0 for g in plan_fns}, []
    for key, src in (("neighbors_0", 0), ("neighbors_1", 1), ("neighbors_2", 2),
                     ("neighbors_3", 3), ("subsampling_0", 0), ("subsampling_1", 1),
                     ("subsampling_2", 2)):
        nbr = torch.from_numpy(p[key]).to(dev)
        ns = p[f"points_{src}"].shape[1]
        b, nq, h = nbr.shape
        order, offsets = wc.reverse_index(nbr, ns)
        want_ent, want_off = wc.tile_plan(nbr, ns, wc.GATHER_WF_BWD_TILE)
        cells = []
        for g, fn in sorted(plan_fns.items()):
            ent, off = torch.empty_like(order), torch.empty_like(want_off)

            def call():
                _build.check(fn(order.data_ptr(), offsets.data_ptr(), ent.data_ptr(),
                                off.data_ptr(), b, ns, nq, h, wc.GATHER_WF_BWD_TILE, stream),
                             "tile plan variant")

            ms = selfcheck._time_ms(call, REPS)
            total[g] += ms
            if not (torch.equal(off, want_off) and all(
                    torch.equal(ent[i, lo:hi], want_ent[i, lo:hi])
                    for i, (lo, hi) in enumerate(off[:, [0, -1]].tolist()))):
                bad.append(f"{key} at {g}")
            cells.append(f"{g} {ms:.4f}")
        print(f"tile plan kernel, {key}, warps a tile: ms by events: " + ", ".join(cells),
              flush=True)
    print("tile plan kernel, a step (7 sets): " + ", ".join(
        f"{g} warps a tile {t:.4f} ms" for g, t in sorted(total.items())), flush=True)
    return bad


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns, plan_fns = _build_variants()
    dev = torch.device("cuda")
    p = _pair0()
    bad = _kernels(fns, p, dev) + _plan_splits(plan_fns, p, dev)
    _index_builds(p, dev)
    if bad:
        sys.exit(f"probe_gather_wf_bwd: the tiles form or its plan differs from its reference "
                 f"on {bad}")


if __name__ == "__main__":
    main()
