"""Where K9's tiles form spends its time: its two passes apart, ablations and
cuts, timed in turns beside the first design.

    python scripts/probe_neighbor_max_bwd.py   # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/neighbor_max_bwd.cu`` nine times into
``se3et_tpu_torch/_build/probe_k9/``, compiled with ``-Xptxas -v``
(registers and spills of both kernels printed, with the shared memory a
warp of the sums kernel takes and the warps an SM holds by registers and
shared memory): the shipped form (32 source rows a tile, 2 channels a
lane, 4 runs in flight), two ablations of it
(``csrc/neighbor_max_bwd_tiles.cuh``):

* ``stream``: pass 2's stream alone (``MAX_BWD_TILES_STAGE=0``: the x tile,
  each (tile, query) run's out and share rows through the ring, dx
  written; no compare and no sum);
* ``no share store``: pass 1 without its store (``MAX_BWD_SHARE_STORE=0``);

and six other cuts of the whole form: 1 or 4 channels a lane, 2 or 8 runs
in flight, tiles of 64 rows (their plan built by
``windowed_conv.tile_plan``), and out and share interleaved by channel
into one scratch (``MAX_BWD_INTERLEAVE=1``: pass 2 makes one gathered
read a run).

At the three strided skips of training on pair 0 of ``chip_smoke.py``
(se3ete.3dmatch's synthetic 3DMatch pair at point_limit 20000: x (2,
20000, 768) over nbr (2, 10000, 24), (2, 10000, 1536) over (2, 2500, 32),
(2, 2500, 3072) over (2, 1024, 36)) and on ``selfcheck.local_neighbors``
of the same shapes, with float32 features drawn from a normal
distribution, it prints the bytes each pass must read (the gathered x
rows of pass 1; the x tile and the out and share rows of pass 2, at the
re-read factor of query rows a tile walks at 32 and 64 rows), then times
with CUDA events in turns (the list forward, then backward; the smaller
time kept) pass 1 alone, pass 2 alone and the two together for each
variant that changes them, the K9 call and the first design's call on the
same inputs, each beside the bound (bytes, as
``selfcheck.check_neighbor_max_bwd`` counts them) and the share of it
reached; and whether the shipped form and every cut equal the first
design bit for bit.  Last, the sums over a step (the three skips).
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, selfcheck  # noqa: E402
from se3et_tpu_torch.ops.kernels import windowed_conv as wc  # noqa: E402

# name -> -D flags: the three tie tests of pass 2 (x against out from the x
# tile, tie bits as ballot words, tie bits as a nibble a unit), each at 32
# source rows a tile, 2 channels a lane and 4 runs in flight, cut at a
# stage, and at other cuts
X, WORDS, NIBBLES = ({"MAX_BWD_TIE_MASK": m} for m in (0, 1, 2))
# the x tile as first built: 4 neighbour rows in flight a lane, dout read
# before the walk of the slots
X = {**X, "MAX_BWD_SHARE_WORDS": 48, "MAX_BWD_DOUT_EARLY": 1}
VARIANTS = {
    "nibbles": NIBBLES,
    "nibbles stream": {**NIBBLES, "MAX_BWD_TILES_STAGE": 0},
    "nibbles no share store": {**NIBBLES, "MAX_BWD_SHARE_STORE": 0},
    "nibbles NB=4": {**NIBBLES, "MAX_BWD_SHARE_WORDS": 48},
    "nibbles dout early": {**NIBBLES, "MAX_BWD_DOUT_EARLY": 1},
    "nibbles cached stores": {**NIBBLES, "MAX_BWD_STREAM_STORES": 0},
    "nibbles shuffled": {**NIBBLES, "MAX_BWD_BITS_SMEM": 0},
    "nibbles R=2": {**NIBBLES, "MAX_BWD_TILES_RING": 2},
    "nibbles R=8": {**NIBBLES, "MAX_BWD_TILES_RING": 8},
    "nibbles T=64": {**NIBBLES, "MAX_BWD_TILES_T": 64},
    "ballot words": WORDS,
    "ballot words stream": {**WORDS, "MAX_BWD_TILES_STAGE": 0},
    "x tile": X,
    "x tile stream": {**X, "MAX_BWD_TILES_STAGE": 0},
    "x tile no share store": {**X, "MAX_BWD_SHARE_STORE": 0},
    "x tile VEC=1": {**X, "MAX_BWD_TILES_VEC": 1},
    "x tile VEC=4": {**X, "MAX_BWD_TILES_VEC": 4},
    "x tile T=64": {**X, "MAX_BWD_TILES_T": 64},
    "interleaved": {**X, "MAX_BWD_INTERLEAVE": 1},
}
# the passes each variant is timed in (1 the shares, 2 the sums, 3 both;
# the stage cuts in theirs alone)
PASSES = {"nibbles": (1, 2, 3), "nibbles stream": (2,), "nibbles no share store": (1,),
          "ballot words": (1, 2, 3), "ballot words stream": (2,), "x tile": (1, 2, 3),
          "x tile stream": (2,), "x tile no share store": (1,), "interleaved": (1, 2, 3)}
SKIPS = (("s0 -> s1", "subsampling_0", 0, 768), ("s1 -> s2", "subsampling_1", 1, 1536),
         ("s2 -> s3", "subsampling_2", 2, 3072))
REPS = 10
# an H100 SM: registers, shared memory for blocks (and 1 KB reserved a
# block), resident blocks
SM_REGS, SM_SMEM, SM_BLOCK_SMEM, SM_BLOCKS = 65536, 228 * 1024, 1024, 32


def _warps_per_sm(regs, smem):
    by_regs = SM_REGS // (-(-regs * 32 // 256) * 256)
    return min(SM_BLOCKS, by_regs, SM_SMEM // (smem + SM_BLOCK_SMEM))


def _usage(log, kernel):
    """(registers, spill store bytes) of the first entry function whose
    mangled name holds ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            after = "\n".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", after)
            spill = re.search(r"(\d+) bytes spill stores", after)
            return (int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else None)
    return None, None


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_k9")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in flags.items()),
             "-Xptxas", "-v", "-o", lib, os.path.join(_build.CSRC_DIR, "neighbor_max_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        cfg = (ctypes.c_int * 6)()
        dll.se3et_neighbor_max_bwd_tiles_config(cfg)
        tile, vec, ring, inter, bits, smem = list(cfg)
        s_regs, s_spill = _usage(log, "max_bwd_share_rows_kernelILi3E")
        t_regs, t_spill = _usage(log, "max_bwd_tiles_kernel")
        print(f"{name} (T={tile} VEC={vec} R={ring} interleaved={inter} tie test={bits}): "
              f"shares kernel (SU 3) "
              f"{s_regs} registers, {s_spill} bytes spilled; sums kernel {t_regs} registers, "
              f"{t_spill} bytes spilled, {smem} bytes of shared memory a warp"
              + (f", {_warps_per_sm(t_regs, smem)} warps an SM" if t_regs else ""), flush=True)
        fn = dll.se3et_neighbor_max_bwd_tiles_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, tile, inter)
    return fns


def _pair0():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)


def _shape(fns, what, nbr, ns, ac, dev, g, totals):
    """Every variant's passes, the K9 call and the first design at one
    shape; True where every whole form equals the first design bit for
    bit."""
    stream = torch.cuda.current_stream().cuda_stream
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(dev)
    out = wc.neighbor_max(x, nbr)
    dout = torch.randn((b, nq, ac), generator=g).to(dev)
    plans = {t: (wc._shared_tile_plan(nbr, ns) if t == wc.GATHER_WF_BWD_TILE
                 else wc.tile_plan(nbr, ns, t)) for t in {t for _, t, _ in fns.values()}}
    work = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = {v: torch.empty((b, nq, ac * (2 if inter else 1)), device=dev)
               for v, (_, _, inter) in fns.items()}
    dxs = {v: torch.empty((b, ns, ac), device=dev) for v in fns}
    # the tie bits, in 16-byte units: ceil(AC / 64) a slot holds either layout
    bits = torch.empty((b, nq * h, -(-ac // 64), 4), dtype=torch.int32, device=dev)

    def call(v, passes):
        fn, t, _ = fns[v]
        ent, off = plans[t]

        def run():
            _build.check(fn(x.data_ptr(), nbr.data_ptr(), out.data_ptr(), dout.data_ptr(),
                            ent.data_ptr(), off.data_ptr(), scratch[v].data_ptr(),
                            bits.data_ptr(), dxs[v].data_ptr(), work.data_ptr(), b, ns, nq, h,
                            ac, t, passes,
                            stream), f"neighbor_max_bwd variant {v}")
        return run

    runs = {}
    for v in fns:
        for p in PASSES.get(v, (3,)):
            runs[f"{v} {('', 'pass 1', 'pass 2', 'both')[p]}"] = call(v, p)
    runs["K9 call"] = lambda: wc.neighbor_max_bwd(dout, x, out, nbr)
    runs["first design call"] = lambda: wc._neighbor_max_bwd(dout, x, out, nbr, form="first")
    for v in fns:  # the shares each pass 2 alone reads, the whole forms' dx
        call(v, 3)()
    want = wc._neighbor_max_bwd(dout, x, out, nbr, form="first").view(torch.int32)
    whole = [v for v, flags in VARIANTS.items()
             if not {"MAX_BWD_TILES_STAGE", "MAX_BWD_SHARE_STORE"} & set(flags)]
    same = {v: torch.equal(dxs[v].view(torch.int32), want) for v in whole}
    same["K9 call"] = torch.equal(wc.neighbor_max_bwd(dout, x, out, nbr).view(torch.int32), want)
    ms = {r: [] for r in runs}
    for order in (list(runs), list(runs)[::-1]):
        for r in order:
            ms[r].append(selfcheck._time_ms(runs[r], REPS))
    nvalid = int(((nbr >= 0) & (nbr < ns)).sum())
    row = ac * 4
    nbytes = selfcheck._nbytes(x, nbr, out, dout) + b * ns * row
    bound, _ = selfcheck.bound(nbytes, 0.0, torch.float32)
    rereads = {t: selfcheck.tile_rereads(nbr, ns, t) for t in plans}
    reads = (f"pass 1 gathers {nvalid * row / 1e6:.1f} MB of x rows ({nvalid / (b * ns):.3f} "
             f"x), reads out + dout {2 * b * nq * row / 1e6:.1f} MB, writes share "
             f"{b * nq * row / 1e6:.1f} MB; pass 2 reads x {b * ns * row / 1e6:.1f} MB and out "
             f"+ share " + ", ".join(f"{2 * r * b * nq * row / 1e6:.1f} MB at T={t} (re-read "
                                     f"{r:.3f})" for t, r in sorted(rereads.items()))
             + f", writes dx {b * ns * row / 1e6:.1f} MB; with tie bits pass 1 writes and pass 2 "
             f"reads {nvalid * ac / 8 / 1e6:.1f} MB of ballot words or "
             f"{nvalid * ac / 4 / 1e6:.1f} MB of nibbles, and pass 2 reads share rows "
             + ", ".join(f"{r * b * nq * row / 1e6:.1f} MB at T={t}"
                         for t, r in sorted(rereads.items()))
             + " and no x")
    cells = [f"{r} {min(t):.4f} ms ({bound / min(t):.1%})" for r, t in ms.items()]
    print(f"{what}: x {tuple(x.shape)} nbr {tuple(nbr.shape)}, valid slots {nvalid}; {reads}; "
          f"bound {bound:.4f} ms (bytes); by events (share of the bound): " + "; ".join(cells)
          + f"; bit for bit the first design's dx: {same}", flush=True)
    for r, t in ms.items():
        totals[r] = totals.get(r, 0.0) + min(t)
    totals["bound"] = totals.get("bound", 0.0) + bound
    return all(same.values())


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_neighbor_max_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = _build_variants()
    cfg = (ctypes.c_int * 6)()
    _build._library("neighbor_max_bwd").se3et_neighbor_max_bwd_tiles_config(cfg)
    print(f"the shipped build (T, VEC, R, interleaved, tie test, shared bytes): {list(cfg)}",
          flush=True)
    dev = torch.device("cuda")
    p = _pair0()
    g = torch.Generator().manual_seed(0)
    bad = []
    for kind in ("pair 0", "local"):
        totals = {}
        for what, key, src, ac in SKIPS:
            nbr = torch.from_numpy(p[key]).to(dev)
            ns = p[f"points_{src}"].shape[1]
            if kind == "local":
                nbr = torch.cat([selfcheck.local_neighbors(nbr.shape[1], ns, nbr.shape[2], g, dev)
                                 for _ in range(2)])
            if not _shape(fns, f"{what} ({kind})", nbr, ns, ac, dev, g, totals):
                bad.append(f"{what} ({kind})")
        print(f"a step's three skips ({kind}), ms by events: " + ", ".join(
            f"{r} {t:.4f}" for r, t in totals.items()), flush=True)
    if bad:
        sys.exit(f"probe_neighbor_max_bwd: a form differs from the first design on {bad}")


if __name__ == "__main__":
    main()
