"""Where K15's tiles form spends its time: its cuts and ablations, timed in
turns at the seven (stage, neighbour set) shapes of a device-influence pair
beside the first design.

    python scripts/probe_influence.py   # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/influence.cu`` once per variant into
``se3et_tpu_torch/_build/probe_k15/``, compiled with ``-Xptxas -v``
(registers and spills of the bf16 linear instance, and the plan at H 24,
K 15, printed):

* ``R=16 S=1``, the shipped form (a block a tile of 16 query rows, a
  thread a (row, h) slot, the valid slots listed, a thread a listed slot's
  K weights, a float32 staging tile, 16-byte evict-first stores, the
  H-sums read from the tile), and other rows a tile (R) and slots a thread
  (S): R=8 S=1, R=32 S=1, R=16 S=2, R=32 S=2 (a block takes at most 1024
  threads: R=32 S=1 refuses H > 32);
* ``sums not unrolled``: the H-sums' h loop not unrolled (the shipped
  build unrolls it 4 times, so four steps' loads go out together);
* ``no compaction``: a thread a slot computes its weights, valid or not
  (the sentinels' zeroed in the same pass);
* ``direct``: each lane computes the 16-byte runs of the output it stores
  straight from the coordinates (the staging tile kept for the H-sums);
* ``plain stores``: the shipped form with write-back stores;
* ``shuffle sums``: a warp a row, lane h, the H-sums by a shuffle chain in
  h order (H <= 32 only);

and four ablations of the shipped form: ``no weight stores`` (everything
but the (B, Nq, H, K) output's stores), ``constant weights`` (the tile
filled with 1, nothing read or computed; the stores and the H-sums), ``no
sqrt or division`` (the weight ``max(1 - sq * sigma, 0)``: its square root
and division cut) and ``geometry only`` (each valid slot's |rel|^2 stored
as its K weights: the indices, coordinates and list, no kernel point).

On pair 0 of ``chip_smoke.py`` (se3ete.3dmatch's synthetic 3DMatch pair at
point_limit 20000, without host influence: its points, neighbour sets,
kernel points and the backbone's radius / sigma schedule, linear mode, bf16
weights) it times every variant, the K15 call and the first design's
call three ways: replayed from a CUDA graph of 20 calls
(``selfcheck.replay_ms``: device time with the graph's launch gaps), with
CUDA events over 20 calls in turns (the list forward, then backward; the
smaller time kept; a call through ``ctypes`` takes ~0.01 ms of the host,
so small sets time the host), and by their device time (``torch.profiler``,
``selfcheck.device_ms``; its later sessions in a process lose kernels);
each beside the set's bound (bytes, as ``selfcheck.check_influence``
counts them) and the share of it reached replayed; a variant that refuses
a shape is listed with its CUDA error;
checks that every whole variant equals the first design bit for bit; then
sums over the pair, and last the four small sets (bound below 0.002 ms)
against their bounds: what a grouped launch could win.
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

VARIANTS = {
    "R=16 S=1": {},
    "R=8 S=1": {"INFLUENCE_TILES_R": 8},
    "R=32 S=1": {"INFLUENCE_TILES_R": 32},
    "R=16 S=2": {"INFLUENCE_TILES_SLOTS": 2},
    "R=32 S=2": {"INFLUENCE_TILES_R": 32, "INFLUENCE_TILES_SLOTS": 2},
    "sums not unrolled": {"INFLUENCE_TILES_SUM_UNROLL": 1},
    "no compaction": {"INFLUENCE_TILES_COMPACT": 0},
    "direct": {"INFLUENCE_TILES_DIRECT": 1},
    "plain stores": {"INFLUENCE_TILES_STREAM": 0},
    "shuffle sums": {"INFLUENCE_TILES_SHUFFLE": 1},
    "no weight stores": {"INFLUENCE_TILES_STAGE": 1},
    "constant weights": {"INFLUENCE_TILES_STAGE": 0},
    "no sqrt or division": {"INFLUENCE_TILES_STAGE": 3},
    "geometry only": {"INFLUENCE_TILES_STAGE": 4},
}
ABLATIONS = tuple(v for v, f in VARIANTS.items() if f.get("INFLUENCE_TILES_STAGE", 2) != 2)
REPS = 20
# the sets whose bound is below 0.002 ms: s1 -> s2, stage 2, s2 -> s3, stage 3
SMALL = 4


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
    out_dir = os.path.join(_build.BUILD_DIR, "probe_k15")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in flags.items()),
             "-Xptxas", "-v", "-o", lib, os.path.join(_build.CSRC_DIR, "influence.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        regs, spill = _usage(log, "influence_tiles_kernelI13__nv_bfloat16Li0E")
        first_regs, _ = _usage(log, "influence_kernelI13__nv_bfloat16E")
        plan = (ctypes.c_int * 3)()
        form = dll.se3et_influence_plan(24, 15, plan)
        print(f"{name}: tiles kernel (bf16, linear) {regs} registers, {spill} bytes spilled; "
              f"first design {first_regs} registers; plan at H 24, K 15 (form, rows, threads, "
              f"shared bytes) {[form, *plan]}", flush=True)
        fn = dll.se3et_influence_tiles_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _sets():
    """The seven (name, q, s, nbr, kernel points, sigma) of pair 0 on the
    card, in the backbone's order and radius / sigma schedule."""
    from se3et_tpu_torch.data.influence import _kernel_points_for
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    m = cfg.model
    p = synthetic_pair(0, cfg.pipeline, None, cfg.point_limit, synthetic_extent(cfg.dataset),
                       seed=cfg.seed)
    dev = torch.device("cuda")
    t = {k: torch.from_numpy(v).to(dev) for k, v in p.items() if k.startswith(
        ("points_", "neighbors_", "subsampling_"))}

    def kp(radius):
        return torch.as_tensor(_kernel_points_for(m, radius), dtype=torch.float32, device=dev)

    r, sg = m.init_radius, m.init_sigma
    sets = [("stage-0 same", t["points_0"], t["points_0"], t["neighbors_0"], kp(r), sg)]
    for st in range(1, cfg.pipeline.num_stages):
        mult = 2 ** (st - 1)
        sets.append((f"s{st - 1} -> s{st}", t[f"points_{st}"], t[f"points_{st - 1}"],
                     t[f"subsampling_{st - 1}"], kp(r * mult), sg * mult))
        sets.append((f"stage-{st} same", t[f"points_{st}"], t[f"points_{st}"],
                     t[f"neighbors_{st}"], kp(r * mult * 2), sg * mult * 2))
    return sets, m.epn.kp_influence


def _set(fns, name, q, s, nbr, kp, sigma, mode, totals):
    """Every variant, the K15 call and the first design at one set; the
    variants whose output differs from the first design's."""
    b, nq, h = nbr.shape
    k = kp.shape[0]
    code = wc.INFLUENCE_MODES[mode]
    nbr = nbr.to(torch.int32).contiguous()
    outs = {v: (wc._padded_empty((b, nq, h, k), torch.bfloat16, q.device),
                wc._padded_empty((b, nq, k), torch.float32, q.device)) for v in fns}

    def call(v):
        infl, inf_sum = outs[v]

        def run():
            status = fns[v](q.data_ptr(), s.data_ptr(), nbr.data_ptr(), kp.data_ptr(),
                            infl.data_ptr(), inf_sum.data_ptr(), b, nq, s.shape[1], h, k, code,
                            float(sigma), torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"variant {v}: CUDA error {status}")
        return run

    kw = dict(sigma=float(sigma), mode=mode, out_dtype=torch.bfloat16)
    runs, refused = {}, {}
    for v in fns:
        try:
            call(v)()
            runs[v] = call(v)
        except RuntimeError as e:  # the variant does not take this shape
            refused[v] = str(e).rsplit(" ", 1)[-1]
    runs["K15 call"] = lambda: wc.influence(q, s, nbr, kp, **kw)
    runs["first design call"] = lambda: wc.influence(q, s, nbr, kp, **kw, form="first")
    want = [selfcheck._bits(t) for t in wc.influence(q, s, nbr, kp, **kw, form="first")]
    differ = [v for v in runs if v in fns and v not in ABLATIONS and not all(
        torch.equal(selfcheck._bits(t), w) for t, w in zip(outs[v], want))]
    ms = {r: [] for r in runs}
    for order in (list(runs), list(runs)[::-1]):
        for r in order:
            ms[r].append(selfcheck._time_ms(runs[r], REPS))
    rep = {r: selfcheck.replay_ms(fn, REPS) for r, fn in runs.items()}
    dev = {r: selfcheck.device_ms(fn, "influence_kernel" if r == "first design call"
                                  else "influence_tiles_kernel") for r, fn in runs.items()}
    nbytes = selfcheck._nbytes(q, s, nbr, kp) + b * nq * h * k * 2 + b * nq * k * 4
    bound, _ = selfcheck.bound(nbytes, 13.0 * b * nq * h * k, torch.float32)
    valid = float(((nbr >= 0) & (nbr < s.shape[1])).float().mean())
    cells = [f"{r} {rep[r]:.4f} / {min(ms[r]):.4f} / {_ms(dev[r])} ms "
             f"({_share(bound, rep[r])})" for r in runs]
    print(f"{name}: q {tuple(q.shape)} s {tuple(s.shape)} nbr {tuple(nbr.shape)} K={k} sigma "
          f"{sigma:.4f}, valid slots {valid:.1%}, {nbytes / 1e6:.1f} MB; bound {bound:.4f} ms "
          f"(bytes); replayed / events / device (share of the bound replayed): "
          + "; ".join(cells)
          + (f"; refused (CUDA error): {refused}" if refused else "")
          + f"; differ from the first design: {differ or 'none'}", flush=True)
    totals.append((rep, {r: min(t) for r, t in ms.items()}, dev, bound))
    return differ


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def _share(bound, ms):
    return "not measured" if ms is None else f"{bound / ms:.1%}"


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_influence: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = _build_variants()
    sets, mode = _sets()
    totals, bad = [], []
    for name, q, s, nbr, kp, sigma in sets:
        bad += [f"{name}: {v}" for v in _set(fns, name, q, s, nbr, kp, sigma, mode, totals)]
    for what, part in (("the pair's seven sets", totals), (f"the {SMALL} small sets",
                                                           totals[-SMALL:])):
        bound = sum(b for *_, b in part)
        cells = []
        for r in (r for r in part[0][0] if all(r in t[0] for t in part)):
            rp, ev = (sum(t[i][r] for t in part) for i in (0, 1))
            dv = [t[2][r] for t in part]
            dv = None if None in dv else sum(dv)
            cells.append(f"{r} {rp:.4f} / {ev:.4f} / {_ms(dv)} ({_share(bound, rp)})")
        print(f"{what}, ms replayed / by events / device (bound {bound:.4f}; share replayed): "
              + ", ".join(cells), flush=True)
    if bad:
        sys.exit(f"probe_influence: variants differ from the first design: {bad}")


if __name__ == "__main__":
    main()
