"""Where K1's float32 rows form spends its time: ablations and cuts, timed in turns.

    python scripts/probe_gather_wf_f32.py   # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/gather_wf.cu`` once per variant into
``se3et_tpu_torch/_build/probe_k1f32/``, compiled with ``-Xptxas -v``
(registers and spills of ``gather_wf_rows_kernel``'s K = 15 and K = 16
instances printed, with the warps an SM holds by registers).  Three are the shipped cut cut
at one stage by ``GATHER_WF_ROWS_STAGE``:

* ``stream``: the wf stream alone (each item's stores, no gather);
* ``gather``: the gather alone (the valid neighbours' rows loaded and the
  FMAs run, no stores);
* ``form``: the whole form, as shipped;

one is a diagnostic (stage 3: the loads without the FMAs), and the others
the whole form at other cuts (``GATHER_WF_ROWS_NB``: valid neighbour rows
in a batch; ``GATHER_WF_ROWS_PIPE``: 1 the next batch's loads in flight
while this one's FMAs run, 0 one batch at a time; ``GATHER_WF_ROWS_WARPS``:
warps a block; ``GATHER_WF_ROWS_MINB``: blocks an SM asked of the compiler
(a register cap); ``GATHER_WF_ROWS_ORDER``: 1 a warp's rows strided by the
number of warps, all their slices, 0 a contiguous run of items a warp;
``GATHER_WF_ROWS_K15``: 0 runs K = 15 on the K = 16 instance).

On pair 0 of ``chip_smoke.py`` (se3ete.3dmatch's synthetic 3DMatch pair at
point_limit 20000) it takes the seven float32 training convs (the forwards
of K8's ten launches) and prints for each: the valid slots, the bytes bound
(x, indices, influence and wf, as ``selfcheck.check_gather_wf`` counts
them), the bytes the gather reads from L2 (a 16-byte unit of each valid
neighbour row for each unit of the row, beside wf's bytes) and the valid
references against the distinct source rows of 32-row query tiles (what
rows shared between the queries of a tile would save).  Then it times each
variant's kernel alone with CUDA events in turns (the list forward, then
backward; the smaller time kept), the K1 call (its rows form) and the
first design's call on the same inputs, each beside the bound and the
share of it reached, and checks that the form and every cut of stage 2
equal the first design bit for bit.  Last, the sums over a step (launches
per shape as in a step).  Prints the card's name and power limit first.
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

# a build: (GATHER_WF_ROWS_STAGE, NB rows in flight a lane, warps a block,
# ORDER, PIPE, MINB blocks an SM asked of the compiler, K15: K = 15 compiled
# apart)
SHIPPED = (2, 4, 4, 1, 1, 4, 1)
VARIANTS = {"stream": (0, *SHIPPED[1:]), "gather": (1, *SHIPPED[1:]), "form": SHIPPED,
            "no FMAs": (3, *SHIPPED[1:]), "one batch at a time": (2, 4, 4, 1, 0, 4, 1),
            "NB=8, one batch at a time": (2, 8, 4, 1, 0, 1, 1),
            "8 warps a block": (2, 4, 8, 1, 1, 2, 1), "no register cap": (2, 4, 4, 1, 1, 1, 1),
            "contiguous runs": (2, 4, 4, 0, 1, 4, 1), "K = 15 as 16": (2, 4, 4, 1, 1, 4, 0)}
# (what, neighbour set, source stage, A*C, launches a step)
SHAPES = (("stage-0 same", "neighbors_0", 0, 192, 1), ("s0 -> s1", "subsampling_0", 0, 192, 1),
          ("stage-1 same", "neighbors_1", 1, 384, 2), ("s1 -> s2", "subsampling_1", 1, 384, 1),
          ("stage-2 same", "neighbors_2", 2, 768, 2), ("s2 -> s3", "subsampling_2", 2, 768, 1),
          ("stage-3 same", "neighbors_3", 3, 1536, 2))
K = 15
REPS = 10
TILE = 32  # query rows a tile, for the sharing count
SM_REGS, SM_WARPS = 65536, 64


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_k1f32")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (stage, nb, warps, order, pipe, minb, k15)) in enumerate(VARIANTS.items()):
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DGATHER_WF_ROWS_STAGE={stage}",
             f"-DGATHER_WF_ROWS_NB={nb}", f"-DGATHER_WF_ROWS_WARPS={warps}",
             f"-DGATHER_WF_ROWS_ORDER={order}", f"-DGATHER_WF_ROWS_PIPE={pipe}",
             f"-DGATHER_WF_ROWS_MINB={minb}", f"-DGATHER_WF_ROWS_K15={k15}", "-Xptxas", "-v",
             "-o", lib, os.path.join(_build.CSRC_DIR, "gather_wf.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        stage, nb, warps, order, pipe, minb, k15 = VARIANTS[name]
        usage = []
        for i, line in enumerate(lines):  # the K = 15 instance, then K = 16
            kc = re.search(r"gather_wf_rows_kernelILi(\d+)E", line)
            if "Compiling entry function" in line and kc:
                after = "\n".join(lines[i + 1:i + 5])
                regs = int(re.search(r"Used (\d+) registers", after).group(1))
                spill = re.search(r"(\d+) bytes spill stores", after).group(1)
                per_warp = -(-regs * 32 // 256) * 256
                usage.append(f"K {kc.group(1)}: {regs} registers, {spill} bytes spilled, "
                             f"{min(SM_WARPS, SM_REGS // per_warp // warps * warps)} warps an SM "
                             "by registers")
        print(f"{name} (stage {stage}, NB={nb}, {warps} warps a block, order {order}, pipe "
              f"{pipe}, min blocks {minb}, K15 {k15}): {'; '.join(usage)}", flush=True)
        fn = ctypes.CDLL(lib).se3et_gather_wf_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _pair0():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)


def _sharing(nbr, ns):
    """Valid references over distinct source rows, per TILE-row query tile."""
    b, nq, h = nbr.shape
    valid = (nbr >= 0) & (nbr < ns)
    tile = torch.arange(nq, device=nbr.device)[None, :, None].expand(b, nq, h) // TILE
    key = ((torch.arange(b, device=nbr.device)[:, None, None] * (nq // TILE + 1) + tile)
           * (ns + 1) + nbr.long())
    return int(valid.sum()) / max(torch.unique(key[valid]).numel(), 1)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_f32: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    fns = _build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p = _pair0()
    g = torch.Generator().manual_seed(0)
    step = {}
    bad = []
    for what, key, src, ac, launches in SHAPES:
        nbr = torch.from_numpy(p[key]).to(dev, torch.int32)
        ns = p[f"points_{src}"].shape[1]
        b, nq, h = nbr.shape
        x = torch.randn((b, ns, ac), generator=g).to(dev)
        infl = torch.rand((b, nq, h, K), generator=g).to(dev) * (nbr < ns)[..., None]
        outs = {v: torch.empty((b, nq, K * ac), device=dev) for v in fns}

        def variant(v):
            def call():
                _build.check(fns[v](x.data_ptr(), nbr.data_ptr(), infl.data_ptr(),
                                    outs[v].data_ptr(), b, ns, nq, h, h, K, ac, stream),
                             f"gather_wf_rows variant {v}")
            return call

        runs = {v: variant(v) for v in fns}
        runs["K1 call"] = lambda: wc.gather_wf(x, nbr, infl)
        runs["first design call"] = lambda: wc._gather_wf_forward(x, nbr, infl, form="first")
        ms = {v: [] for v in runs}
        for order in (list(runs), list(runs)[::-1]):
            for v in order:
                ms[v].append(selfcheck._time_ms(runs[v], REPS))
        want = wc._gather_wf_forward(x, nbr, infl, form="first").view(torch.int32)
        same = torch.equal(wc.gather_wf(x, nbr, infl).view(torch.int32), want)
        cuts = [v for v, spec in VARIANTS.items() if spec[0] == 2]
        for v in cuts:
            runs[v]()
        cuts_same = all(torch.equal(outs[v].view(torch.int32), want) for v in cuts)
        nvalid = int((nbr < ns).sum())
        wf_bytes = b * nq * K * ac * 4
        nbytes = selfcheck._nbytes(x, nbr, infl) + wf_bytes
        bound, _ = selfcheck.bound(nbytes, 2.0 * nvalid * K * ac, torch.float32)
        l2 = nvalid * ac * 4 + selfcheck._nbytes(nbr, infl)
        best = {v: min(t) for v, t in ms.items()}
        cells = [f"{v} {t:.4f} ms ({bound / t:.1%})" for v, t in best.items()]
        print(f"{what} (x {launches} a step): x {tuple(x.shape)} nbr {tuple(nbr.shape)}, valid "
              f"slots {nvalid} ({nvalid / nbr.numel():.1%}); bound {bound:.4f} ms (bytes); "
              f"gather reads {l2 / 1e6:.1f} MB from L2 ({l2 / wf_bytes:.2f} x wf's "
              f"{wf_bytes / 1e6:.1f} MB); valid references per distinct row in {TILE}-row "
              f"query tiles {_sharing(nbr, ns):.2f}; " + "; ".join(cells)
              + f"; K1 call == first design bit for bit: {same}; every stage-2 cut == the first "
              f"design: {cuts_same}", flush=True)
        for v, t in list(best.items()) + [("bound", bound)]:
            step[v] = step.get(v, 0.0) + launches * t
        if not (same and cuts_same):
            bad.append(what)
        del x, infl, outs
    print("a step (10 launches), ms by events: " + ", ".join(
        f"{v} {t:.4f}" for v, t in step.items()), flush=True)
    if bad:
        sys.exit(f"probe_gather_wf_f32: the rows form differs from the first design on {bad}")


if __name__ == "__main__":
    main()
