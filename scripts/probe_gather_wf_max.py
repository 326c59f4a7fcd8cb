"""Where K14's time goes: its tc form's layouts beside its parts, timed on
the s1 -> s2 strided block's real neighbours.

    python scripts/probe_gather_wf_max.py      # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/gather_wf_max.cu`` and ``gather_wf.cu`` into
``se3et_tpu_torch/_build/probe/`` with ``-Xptxas -v`` and prints each
kernel's registers and spills.  Then, at the serving shape of se3ete.3dmatch
(x (2, 10000, 384), nbr (2, 2500, 32), K 15, skip payload (2, 10000,
1536), bf16) on pair 0 of ``chip_smoke.py`` (the synthetic pair at
point_limit 20000) and on local random neighbours
(``selfcheck.local_neighbors``) of the same shape, times with CUDA events
(20 launches after a warm-up, in two passes, the second in reverse order):

* the tc form in each layout, through ``se3et_gather_wf_max_tc_variant``:
  (a) "serial", every warp its run of conv items then its run of skip
  items (the serving layout); "alternate", odd warps the skip run first;
  "strided", after its conv run every warp w of n the skip items w, w +
  n, ..; "queue", the skip items taken one at a time from a counter (one
  ``atomicAdd`` an item, the counter zeroed by a memset before each
  launch, timed too); "queue after item w", item w first, then the
  counter's; the queues and the strided layout with a 3-slot ring (7 KB a
  warp, the serving tiling), and the queue after item w with it at most
  80 registers (6 blocks an SM); (b) "split", one grid of conv blocks and skip
  blocks, the conv's share of the blocks by the two parts' bytes, and at
  one half; (c) "roles", blocks of 4 conv warps and 2 or 4 skip warps;
* beside them the first design, the conv alone (K1's tc form), the skip
  alone (K2's rows form) and the two in turn (the unfused route);

each with the bytes it must move (the valid neighbour rows of x and of the
payload, each whole, read from L2, and both outputs written) and the rate
over them; every wf is checked bit for bit against K1's and every pooled
against K2's.
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

REPS = 20
K, AC, AC2 = 15, 384, 1536
SERIAL, ALTERNATE, SPLIT, ROLES, STRIDED, QUEUE, QUEUE1 = 0, 1, 2, 3, 4, 5, 6
RING3, MIN_BLOCKS6 = 1, 2


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _build_probe():
    """The two sources built with -Xptxas -v; prints each kernel's
    registers and spills, returns K14's library."""
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("gather_wf_max", "gather_wf"):
        so = os.path.join(out_dir, f"{name}_probe.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             os.path.join(_build.CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}.cu:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("registers" in line or "spill" in line):
                print(f"{name}.cu {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
    return ctypes.CDLL(procs["gather_wf_max"][0])


def _pair_subsampling():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.point_limit,
                          synthetic_extent(cfg.dataset), seed=cfg.seed)
    return (torch.as_tensor(pair["subsampling_1"]).to(torch.int32),
            pair["points_1"].shape[1])


def _shape(lib, dev, g, tag, nbr, ns):
    variant = lib.se3et_gather_wf_max_tc_variant
    variant.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    b, nq, h = nbr.shape
    bf = torch.bfloat16
    x = torch.randn((b, ns, AC), generator=g).to(dev, bf)
    infl = (torch.rand((b, nq, h, K), generator=g).to(dev) * (nbr < ns)[..., None]).to(bf)
    x2 = torch.randn((b, ns, AC2), generator=g).to(dev, bf)
    want_wf, want_pooled = wc.gather_wf(x, nbr, infl), wc.neighbor_max(x2, nbr)
    valid = int(((nbr >= 0) & (nbr < ns)).sum())
    conv_bytes = valid * AC * 2 + want_wf.numel() * 2
    skip_bytes = valid * AC2 * 2 + want_pooled.numel() * 2
    permille = round(1000 * conv_bytes / (conv_bytes + skip_bytes))
    print(f"{tag}: x {tuple(x.shape)} nbr {tuple(nbr.shape)} skip {tuple(x2.shape)} bf16: "
          f"{valid} valid slots of {nbr.numel()}; conv {conv_bytes / 1e6:.1f} MB, skip "
          f"{skip_bytes / 1e6:.1f} MB to move (valid rows read from L2 + output written); "
          f"plan {tuple(wc.gather_wf_max_plan(h, bf, AC, AC2))}", flush=True)
    wf, pooled = torch.empty_like(want_wf), torch.empty_like(want_pooled)
    stream = torch.cuda.current_stream().cuda_stream

    work = torch.empty(1, dtype=torch.int32, device=dev)  # the queues' counter

    def layout(code, skip_warps=0, share=0, option=0):
        def call():
            _build.check(variant(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), wf.data_ptr(),
                                 x2.data_ptr(), pooled.data_ptr(), work.data_ptr(), b, ns, nq,
                                 h, h, K, AC, AC2, code, skip_warps, share, option, stream),
                         f"layout {code} option {option}")
            return wf, pooled
        return call

    runs = {
        "tc form (wrapper)": (lambda: wc.gather_wf_max(x, nbr, infl, x2), "both"),
        "(a) serial": (layout(SERIAL), "both"),
        "(a) alternate": (layout(ALTERNATE), "both"),
        f"(b) split {permille / 10:.1f} % conv": (layout(SPLIT, share=permille), "both"),
        "(b) split 50 % conv": (layout(SPLIT, share=500), "both"),
        "(c) roles 4 + 2": (layout(ROLES, skip_warps=2), "both"),
        "(c) roles 4 + 4": (layout(ROLES, skip_warps=4), "both"),
        "(a) strided": (layout(STRIDED), "both"),
        "(a) queue": (layout(QUEUE), "both"),
        "(a) queue after item w": (layout(QUEUE1), "both"),
        "(a) queue 3 slots": (layout(QUEUE, option=RING3), "both"),
        "(a) queue after w 3 slots": (layout(QUEUE1, option=RING3), "both"),
        "(a) queue after w 3 slots <= 80 regs": (layout(QUEUE1, option=RING3 | MIN_BLOCKS6),
                                                 "both"),
        "(a) strided 3 slots": (layout(STRIDED, option=RING3), "both"),
        "first design": (lambda: wc._gather_wf_max_forward(x, nbr, infl, x2, "first"), "none"),
        "conv alone (K1 tc)": (lambda: (wc.gather_wf(x, nbr, infl), None), "conv"),
        "skip alone (K2 rows)": (lambda: (None, wc.neighbor_max(x2, nbr)), "skip"),
        "unfused route K1 + K2": (lambda: (wc.gather_wf(x, nbr, infl),
                                           wc.neighbor_max(x2, nbr)), "both"),
    }
    moved = {"both": conv_bytes + skip_bytes, "none": conv_bytes + skip_bytes,
             "conv": conv_bytes, "skip": skip_bytes}
    ms = {name: [] for name in runs}
    with torch.no_grad():
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms[name].append(selfcheck._time_ms(runs[name][0], REPS))
        for name, (fn, part) in runs.items():
            wf.zero_()
            pooled.zero_()
            got_wf, got_pooled = fn()
            torch.cuda.synchronize()
            same = ((got_wf is None or part == "none" or torch.equal(got_wf, want_wf))
                    and (got_pooled is None or torch.equal(got_pooled.view(torch.int16),
                                                           want_pooled.view(torch.int16))))
            t = min(ms[name])
            print(f"{tag}: {name:38s} {t:.4f} ms ({ms[name][0]:.4f} / {ms[name][1]:.4f}), "
                  f"{moved[part] / t / 1e9:.2f} TB/s{'' if same else '  DIFFERS'}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_max: no CUDA device")
    print(_card(), flush=True)
    lib = _build_probe()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    pair, ns = _pair_subsampling()
    nq, h = pair.shape[1:]
    local = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
    _shape(lib, dev, g, "s1 -> s2 pair 0", pair.to(dev), ns)
    _shape(lib, dev, g, "s1 -> s2 local", local, ns)


if __name__ == "__main__":
    main()
