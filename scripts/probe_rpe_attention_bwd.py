"""Where K11's tc form spends its time: ablations and plans, timed in turns.

    python scripts/probe_rpe_attention_bwd.py                  # head width 64, on a CUDA card
    python scripts/probe_rpe_attention_bwd.py --head-width 32  # the wide-head family's plans
    python scripts/probe_rpe_attention_bwd.py --rounding       # on the CPU, no card needed

Builds ``se3et_tpu_torch/csrc/rpe_attention_bwd.cu`` once a variant into
``se3et_tpu_torch/_build/probe_rpe_bwd<head width>/``, each cut at one
stage by ``RPE_BWD_TC_STAGE``, without its content phase
(``RPE_BWD_TC_NO_CONTENT``), with another warp count at AH = 24
(``RPE_BWD_TC_WARPS24``) or, at head width 32, with another plan
(``RPE_BWD_TC32_ROWS`` query rows a block, ``RPE_BWD_TC32_KEYS`` keys a
tile, ``_KV_SMEM``, ``_PAD``, ``_WARPS24``;
``csrc/rpe_attention_bwd_tc.cuh``), compiled
with ``-Xptxas -v``
(registers and spills of each instance printed):

* ``positional``: the embedding's stream and the positional scores only;
* ``scores``: + the content scores, P and dS' into shared memory, dqw's
  sums (no dqp, d_emb or stores of P and dS');
* ``dqp``: + dqp's products (slab^T . dS'^T) and its store;
* ``demb``: + d_emb's products and 16-byte stores;
* ``form``: + the bf16 P and dS' stores: the shipped kernel;
* ``no_content``: the shipped kernel without its content phase;
* at head width 64, ``form_8warps``: the shipped kernel with 8 warps a
  block at AH = 24;
* at head width 32: ``form_16warps`` (``RPE_BWD_TC32_WARPS24=16``): 16
  warps a block at AH = 24, two a row; ``no_kv_smem``
  (``RPE_BWD_TC32_KV_SMEM=0``): the content phase reads k and v from L2,
  where the shipped plan stages each tile's in shared memory by cp.async
  during the previous tile's phase 3; ``no_pad`` (``RPE_BWD_TC32_PAD=0``):
  the geometry's and dS' rows not padded;
  ``rows<R>_keys<K>[_16warps][_l2][_no_pad]``: the form on another plan
  (16 warps at AH = 24 unless the name says otherwise; ``_l2``: k and v
  from L2), and ``..._no_content`` without its content phase
  (``rows4_keys32_l2_no_pad`` is 64's plan halved).

At the training shapes (B = 2 stacked clouds, N = 1024; head width 64 with
C = 256: se3ete.3dmatch's AH = 24 with the SH term and AH = 4 without;
head width 32 with C = 128: se3ete2's two and se3eti2's AH = 24 without)
it times each variant's kernel alone with CUDA events in turns (the list
forward, then backward; the smaller time kept), then the whole K11 call
(kernel and products, ``rpe_attention.rpe_attention_bwd``) and its first
design on the same inputs, and prints each time beside the bound (the
embedding read once and d_emb written once) and the rate at which the
variant moves the embedding's bytes.  The K11 call's gradients, and at
head width 32 each whole variant's dqp, d_emb and dqw, are held against
the plain version (1e-2 of each gradient's scale).

``--rounding`` measures on the CPU, without a card and without JAX, the
error of the tc form's rounding plan itself (P, dS', dO and the inputs in
bf16 before each product, float32 sums, each gradient rounded to bf16;
dqw from the unrounded dS') against the float32 plain version, at
se3ete2's self_eq shape (B 2, N 1024, AH 24, head width 32, C 128, the SH
term) on the inputs ``selfcheck.check_rpe_attention_bwd`` makes, 128
query rows at a time.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, rpe_attention, selfcheck  # noqa: E402

_STAGES = {"positional": ["-DRPE_BWD_TC_STAGE=0"], "scores": ["-DRPE_BWD_TC_STAGE=1"],
           "dqp": ["-DRPE_BWD_TC_STAGE=2"], "demb": ["-DRPE_BWD_TC_STAGE=3"], "form": [],
           "no_content": ["-DRPE_BWD_TC_NO_CONTENT=1"]}


def _plan(rows, keys, kv_smem, pad, warps24=16):
    return [f"-DRPE_BWD_TC32_ROWS={rows}", f"-DRPE_BWD_TC32_KEYS={keys}",
            f"-DRPE_BWD_TC32_KV_SMEM={int(kv_smem)}", f"-DRPE_BWD_TC32_PAD={int(pad)}",
            f"-DRPE_BWD_TC32_WARPS24={warps24}"]


_NO_CONTENT = ["-DRPE_BWD_TC_NO_CONTENT=1"]
# variant: extra nvcc flags, per head width
VARIANTS = {
    64: {**_STAGES, "form_8warps": ["-DRPE_BWD_TC_WARPS24=8"]},
    32: {**_STAGES,
         "form_16warps": ["-DRPE_BWD_TC32_WARPS24=16"],
         "no_kv_smem": ["-DRPE_BWD_TC32_KV_SMEM=0"],
         "no_pad": ["-DRPE_BWD_TC32_PAD=0"],
         "no_kv_smem_no_pad": _plan(8, 16, False, False, 8),
         "rows8_keys16_16warps_l2_no_pad": _plan(8, 16, False, False),
         "rows8_keys16_16warps_l2_no_pad_no_content": _plan(8, 16, False, False) + _NO_CONTENT,
         "rows4_keys32_l2_no_pad": _plan(4, 32, False, False),
         "rows4_keys32_l2_no_pad_no_content": _plan(4, 32, False, False) + _NO_CONTENT,
         "rows4_keys32_l2": _plan(4, 32, False, True),
         "rows4_keys32": _plan(4, 32, True, True),
         "rows4_keys16": _plan(4, 16, True, True)},
}
# (AH, SH term) per head width: the self_eq and plain self layers
SHAPES = {64: ((24, True), (4, False)), 32: ((24, True), (4, False), (24, False))}
B, N = 2, 1024
REPS = 10


def _build_variants(hc):
    out_dir = os.path.join(_build.BUILD_DIR, f"probe_rpe_bwd{hc}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS[hc].items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
             "-o", lib, os.path.join(_build.CSRC_DIR, "rpe_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        usage = []
        for i, line in enumerate(lines):
            inst = re.search(r"rpe_attention_bwd_tc_kernelILi(\d+)ELi(\d+)E", line)
            if "Compiling entry function" in line and inst and int(inst.group(2)) == hc:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage.append(f"AH={inst.group(1)}: {regs.group(1) if regs else '?'} registers, "
                             f"{spill.group(1) if spill else '?'} bytes spilled")
        print(f"{name} ({' '.join(VARIANTS[hc][name]) or 'as shipped'}): {'; '.join(usage)}",
              flush=True)
        fn = ctypes.CDLL(lib).se3et_rpe_attention_bwd_tc_bf16
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def probe(hc):
    if not torch.cuda.is_available():
        sys.exit("probe_rpe_attention_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cc = rpe_attention.BWD_TC_PLANS[hc].c
    print(f"head width {hc}, C {cc}; the shipped plan {rpe_attention.BWD_TC_PLANS[hc]}",
          flush=True)
    fns = _build_variants(hc)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    points = (torch.rand((B, N, 3), generator=g) * 4 - 2).to(dev)
    masks = torch.ones((B, N), dtype=torch.bool, device=dev)
    masks[1, -40:] = False
    km = masks.to(torch.uint8)
    pts = rpe_attention.point_rows(points)
    emb = torch.randn((B, N, N, cc), generator=g).to(dev, torch.bfloat16)
    scale = hc ** -0.5
    for ah, with_sh in SHAPES[hc]:
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
        q, k, v = rnd(B, ah, N, hc), rnd(B, ah, N, hc), rnd(B, ah, N, hc)
        qp = rnd(B, N, ah, cc) * cc ** -0.5
        qw = (torch.randn((B, 3, ah, N), generator=g) * 0.3).to(dev) if with_sh else None
        ptsc = pts if with_sh else None
        out, lse = rpe_attention.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, ptsc,
                                                             scale=scale)
        dout = torch.randn((B, ah, N, hc), generator=g).to(dev)
        do_b = dout.to(torch.bfloat16)
        dd = (dout * out).sum(-1)
        p = torch.empty((B, ah, N, N), dtype=torch.bfloat16, device=dev)
        ds = torch.empty_like(p)
        dqp, demb = torch.empty_like(qp), torch.empty_like(emb)
        dqw = torch.zeros_like(qw) if with_sh else None

        def kernel(fn):
            def call():
                if with_sh:
                    dqw.zero_()
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                                emb.data_ptr(), km.data_ptr(), qw.data_ptr() if with_sh else None,
                                pts.data_ptr() if with_sh else None, do_b.data_ptr(),
                                lse.data_ptr(), dd.data_ptr(), p.data_ptr(), ds.data_ptr(),
                                dqp.data_ptr(), demb.data_ptr(),
                                dqw.data_ptr() if with_sh else None, B, ah, N, hc, cc,
                                pts.shape[1] if with_sh else 0, scale, stream),
                             "rpe_attention_bwd variant")
            return call

        args = (q, k, v, qp, emb, masks, qw, ptsc, dout, out, lse)
        runs = {name: kernel(fn) for name, fn in fns.items()}
        runs["K11 call"] = lambda: rpe_attention.rpe_attention_bwd(*args, scale=scale)
        runs["first design call"] = lambda: rpe_attention._rpe_attention_bwd(*args, scale,
                                                                            form="cuda")
        ms = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms[name].append(selfcheck._time_ms(runs[name], REPS))
        want = rpe_attention.rpe_attention_bwd_plain(*args, scale=scale)
        got = rpe_attention.rpe_attention_bwd(*args, scale=scale)
        err = max(_rel(a, b) for a, b in zip(got, want) if b is not None)
        del got
        whole = [name for name, flags in VARIANTS[hc].items()
                 if hc == 32 and not any("STAGE" in f or "NO_CONTENT" in f for f in flags)]
        errs = {}
        for name in whole:
            runs[name]()
            errs[name] = max(_rel(a, b) for a, b in zip((dqp, demb, dqw), want[3:])
                             if b is not None)
        del want
        emb_bytes = emb.numel() * 2
        bound, _ = selfcheck.bound(2 * emb_bytes, 0.0, torch.bfloat16)
        cells = [f"{name} {min(t):.4f} ms ({2 * emb_bytes / (min(t) * 1e-3) / 1e12:.2f} TB/s "
                 f"of emb + d_emb)" for name, t in ms.items()]
        print(f"AH={ah} {'SH' if with_sh else 'no SH'}: bound (emb + d_emb) {bound:.4f} ms; "
              + "; ".join(cells) + f"; K11 call against the plain version {err:.3e} of scale "
              f"(tol 1e-2)" + "".join(f"; {name}'s dqp, d_emb, dqw {e:.3e}"
                                      for name, e in errs.items()), flush=True)
        if not max([err] + list(errs.values())) <= 1e-2:
            sys.exit("probe_rpe_attention_bwd: K11 disagrees with its plain version")


def rounding(row_block=128):
    """The tc form's rounding plan against the float32 plain version at
    se3ete2's self_eq shape, on the CPU (see the module's docstring)."""
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    ah, hc, cc, with_sh = 24, 32, 128, True
    g = torch.Generator().manual_seed(3)
    points = torch.rand((B, N, 3), generator=g) * 4 - 2
    masks = torch.ones((B, N), dtype=torch.bool)
    masks[1, -40:] = False
    # the inputs of selfcheck.check_rpe_attention_bwd (seed 10), in its order
    g = torch.Generator().manual_seed(10)
    rnd = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(torch.bfloat16)  # noqa: E731
    q, k, v = rnd(B, ah, N, hc), rnd(B, ah, N, hc), rnd(B, ah, N, hc)
    qp = rnd(B, N, ah, cc, sc=cc ** -0.5)
    emb = rnd(B, N, N, cc)
    qw = torch.randn((B, 3, ah, N), generator=g) * 0.3 if with_sh else None
    pts = rpe_attention.point_rows(points) if with_sh else None
    scale = hc ** -0.5
    out, lse = rpe_attention.rpe_self_attention_plain(q, k, v, qp, emb, masks, qw, pts,
                                                      scale=scale, with_lse=True)
    dout = torch.randn((B, ah, N, hc), generator=g)
    want = rpe_attention.rpe_attention_bwd_plain(q, k, v, qp, emb, masks, qw, pts, dout, out,
                                                 lse, scale=scale)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    qf, kf, vf, do_b = q.float(), k.float(), v.float(), bf(dout)
    dd = (dout * out).sum(-1)
    km = masks[:, None, None, :]
    dq = torch.empty((B, ah, N, hc))
    dk, dv = torch.zeros((B, ah, N, hc)), torch.zeros((B, ah, N, hc))
    dqp, demb = torch.empty((B, N, ah, cc)), torch.empty((B, N, N, cc), dtype=torch.bfloat16)
    dqw = torch.empty((B, 3, ah, N)) if with_sh else None
    for n0 in range(0, N, row_block):
        n1 = min(N, n0 + row_block)
        s = rpe_attention._scores(q, k, qp, emb[:, n0:n1], masks, qw, pts, n0, n1, scale)
        pr = torch.exp(s - lse[:, :, n0:n1, None]) * km
        dpv = torch.einsum("banc,bamc->banm", do_b[:, :, n0:n1], vf)
        dsr = scale * pr * (dpv - dd[:, :, n0:n1, None])
        ds_b, p_b = bf(dsr), bf(pr)
        dq[:, :, n0:n1] = bf(ds_b @ kf)
        dk += ds_b.transpose(-1, -2) @ qf[:, :, n0:n1]
        dv += p_b.transpose(-1, -2) @ do_b[:, :, n0:n1]
        dqp[:, n0:n1] = bf(torch.einsum("banm,bnmd->bnad", ds_b, emb[:, n0:n1].float()))
        demb[:, n0:n1] = torch.einsum("banm,bnad->bnmd", ds_b,
                                      qp[:, n0:n1].float()).to(torch.bfloat16)
        if with_sh:
            rinv, dyzx = rpe_attention._sh_geometry(pts, n0, n1)
            dqw[..., n0:n1] = torch.einsum("banm,bdnm->bdan", dsr * rinv[:, None], dyzx)
    got = (dq, bf(dk), bf(dv), dqp, demb, dqw)
    errs = {name: _rel(a, b) for name, a, b in zip(("dq", "dk", "dv", "dqp", "demb", "dqw"),
                                                   got, want) if b is not None}
    print(f"the tc form's rounding plan against the float32 plain version at B {B}, N {N}, "
          f"AH {ah}, head width {hc}, C {cc}, {'with' if with_sh else 'no'} SH, on the CPU "
          f"(relative to each gradient's scale; the card's check holds 1e-2): "
          + ", ".join(f"{name} {e:.3e}" for name, e in errs.items())
          + f"; largest {max(errs.values()):.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head-width", type=int, choices=sorted(VARIANTS), default=64)
    ap.add_argument("--rounding", action="store_true",
                    help="the rounding plan's error at se3ete2's shape, on the CPU")
    a = ap.parse_args()
    if a.rounding:
        rounding()
    else:
        probe(a.head_width)


if __name__ == "__main__":
    main()
