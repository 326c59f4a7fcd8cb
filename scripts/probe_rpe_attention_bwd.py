"""Where K11's tc form spends its time: ablations of the kernel, timed in turns.

    python scripts/probe_rpe_attention_bwd.py      # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/rpe_attention_bwd.cu`` six times into
``se3et_tpu_torch/_build/probe_rpe_bwd/``, each cut at one stage by
``RPE_BWD_TC_STAGE`` or with another warp count at AH = 24
(``RPE_BWD_TC_WARPS24``; ``csrc/rpe_attention_bwd_tc.cuh``), compiled with
``-Xptxas -v`` (registers and spills of each instance printed):

* ``positional``: the embedding's stream and the positional scores only;
* ``scores``: + the content scores, P and dS' into shared memory, dqw's
  sums (no dqp, d_emb or stores of P and dS');
* ``dqp``: + dqp's products (slab^T . dS'^T) and its store;
* ``demb``: + d_emb's products and 16-byte stores;
* ``form``: + the bf16 P and dS' stores: the shipped kernel;
* ``form_8warps``: the shipped kernel with 8 warps a block at AH = 24 (2 a
  row in phase 3, 96 dqp accumulators a lane).

At the training shapes of se3ete.3dmatch (B = 2 stacked clouds, N = 1024,
C = 256, head width 64; AH = 24 with the SH term, AH = 4 without) it times
each variant's kernel alone with CUDA events in turns (the list forward,
then backward; the smaller time kept), then the whole K11 call (kernel and
products, ``rpe_attention.rpe_attention_bwd``) and its first design on the
same inputs, and prints each time beside the bound (the embedding read once
and d_emb written once) and the rate at which the variant moves the
embedding's bytes.  The shipped variant's gradients are held against the
plain version (1e-2 of each gradient's scale).
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, rpe_attention, selfcheck  # noqa: E402

# variant: (RPE_BWD_TC_STAGE, warps a block at AH = 24)
VARIANTS = {"positional": (0, 16), "scores": (1, 16), "dqp": (2, 16), "demb": (3, 16),
            "form": (4, 16), "form_8warps": (4, 8)}
SHAPES = ((24, True), (4, False))  # (AH, SH term): self_eq and plain self layers
B, N, C, HC = 2, 1024, 256, 64
REPS = 10


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_rpe_bwd")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (stage, warps) in VARIANTS.items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DRPE_BWD_TC_STAGE={stage}",
             f"-DRPE_BWD_TC_WARPS24={warps}", "-Xptxas", "-v",
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
            inst = re.search(r"rpe_attention_bwd_tc_kernelILi(\d+)E", line)
            if "Compiling entry function" in line and inst:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage.append(f"AH={inst.group(1)}: {regs.group(1) if regs else '?'} registers, "
                             f"{spill.group(1) if spill else '?'} bytes spilled")
        print(f"{name} (stage {VARIANTS[name][0]}, {VARIANTS[name][1]} warps at AH = 24): "
              f"{'; '.join(usage)}", flush=True)
        fn = ctypes.CDLL(lib).se3et_rpe_attention_bwd_tc_bf16
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_rpe_attention_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = _build_variants()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    points = (torch.rand((B, N, 3), generator=g) * 4 - 2).to(dev)
    masks = torch.ones((B, N), dtype=torch.bool, device=dev)
    masks[1, -40:] = False
    km = masks.to(torch.uint8)
    pts = rpe_attention.point_rows(points)
    emb = torch.randn((B, N, N, C), generator=g).to(dev, torch.bfloat16)
    scale = HC ** -0.5
    for ah, with_sh in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
        q, k, v = rnd(B, ah, N, HC), rnd(B, ah, N, HC), rnd(B, ah, N, HC)
        qp = rnd(B, N, ah, C) * C ** -0.5
        qw = (torch.randn((B, 3, ah, N), generator=g) * 0.3).to(dev) if with_sh else None
        ptsc = pts if with_sh else None
        out, lse = rpe_attention.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, ptsc,
                                                             scale=scale)
        dout = torch.randn((B, ah, N, HC), generator=g).to(dev)
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
                                dqw.data_ptr() if with_sh else None, B, ah, N, HC, C,
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
        got = rpe_attention.rpe_attention_bwd(*args, scale=scale)
        want = rpe_attention.rpe_attention_bwd_plain(*args, scale=scale)
        err = max(float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                  for a, b in zip(got, want) if b is not None)
        del got, want
        emb_bytes = emb.numel() * 2
        bound, _ = selfcheck.bound(2 * emb_bytes, 0.0, torch.bfloat16)
        cells = [f"{name} {min(t):.4f} ms ({2 * emb_bytes / (min(t) * 1e-3) / 1e12:.2f} TB/s "
                 f"of emb + d_emb)" for name, t in ms.items()]
        print(f"AH={ah} {'SH' if with_sh else 'no SH'}: bound (emb + d_emb) {bound:.4f} ms; "
              + "; ".join(cells) + f"; K11 call against the plain version {err:.3e} of scale "
              f"(tol 1e-2)", flush=True)
        if not err <= 1e-2:
            sys.exit("probe_rpe_attention_bwd: K11 disagrees with its plain version")


if __name__ == "__main__":
    main()
