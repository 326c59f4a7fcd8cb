"""Where K12's time goes: its gather and its product phase, timed apart.

    python scripts/probe_gather_wf_mm.py      # on a CUDA card (nvcc needed)

Builds three copies of ``se3et_tpu_torch/csrc/gather_wf_mm.cu`` into
``se3et_tpu_torch/_build/probe/``: the kernel as it is, one with the
weight product switched off (the gather phase alone) and one with the
gather switched off (the product phase alone, on zero tiles), and times
each in bf16 with CUDA events at the stage-0 (x (2, 20000, 192), H 24) and
stage-1 (x (2, 10000, 384), H 32) conv shapes on local random neighbours
(``selfcheck.local_neighbors``).  Prints the card, each build's register
count and one line per (shape, copy).
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

PRODUCT = "      product<NT>(as + kk * kBM * LD, bs, wm, n_first, n_count, g, t, acc);"
GATHER = "      if (c < ac) {\n        const int* rn"


def _variants(src):
    out = {"kernel": src,
           "gather only": src.replace(PRODUCT, "      if (ac < 0) " + PRODUCT.strip()),
           "product only": src.replace(GATHER, GATHER.replace("c < ac", "c < ac && ac < 0"))}
    assert len({v for v in out.values()}) == 3, "the probe's patch points moved"
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_mm: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with open(os.path.join(_build.CSRC_DIR, "gather_wf_mm.cu")) as f:
        src = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(_variants(src).items()):
        cu = os.path.join(out_dir, f"probe_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"probe_{i}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-Xptxas", "-v",
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in log.splitlines() if "registers" in line})
        print(f"{name}: registers per thread over its instances {regs}")
        fn = ctypes.CDLL(so).se3et_gather_wf_mm_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fns[name] = fn

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    k = 15
    for nq, ns, h, ac in ((20000, 20000, 24, 192), (10000, 10000, 32, 384)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, torch.bfloat16)
        infl = (torch.rand((2, nq, h, k), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(torch.bfloat16)
        w = wc._padded_influence(infl, h, torch.bfloat16)
        rhs_t = (torch.randn((ac, k * ac), generator=g) * 0.02).to(dev, torch.bfloat16)
        out = torch.empty((2, nq, ac), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in fns.items():
            def call(fn=fn):
                _build.check(fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), rhs_t.data_ptr(),
                                out.data_ptr(), 2, ns, nq, h, k, ac, ac, stream), name)
            print(f"x(2, {ns}, {ac}) nbr(2, {nq}, {h}): {name:12s} "
                  f"{selfcheck._time_ms(call, 20):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
