"""Where K12's time goes: its phases, timed apart.

    python scripts/probe_gather_wf_mm.py      # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/gather_wf_mm.cu`` into
``se3et_tpu_torch/_build/probe/`` with ``-Xptxas -v`` (prints each kernel's
registers and shared memory) and times the bf16 tensor-core K12 through
``se3et_gather_wf_mm_bf16_phases`` with CUDA events at the stage-0 (x (2,
20000, 192), H 24) and stage-1 (x (2, 10000, 384), H 32) conv shapes on
local random neighbours (``selfcheck.local_neighbors``), with its phases
switched on and off: the whole kernel (gather, weight product, the last wave
in half tiles), the same without the half tiles, the gather alone (its
neighbour staging and H contraction) and the weight product alone (its
ring of weight panels, on whatever the A tile holds).  The weight panels
are laid out once, outside the timing.  Prints the card and one line
per (shape, phases).
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

GATHER, PRODUCT, SPLIT_TAIL = 1, 2, 4  # the kernel's phase bits
PHASES = {"kernel": GATHER | PRODUCT | SPLIT_TAIL, "no half tiles": GATHER | PRODUCT,
          "gather only": GATHER | SPLIT_TAIL, "product only": PRODUCT | SPLIT_TAIL}


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf_mm: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "gather_wf_mm_probe.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                           os.path.join(_build.CSRC_DIR, "gather_wf_mm.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(line.strip())
    fn = ctypes.CDLL(so).se3et_gather_wf_mm_bf16_phases
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
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
            print(f"x(2, {ns}, {ac}) nbr(2, {nq}, {h}): {name:13s} "
                  f"{selfcheck._time_ms(call, 20):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
