"""Which floor K1's tensor-core form sits on, and how its tiling moves it.

    python scripts/probe_gather_wf.py      # on a CUDA card (nvcc needed)

Builds variants of the bf16 tensor-core K1 (``se3et_tpu_torch/csrc/
gather_wf.cu``, ``tc::gather_wf_tc_kernel``) into
``se3et_tpu_torch/_build/probe/``, each a copy of the source with its
chunk width (``kCW``: 32 or 64 channels, the 64-channel one with the
128-byte rows' swizzle), ring slots per warp (``kStages``) and warps per
block (``kWarps``) set, compiled with ``-Xptxas -v`` (registers printed).
At the serving shapes of se3ete.3dmatch on local random neighbours
(``selfcheck.local_neighbors``, about a quarter sentinels) it times each
variant with CUDA events in turns (the list forward, then backward; the
smaller time kept), checks each bit for bit against the repo's own K1, and
prints the variant's traffic: the bytes the gather reads from L2 (16-byte
units of valid neighbour rows) plus the bytes it writes, over its time.
Beside that, the rate of a 1 GB to 1 GB ``copy_`` (read + written bytes
over time), what device memory delivers to a plain copy.  Prints the card
and one line per shape.
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

# (chunk channels, ring slots per warp, warps per block); the first is the
# source as it stands
VARIANTS = ((32, 4, 4), (32, 3, 4), (32, 6, 4), (32, 4, 8), (64, 3, 2), (64, 4, 2),
            (64, 3, 4))
SHAPES = ((2500, 2500, 36, 768), (1024, 2500, 36, 768), (1024, 1024, 38, 1536),
          (20000, 20000, 24, 192))
SWIZZLE_128B = """__device__ __forceinline__ int swz(int r, int c) {
  return r * kCW + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}"""


def _source(cw, stages, warps):
    with open(os.path.join(_build.CSRC_DIR, "gather_wf.cu")) as f:
        src = f.read()
    for name, value in (("kCW", cw), ("kStages", stages), ("kWarps", warps)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            sys.exit(f"probe_gather_wf: {name} not found once in gather_wf.cu")
    if cw == 64:
        src, n = re.subn(r"__device__ __forceinline__ int swz\(int r, int c\) \{\n.*?\n\}",
                         SWIZZLE_128B, src, count=1, flags=re.S)
        if n != 1:
            sys.exit("probe_gather_wf: swz not found in gather_wf.cu")
    return src


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        stem = os.path.join(out_dir, "gather_wf_cw%d_s%d_w%d" % v)
        with open(stem + ".cu", "w") as f:
            f.write(_source(*v))
        procs[v] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", _build.CSRC_DIR,
             "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {v}:\n{log}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        print(f"chunk {v[0]}, {v[1]} slots, {v[2]} warps: {regs}", flush=True)
        fn = ctypes.CDLL(stem + ".so").se3et_gather_wf_tc_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fns[v] = fn
    return fns


def _copy_rate(nbytes, reps):
    """(read + written bytes) / s of ``copy_`` between two buffers of
    ``nbytes``."""
    a = torch.empty(nbytes // 2, dtype=torch.bfloat16, device="cuda")
    b = torch.empty_like(a)
    return 2 * nbytes / (selfcheck._time_ms(lambda: b.copy_(a), reps) * 1e-3)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_gather_wf: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = _build_variants()
    print(f"copy_ 1 GB -> 1 GB (device memory): {_copy_rate(1 << 30, 10) / 1e12:.2f} TB/s",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    k = 15
    stream = torch.cuda.current_stream().cuda_stream
    for nq, ns, h, ac in SHAPES:
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, torch.bfloat16)
        infl = (torch.rand((2, nq, h, k), generator=g).to(dev)
                * (nbr < ns)[..., None]).to(torch.bfloat16)
        want = wc.gather_wf(x, nbr, infl)
        traffic = int((nbr < ns).sum()) * ac * 2 + want.numel() * 2
        runs = {}
        for v, fn in fns.items():
            out = torch.empty_like(want)

            def call(fn=fn, out=out):
                _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), out.data_ptr(),
                                2, ns, nq, h, h, k, ac, stream), "gather_wf variant")
            runs[v] = (call, out)
        ms = {v: [] for v in fns}
        for order in (list(fns), list(fns)[::-1]):
            for v in order:
                ms[v].append(selfcheck._time_ms(runs[v][0], 20))
        cells = []
        for v, (_, out) in runs.items():
            t = min(ms[v])
            same = "" if torch.equal(out, want) else " DIFFERS"
            cells.append(f"{v[0]}/{v[1]}/{v[2]} {t:.4f} ms {traffic / (t * 1e-3) / 1e12:.2f} TB/s"
                         f"{same}")
        print(f"x(2, {ns}, {ac}) nbr(2, {nq}, {h}), L2 reads + writes {traffic / 1e6:.1f} MB: "
              + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
