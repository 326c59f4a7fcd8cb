"""Where K2's time goes: its two forms and the rows form's variants, timed
on the strided skips' real neighbours.

    python scripts/probe_neighbor_max.py      # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/neighbor_max.cu`` into
``se3et_tpu_torch/_build/probe/`` with ``-Xptxas -v`` and prints each
kernel's registers and spills.  Then, on pair 0 of ``chip_smoke.py`` (the
synthetic se3ete.3dmatch pair at point_limit 20000) and on local random
neighbours (``selfcheck.local_neighbors``) of the same shape, times with
CUDA events (20 launches, after a warm-up):

* the fused serving route's skip, s2 -> s3 in bf16 (x (2, 2500, 3072), nbr
  (2, 1024, 36)): the rows form on its plan, the first design, and the
  rows form's variants (units a lane SU, neighbour rows in flight a lane NB,
  warps a block) through ``se3et_neighbor_max_rows_variant``, in two passes
  (the second in reverse order);
* the three strided skips of training in float32 (s0 -> s1 (2, 20000,
  768), s1 -> s2 (2, 10000, 1536), s2 -> s3 (2, 2500, 3072)) and the two
  others of the unfused route in bf16: both forms, and on pair 0 the
  variants;

each with the bytes it must read (the valid neighbour rows, each whole,
and the output) and the rate over them, every output checked bit for bit
against the plain version.  Last, K13's serving kernel through
``scripts/probe_gather_wf_mm.py`` (its registers and its times on local
neighbours and pair 0), since K13 takes the same skip-max routine.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from se3et_tpu_torch.ops.kernels import _build, selfcheck  # noqa: E402
from se3et_tpu_torch.ops.kernels import windowed_conv as wc  # noqa: E402

REPS = 20
# (SU, NB, warps a block); the plan's at the model's widths is (3, 4, 8)
VARIANTS = [(3, 4, 8), (3, 4, 4), (3, 4, 16), (3, 6, 8), (3, 8, 8), (3, 8, 16), (3, 12, 8),
            (2, 6, 8), (2, 12, 8), (4, 4, 8), (1, 12, 8)]


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _registers(log: str):
    """(kernel, registers, spill line) of each entry ptxas -v reports."""
    names, regs, spills, cur = [], {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            names.append(cur)
        elif cur and "spill" in line:
            spills[cur] = line.strip()
        elif cur and "Used" in line and "registers" in line:
            regs[cur] = line.split("Used")[1].split("registers")[0].strip()
    if shutil.which("c++filt") and names:
        pretty = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                                text=True).stdout.splitlines()
    else:
        pretty = names
    return [(p, regs.get(n, "?"), spills.get(n, "")) for p, n in zip(pretty, names)]


def _build_probe():
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "neighbor_max_probe.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                           os.path.join(_build.CSRC_DIR, "neighbor_max.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for name, regs, spill in _registers(proc.stdout + proc.stderr):
        print(f"{name}: {regs} registers; {spill}", flush=True)
    return ctypes.CDLL(so)


def _pair():
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)


def _shape(lib, dev, g, tag, nbr, ns, ac, dtype, variants):
    """Both forms (and ``variants`` of the rows form) on one skip."""
    variant = lib.se3et_neighbor_max_rows_variant
    variant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(dev, dtype)
    want = wc.neighbor_max_plain(x, nbr)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    valid = int(((nbr >= 0) & (nbr < ns)).sum())
    nbytes = (valid + b * nq) * ac * x.element_size()
    print(f"{tag}: x {tuple(x.shape)} {dtype} nbr {tuple(nbr.shape)}: {valid} valid slots "
          f"of {nbr.numel()}, {nbytes / 1e6:.1f} MB to move (valid rows read + output "
          f"written); plan {tuple(wc.neighbor_max_plan(ac, dtype))}", flush=True)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream

    def report(name, fn):
        out.zero_()
        got = fn()
        same = torch.equal(got.view(bits), want.view(bits))
        t = selfcheck._time_ms(fn, REPS)
        print(f"{tag}: {name:24s} {t:.4f} ms, {nbytes / t / 1e9:.2f} TB/s"
              f"{'' if same else '  DIFFERS FROM THE PLAIN VERSION'}", flush=True)

    for form in ("rows", "first"):
        report(f"{form} form", lambda f=form: wc._neighbor_max_forward(x, nbr, f))
    for p, order in enumerate((variants, variants[::-1])):
        for su, nb, warps in order:
            def call(su=su, nb=nb, warps=warps):
                _build.check(variant(x.data_ptr(), nbr.data_ptr(), out.data_ptr(), b, ns, nq,
                                     h, ac, x.element_size(), su, nb, warps, stream),
                             f"variant {su, nb, warps}")
                return out
            report(f"SU {su} NB {nb} warps {warps} ({p + 1})", call)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_neighbor_max: no CUDA device")
    print(_card())
    lib = _build_probe()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    pair = _pair()
    ns = [pair[f"points_{i}"].shape[1] for i in range(4)]
    for i, ac in ((2, 3072), (0, 768), (1, 1536)):
        nbr0 = torch.as_tensor(pair[f"subsampling_{i}"]).to(torch.int32).to(dev)
        nq, h = nbr0.shape[1:]
        local = torch.cat([selfcheck.local_neighbors(nq, ns[i], h, g, dev) for _ in range(2)])
        dtypes = (torch.bfloat16, torch.float32) if i == 2 else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            name = "bf16" if dtype == torch.bfloat16 else "float32"
            serving = i == 2 and dtype == torch.bfloat16
            _shape(lib, dev, g, f"s{i} -> s{i + 1} {name} pair 0", nbr0, ns[i], ac, dtype,
                   VARIANTS if serving or dtype == torch.float32 else [])
            if serving:
                _shape(lib, dev, g, f"s{i} -> s{i + 1} {name} local", local, ns[i], ac, dtype,
                       VARIANTS)
    import probe_gather_wf_mm

    probe_gather_wf_mm._k13(probe_gather_wf_mm._build_probe(), dev, g)


if __name__ == "__main__":
    main()
