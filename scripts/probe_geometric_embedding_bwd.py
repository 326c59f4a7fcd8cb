"""Where K10's tc form spends its time: ablations of the kernel, timed in turns.

    python scripts/probe_geometric_embedding_bwd.py   # on a CUDA card (nvcc needed)

Builds ``se3et_tpu_torch/csrc/geometric_embedding.cu`` five times into
``se3et_tpu_torch/_build/probe_emb_bwd/``, each cut at one stage by
``EMB_BWD_TC_STAGE`` (``csrc/embedding_bwd_tc.cuh``), compiled with
``-Xptxas -v`` (registers and spills of the C = 256 instance printed):

* ``stream``: the cotangent's stream through the cp.async ring only;
* ``bases``: + the keys' bf16 basis rows;
* ``argmax``: + the three angle projections on mma.sync, the first
  argmax and the masks of the cotangent (no accumulation);
* ``form``: + the accumulation (dGd, dGa): the shipped kernel;
* ``form_without_bases``: the shipped kernel with its basis rows left
  unbuilt (wrong gradients, timing only): what building them costs once
  the products run.

At the training shape of se3ete.3dmatch (d_emb (2, 1024, 1024, 256) bf16,
the coarse cloud's geometry) it times each variant's kernel alone with
CUDA events in turns (the list forward, then backward; the smaller time
kept), then the whole K10 call (the kernel, the partial sum and the
products ``A^T dG``: ``embedding.geometric_embedding_bwd``) and the first
design's call on the same inputs, and prints each time beside the bound
(d_emb read once, 0.32 ms), the share of the bound each reaches and the
rate at which it reads d_emb.  The shipped variant's gradients are held
against the plain version (1e-2 of each gradient's scale).
"""

import ctypes
import math
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, embedding, selfcheck  # noqa: E402

VARIANTS = {"stream": 0, "bases": 1, "argmax": 2, "form": 3,
            "form_without_bases": 3}  # EMB_BWD_TC_STAGE
EXTRA = {"form_without_bases": ["-DEMB_BWD_TC_NO_BASES"]}
B, N, C = 2, 1024, 256
REPS = 10


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_emb_bwd")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, stage in VARIANTS.items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DEMB_BWD_TC_STAGE={stage}",
             *EXTRA.get(name, []), "-Xptxas",
             "-v", "-o", lib, os.path.join(_build.CSRC_DIR, "geometric_embedding.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        usage = "?"
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "embedding_bwd_tc_kernelILi256E" in line:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage = (f"{regs.group(1) if regs else '?'} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spilled")
        print(f"{name} (stage {VARIANTS[name]}): C=256: {usage}", flush=True)
        fn = ctypes.CDLL(lib).se3et_geometric_embedding_bwd_tc
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_geometric_embedding_bwd: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = _build_variants()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    points = (torch.rand((B, N, 3), generator=g) * 4 - 2).to(dev)
    masks = torch.ones((B, N), dtype=torch.bool, device=dev)
    masks[1, -40:] = False
    w = [((torch.rand(s, generator=g) * 2 - 1) * C ** -0.5).to(dev)
         for s in ((C, C), (C,), (C, C), (C,))]
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, N, 3, 3)
    d_emb = torch.randn((B, N, N, C), generator=g).to(dev, torch.bfloat16)
    args = (d_emb, points, knn, *w, 0.2, 15.0)
    deg_d, deg_a, gd, ga = embedding._folded_projections(w[0], w[2], 15.0)
    gt = embedding.tc_table(gd, ga)
    blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                 B * N * -(-N // embedding.BWD_TC_KEYS))
    part = torch.empty((blocks, embedding.BWD_PARTS, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    inv = (2.0 / (embedding.D_INDEX_MAX * 0.2), 2.0 / math.pi)

    def kernel(fn):
        def call():
            _build.check(fn(points.data_ptr(), knn.data_ptr(), gt.data_ptr(), d_emb.data_ptr(),
                            part.data_ptr(), B, N, C, blocks, deg_d, deg_a, 3, *inv, stream),
                         "geometric_embedding_bwd variant")
        return call

    runs = {name: kernel(fn) for name, fn in fns.items()}
    runs["K10 call"] = lambda: embedding.geometric_embedding_bwd(*args)
    runs["first design call"] = lambda: embedding._geometric_embedding_bwd(*args, form="cuda")
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name].append(selfcheck._time_ms(runs[name], REPS))
    got = embedding.geometric_embedding_bwd(*args)
    want = embedding.geometric_embedding_bwd_plain(*args)
    err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
    nbytes = d_emb.numel() * 2
    bound, _ = selfcheck.bound(nbytes, 0.0, torch.bfloat16)
    cells = [f"{name} {min(t):.4f} ms ({bound / min(t):.1%} of the bound, "
             f"{nbytes / (min(t) * 1e-3) / 1e12:.2f} TB/s of d_emb)" for name, t in ms.items()]
    print(f"d_emb {tuple(d_emb.shape)} bf16, {blocks} blocks: bound (d_emb read once) "
          f"{bound:.4f} ms; " + "; ".join(cells) + f"; K10 call against the plain version "
          f"{err:.3e} of scale (tol 1e-2)", flush=True)
    if not err <= 1e-2:
        sys.exit("probe_geometric_embedding_bwd: K10 disagrees with its plain version")


if __name__ == "__main__":
    main()
