"""What holds K5's ws form back, and how its warp split and streaming move it.

    python scripts/probe_rpe_attention.py      # on a CUDA card (nvcc needed)

Builds variants of the bf16 K5 (``se3et_tpu_torch/csrc/rpe_attention.cu``
with ``rpe_attention_ws.cuh``) into ``se3et_tpu_torch/_build/probe_rpe/``,
each a copy of the sources with one setting changed, compiled with
``-Xptxas -v`` (registers and spills printed):

* ``committed``: the sources as they stand;
* ``pos3``: 3 positional warps (= ring slots) at both AH (the committed
  split is 5 at AH = 4 and 3 at AH = 24: a block of 14 warps gets 128
  registers a thread, one of 12 gets 168);
* ``pos2``: 2 positional warps at AH = 24 (11 warps a block);
* ``no_hint``: the embedding's bulk copies without the evict-first L2
  policy.

At the serving shapes of se3ete.3dmatch (B = 2 stacked clouds, N = 1024,
C = 256, head width 64; AH = 24 with the SH term, AH = 4 without) it times
each variant with CUDA events in turns (the list forward, then backward;
the smaller time kept), checks each against the repo's own K5 (within 1e-2
of its scale), and prints per variant the bytes the kernel moves through
L2 per launch (emb once; qp once per (query row, key tile), with the
slab; k and v once
per (row block, key tile, head); q the same at AH = 24 and once per head
at AH = 4, where it stays in registers; the output) and its rates: those
bytes over the time (L2), and the bound's bytes (each input once) over the
time (device memory).  Prints the card and one line per shape.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build, rpe_attention, selfcheck  # noqa: E402

POS_LINE = "static constexpr int kPosWarps = AH >= kFlashWarps ? 3 : 5;"
HINT_CALL = "&full[slot], policy);"
VARIANTS = {
    "committed": (),
    "pos3": ((POS_LINE, "static constexpr int kPosWarps = 3;"),),
    "pos2": ((POS_LINE, "static constexpr int kPosWarps = AH >= kFlashWarps ? 2 : 5;"),),
    "no_hint": ((HINT_CALL, "&full[slot]);"),),
}
SHAPES = ((24, True), (4, False))  # (AH, SH term): self_eq and plain self layers
B, N, C, HC = 2, 1024, 256, 64


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_rpe")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC_DIR, src)
        path = os.path.join(src, "rpe_attention_ws.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"probe_rpe_attention: {old!r} not found once in rpe_attention_ws.cuh")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(src, "lib.so"), os.path.join(src, "rpe_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        usage = []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "rpe_attention_ws_kernel" in line:
                ah = re.search(r"rpe_attention_ws_kernelILi(\d+)E", line)
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage.append(f"AH={ah.group(1) if ah else '?'}: "
                             f"{regs.group(1) if regs else '?'} registers, "
                             f"{spill.group(1) if spill else '?'} bytes spilled")
        print(f"{name}: {'; '.join(usage)}", flush=True)
        fn = ctypes.CDLL(os.path.join(src, "lib.so")).se3et_rpe_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def l2_bytes(ah: int) -> float:
    """Bytes the ws form moves through L2 per launch at the serving shape."""
    nblk, ntiles = N // 16, N // 32
    emb = B * N * N * C * 2
    qp = B * N * ntiles * ah * C * 2
    kv = B * nblk * ntiles * ah * 2 * 32 * HC * 2
    q = B * nblk * ntiles * ah * 16 * HC * 2 if ah >= 8 else B * ah * N * HC * 2
    return emb + qp + kv + q + B * ah * N * HC * 4


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_rpe_attention: no CUDA device")
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
    for ah, with_sh in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
        q, k, v = rnd(B, ah, N, HC), rnd(B, ah, N, HC), rnd(B, ah, N, HC)
        qp = rnd(B, N, ah, C) * C ** -0.5
        qw = (torch.randn((B, 3, ah, N), generator=g) * 0.3).to(dev) if with_sh else None
        want = rpe_attention.rpe_self_attention(q, k, v, qp, emb, masks, qw,
                                                pts if with_sh else None, scale=HC ** -0.5)
        nbytes = selfcheck._nbytes(q, k, v, qp, emb, masks) + want.numel() * 4
        if with_sh:
            nbytes += selfcheck._nbytes(qw, pts)
        runs = {}
        for name, fn in fns.items():
            out = torch.empty_like(want)

            def call(fn=fn, out=out):
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                                emb.data_ptr(), km.data_ptr(),
                                qw.data_ptr() if with_sh else None,
                                pts.data_ptr() if with_sh else None, out.data_ptr(), None,
                                B, ah, N, HC, C, pts.shape[1] if with_sh else 0, HC ** -0.5,
                                stream), "rpe_attention variant")
            runs[name] = (call, out)
        ms = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms[name].append(selfcheck._time_ms(runs[name][0], 20))
        l2 = l2_bytes(ah)
        cells = []
        for name, (_, out) in runs.items():
            t = min(ms[name])
            diff = float((out - want).abs().max()) / float(want.abs().max())
            flag = "" if diff <= 1e-2 else f" DIFFERS {diff:.2e}"
            cells.append(f"{name} {t:.4f} ms, L2 {l2 / (t * 1e-3) / 1e12:.2f} TB/s, device "
                         f"memory {nbytes / (t * 1e-3) / 1e12:.2f} TB/s{flag}")
        print(f"AH={ah} {'SH' if with_sh else 'no SH'}: L2 bytes per launch {l2 / 1e9:.3f} GB, "
              f"bound bytes {nbytes / 1e9:.3f} GB: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
