"""What holds K5's ws form back, and how its plan moves it, at head width
64 or 32.

    python scripts/probe_rpe_attention.py [--head-width 64|32]   # on a CUDA card

Builds variants of the bf16 K5 (``se3et_tpu_torch/csrc/rpe_attention.cu``
with ``rpe_attention_ws.cuh`` and ``rpe_attention_core.cuh``) into
``se3et_tpu_torch/_build/probe_rpe/``, each a copy of the sources with
some lines changed, compiled with ``-Xptxas -v`` (registers and spills of
the ws kernel printed):

* ``committed``: the sources as they stand;
* at head width 64: ``pos3``, 3 positional warps (= ring slots) at both AH
  (the committed split is 5 at AH = 4 and 3 at AH = 24: a block of 14
  warps gets 128 registers a thread, one of 12 gets 168); ``pos2``, 2
  positional warps at AH = 24 (11 warps a block); ``no_hint``, the
  embedding's bulk copies without the evict-first L2 policy;
* at head width 32, the committed plan (two ring slots a positional warp,
  the SH geometry formed by the flash warps two tiles ahead into a shared
  buffer, at AH = 4 qp resident in shared memory and one flash warp a
  head, every head's q fragments in registers) against: ``plan64``, 64's
  plan at 32 (none of these); ``slots1``, one slot a warp; ``geo_pos``,
  the geometry formed by the positional warps, as at 64; ``fw8``, 8 flash
  warps at AH = 4 (two a head, merged at the end); ``pos7``, 7 positional
  warps at AH = 4; ``no_qregs``, q reloaded per tile and head; ``qp_ring``,
  qp in the ring at AH = 4; and two ablations, which change the function
  (not checked): ``abl_sh_math``, rinv without its square root and
  division; ``abl_no_pos_mma``, the positional warps without their
  products;
* ``first``: the CUDA-core first design (``se3et_rpe_attention_cuda_bf16``)
  and, at head width 32, its ablations, which change the function (not
  checked): ``first_no_pos``, the positional term left out (the flash
  part alone: content scores, softmax, p . v); ``first_pos_only``, the
  content term and p . v left out (the embedding stream, the CUDA-core
  positional product and the softmax); ``first_stream``, the positional
  product replaced by a plain sum of each embedding row (the stream
  without the float32 contraction against qp).

At the serving shapes of the family (B = 2 stacked clouds, N = 1024, the
last 40 keys of cloud 1 masked; head width 64 with C = 256, AH = 24 with
the SH term and AH = 4 without; head width 32 with C = 128, the same two
and AH = 24 without the SH term, se3eti2's) it times each variant with
CUDA events in turns (the list forward, then backward; the smaller time
kept), checks each ws variant and ``first`` against the plain version
(within 1e-2 of its scale on valid rows), and prints per variant its share
of the bound (each input read once, each output written once, over 3.35
TB/s), the bytes the ws kernel moves through L2 per launch (emb once; qp
once per (query row, key tile) with the slab, or once where resident; k
and v once per (row block, key tile, head); q the same where it is
reloaded per tile, once a block where it stays in registers; the output)
and those bytes over the time.  Prints the card and one line per shape.
"""

import argparse
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

WS = "rpe_attention_ws.cuh"
CORE = "rpe_attention_core.cuh"
ENTRY = "rpe_attention.cu"
POS_LINE = "static constexpr int kPosWarps = AH >= kFlashWarps ? 3 : 5;"
HINT_CALL = "&full[slot], policy);"
QP_LINE = "static constexpr bool kQpResident = HC == 32 && AH < kFlashWarps;"
QREGS_LINE = "static constexpr bool kQRegs = HC == 32;"
GEO_LINE = "static constexpr bool kGeoBuf = HC == 32;"
SLOTS_LINE = "static constexpr int kSlotsPerWarp = HC == 32 ? 2 : 1;"
K5_FLASH = "return HC == 32 && AH < kFlashWarps ? 4 : kFlashWarps;"
RINV_LINE = "const float rinv = (key == row) ? 0.f : rpe::kSh1 / (rr2 + 1e-12f);"
POS_LOOP = "for (int c0 = 0; c0 < cc; c0 += 32) {"
CONTENT_LINE = "        s[a] += t;\n"
PV_LINE = "    if (pv_lane) {\n      const int mcount"
POS_CALL = "pos.template lane_scores<T, AH>(b, n, row, m, cc, my_qp, s);"
DOT_CALL = "rpe::qp_dot8<AH>(my_qp, cc, c0, e, s);"
NO_QP = (WS, QP_LINE, "static constexpr bool kQpResident = false;")
NO_QREGS = (WS, QREGS_LINE, "static constexpr bool kQRegs = false;")
NO_GEO = (WS, GEO_LINE, "static constexpr bool kGeoBuf = false;")
SLOTS1 = (WS, SLOTS_LINE, "static constexpr int kSlotsPerWarp = 1;")
FW8 = (WS, K5_FLASH, K5_FLASH.replace("? 4 :", "? 8 :"))
# name: (edits as (file, old, new), kernel: "ws" or "first", checked)
VARIANTS = {
    64: {
        "committed": ((), "ws", True),
        "pos3": (((WS, POS_LINE, "static constexpr int kPosWarps = 3;"),), "ws", True),
        "pos2": (((WS, POS_LINE, POS_LINE.replace("? 3 :", "? 2 :")),), "ws", True),
        "no_hint": (((WS, HINT_CALL, "&full[slot]);"),), "ws", True),
        "first": ((), "first", True),
    },
    32: {
        "committed": ((), "ws", True),
        "plan64": ((NO_QP, NO_QREGS, NO_GEO, SLOTS1, FW8), "ws", True),
        "slots1": ((SLOTS1,), "ws", True),
        "geo_pos": ((NO_GEO,), "ws", True),
        "fw8": ((FW8,), "ws", True),
        "pos7": (((WS, POS_LINE, POS_LINE.replace(": 5;", ": 7;")),), "ws", True),
        "no_qregs": ((NO_QREGS,), "ws", True),
        "qp_ring": ((NO_QP,), "ws", True),
        "abl_sh_math": (((WS, RINV_LINE, "const float rinv = rpe::kSh1;"),), "ws", False),
        "abl_no_pos_mma": (((WS, POS_LOOP, "for (int c0 = 0; c0 < 0; c0 += 32) {"),), "ws",
                           False),
        "first": ((), "first", True),
        "first_no_pos": (((CORE, POS_CALL, ""),), "first", False),
        "first_pos_only": (((CORE, CONTENT_LINE, ""),
                            (CORE, PV_LINE, PV_LINE.replace("pv_lane", "false"))), "first", False),
        "first_stream": (((ENTRY, DOT_CALL, "s[0] += e[0] + e[1] + e[2] + e[3] + e[4] + e[5] "
                          "+ e[6] + e[7];"),), "first", False),
    },
}
# (AH, SH term) at each head width: self_eq, plain self (and se3eti2's self_eq)
SHAPES = {64: ((24, True), (4, False)), 32: ((24, True), (4, False), (24, False))}
WIDTH_C = {64: 256, 32: 128}
B, N = 2, 1024


def _build_variants(hc: int):
    out_dir = os.path.join(_build.BUILD_DIR, "probe_rpe")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, (edits, _, _) in VARIANTS[hc].items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                sys.exit(f"probe_rpe_attention: {old!r} not found once in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        procs[name] = (src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(src, "lib.so"), os.path.join(src, ENTRY)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        usage = []
        for i, line in enumerate(lines):
            m = re.search(r"rpe_attention_ws_kernelILi(\d+)ELi(\d+)E", line)
            if "Compiling entry function" in line and m and int(m.group(2)) == hc:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage.append(f"AH={m.group(1)}: {regs.group(1) if regs else '?'} registers, "
                             f"{spill.group(1) if spill else '?'} bytes spilled")
        kind = VARIANTS[hc][name][1]
        print(f"{name} ({kind}): {'; '.join(usage)}", flush=True)
        lib = ctypes.CDLL(os.path.join(src, "lib.so"))
        fn = lib.se3et_rpe_attention_cuda_bf16 if kind == "first" else \
            lib.se3et_rpe_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def l2_bytes(name: str, ah: int, hc: int, cc: int) -> float:
    """Bytes the ws form of variant ``name`` moves through L2 per launch."""
    nblk, ntiles = N // 16, N // 32
    resident = rpe_attention.ws_qp_resident(ah, hc) and name not in ("plan64", "qp_ring")
    qregs = (hc == 32 and name not in ("plan64", "no_qregs")) or ah < 8
    emb = B * N * N * cc * 2
    qp = B * N * ah * cc * 2 * (1 if resident else ntiles)
    kv = B * nblk * ntiles * ah * 2 * 32 * hc * 2
    q = B * ah * N * hc * 2 * (1 if qregs else ntiles)
    return emb + qp + kv + q + B * ah * N * hc * 4


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-width", type=int, choices=(64, 32), default=64)
    hc = parser.parse_args().head_width
    if not torch.cuda.is_available():
        sys.exit("probe_rpe_attention: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cc = WIDTH_C[hc]
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
    for ah, with_sh in SHAPES[hc]:
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
        q, k, v = rnd(B, ah, N, hc), rnd(B, ah, N, hc), rnd(B, ah, N, hc)
        qp = rnd(B, N, ah, cc) * cc ** -0.5
        qw = (torch.randn((B, 3, ah, N), generator=g) * 0.3).to(dev) if with_sh else None
        want = rpe_attention.rpe_self_attention_plain(q, k, v, qp, emb, masks, qw,
                                                      pts if with_sh else None,
                                                      scale=hc ** -0.5)
        rows = masks[:, None, :, None].expand_as(want)
        nbytes = selfcheck._nbytes(q, k, v, qp, emb, masks) + want.numel() * 4
        if with_sh:
            nbytes += selfcheck._nbytes(qw, pts)
        bound_ms = nbytes / selfcheck.MEMORY_RATE * 1e3
        runs = {}
        for name, fn in fns.items():
            out = torch.empty_like(want)

            def call(fn=fn, out=out):
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                                emb.data_ptr(), km.data_ptr(),
                                qw.data_ptr() if with_sh else None,
                                pts.data_ptr() if with_sh else None, out.data_ptr(), None,
                                B, ah, N, hc, cc, pts.shape[1] if with_sh else 0, hc ** -0.5,
                                stream), "rpe_attention variant")
            runs[name] = (call, out)
        ms = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms[name].append(selfcheck._time_ms(runs[name][0], 20))
        cells = []
        scale = float(want[rows].abs().max())
        for name, (_, out) in runs.items():
            _, kind, checked = VARIANTS[hc][name]
            t = min(ms[name])
            cell = f"{name} {t:.4f} ms ({bound_ms / t:.1%} of the bound)"
            if kind == "ws":
                l2 = l2_bytes(name, ah, hc, cc)
                cell += f", L2 {l2 / 1e9:.3f} GB at {l2 / (t * 1e-3) / 1e12:.2f} TB/s"
            if checked:
                diff = float((out - want)[rows].abs().max()) / scale
                cell += f", {diff:.2e} of scale" + ("" if diff <= 1e-2 else " DIFFERS")
            else:
                cell += " (ablation)"
            cells.append(cell)
        print(f"AH={ah} {'SH' if with_sh else 'no SH'} head width {hc} C={cc}: bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB): " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
