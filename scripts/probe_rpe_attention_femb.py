"""What holds K16's ws form back: its roles apart, its warp split, and the
first design beside it.

    python scripts/probe_rpe_attention_femb.py [--parent TREE] [--head-width 32]
                                                               # on a CUDA card

Builds variants of the bf16 K16 (``se3et_tpu_torch/csrc/rpe_attention_femb.cu``
with ``rpe_attention_femb_ws.cuh``) into ``se3et_tpu_torch/_build/probe_femb/``,
each a copy of the sources with one setting changed, compiled with
``-Xptxas -v`` (registers and spills of each instance printed):

* ``committed``: the sources as they stand (at AH = 24, 4 pairs of
  positional warps, each warp one 16-key m-tile of its pair's item, beside
  K5's 8 flash warps: 16 warps get 128 registers a thread; at AH = 4, 12
  positional warps of whole items and 4 flash warps);
* ``whole_24``: at AH = 24, 4 positional warps of whole items (12 warps a
  block, 168 registers a thread);
* ``pairs6_24`` / ``pos8_4``: 3 pairs at AH = 24 (14 warps), 8
  positional warps at AH = 4 (12 warps);
* ``ring3``: 3 chunks of qp in a ring (4 committed);
* ablations that compute something else, to show what the time is made
  of (their outputs are not checked):
  ``positional_only`` (the flash warps release each score tile as it is
  full and do nothing else), ``flash_only`` (the positional warps skip
  the geometry and the projection and write the SH term alone),
  ``geometry_only`` (the positional warps evaluate the geometry and write
  the basis rows, no projection; flash released) and
  ``projection_only`` (no geometry: the basis rows of zeros are projected
  and contracted; flash released).

Their register counts are the roles' own: ``positional_only`` carries no
flash code, ``flash_only`` no projection.

``--head-width 32`` probes the wide-head family's shapes instead (se3ete2:
C = 128, head width 32), where the ws form has a plan of its own
(``femb_ws::Layout``'s ``kGeoAhead``: at AH = 24 the
flash warps form each key tile's pair geometry two tiles ahead and a
warp's 32 lanes build its 16 keys' basis rows; AH = 4 keeps 64's plan).
Its variants:

* ``committed``; ``plan64``: 64's plan instantiated at 32 (the positional
  warps form their own geometry, 16 lanes a warp at AH = 24);
* ``plan64_pos``: 64's plan with more positional groups (6 pairs at AH =
  24, 16 warps at AH = 4: 20 warps a block, 96 registers a thread), the
  other route off the positional warps' path (AH = 24 has no room for
  more groups beside the geometry buffers);
* the four ablations above on ``plan64`` (``plan64_positional_only`` ...)
  and on ``committed``, where the flash warps keep forming the geometry
  ahead when released at once (``positional_only``, ``geometry_only``),
  ``flash_only`` skips the basis rows and the projection, and
  ``projection_only`` the pair geometry and the basis rows;
* ``first``: the CUDA-core first design (``se3et_rpe_attention_femb_cuda_bf16``
  of the committed build).  With ``--parent`` (an unpacked
checkout of an earlier tree, e.g. ``git archive <commit> | tar -x -C
se3et_tpu_torch/_build/parent``) that tree's K16 is built and timed in the
same turns ("parent"), and with it K5's ws form from this tree on a
materialised embedding of the same shape ("K5 ws").

At the serving shapes of se3ete.3dmatch (B = 2 stacked clouds, N = 1024,
C = 256, head width 64; AH = 24 with the SH term, AH = 4 without; 40 keys
masked at the end of cloud 1) it times each variant with CUDA events in
turns (the list forward, then backward; the smaller time kept), checks
``committed``, the warp splits and the parent against the plain version
(within 1e-2 of max |out| on valid rows, K16's tolerance), and prints per
variant its time, its share of the bound (``selfcheck``'s, operations)
and the bytes it moves through L2 per launch (qp once per (query row, key
tile); k and v once per (row block, key tile, head); q the same at AH = 24
and once per head at AH = 4; G once per block; the output) over its time.
Prints the card first.
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

from se3et_tpu_torch.ops.kernels import _build, embedding, rpe_attention, selfcheck  # noqa: E402

HEADER = "rpe_attention_femb_ws.cuh"
POS_LINE = "static constexpr int kPosWarps = AH >= kFlashWarps ? 8 : 12;"
MT_LINE = "static constexpr int kMT = AH >= kFlashWarps ? 1 : 2;"
RING_LINE = "static constexpr int kQpSlots = 4;"
FLASH_CALL = "    rpe_ws::flash<AH, HC, L::kFlash>(fw, lane, b, row0, n, ntiles, q, k, v,"
FLASH_DRAIN = ("    for (int j = 0; j < ntiles; ++j) {"
               " mbar_wait_or_trap(&sfull[j & 1], (j >> 1) & 1, 3);"
               " if (L::kGeoAhead && j + 2 < ntiles)"
               " ahead(j + 2, j & 1, fw * 32 + lane, L::kFlash * 32);"
               " mbar_arrive(&sempty[j & 1]); }\n"
               "    if (false) rpe_ws::flash<AH, HC, L::kFlash>(fw, lane, b, row0, n, ntiles, q, k, v,")
NO_GEOMETRY = (("      if (key < n && key != row) {", "      if (false) {"),)
NO_PROJECTION = (("    for (int p = 0; p < nchunks; ++p) {", "    for (int p = 0; p < 0; ++p) {"),)
VARIANTS = {
    "committed": (),
    "whole_24": ((MT_LINE, "static constexpr int kMT = 2;"),
                 (POS_LINE, "static constexpr int kPosWarps = AH >= kFlashWarps ? 4 : 12;")),
    "pairs6_24": ((POS_LINE, "static constexpr int kPosWarps = AH >= kFlashWarps ? 6 : 12;"),),
    "pos8_4": ((POS_LINE, "static constexpr int kPosWarps = AH >= kFlashWarps ? 8 : 8;"),),
    "ring3": ((RING_LINE, "static constexpr int kQpSlots = 3;"),),
    "positional_only": ((FLASH_CALL, FLASH_DRAIN),),
    "flash_only": NO_GEOMETRY + NO_PROJECTION
    + (("        emb::key_basis(dist, ang, inv_d, inv_a, mine);", "        ;"),),
    "geometry_only": NO_PROJECTION + ((FLASH_CALL, FLASH_DRAIN),),
    "projection_only": NO_GEOMETRY + ((FLASH_CALL, FLASH_DRAIN),),
}
# head width 32's plan and its ablations
GEO_LINE = "static constexpr bool kGeoAhead = HC == 32 && AH >= kFlashWarps;"
PLAN64 = ((GEO_LINE, "static constexpr bool kGeoAhead = false;"),)
DRAIN = ((FLASH_CALL, FLASH_DRAIN),)
NO_PAIRS = (("      if (key != row0 + r && key < n) {", "      if (false) {"),)
NO_BASIS = (("      split_basis(lane < 16, key0 + kl < n, pg[2 * kl], inv_d, inv_a,\n"
             "                  sbasis + kl * emb::kBStride);", "      ;"),)
VARIANTS_32 = {
    "committed": (),
    "plan64": PLAN64,
    "plan64_pos": PLAN64 + ((POS_LINE,
                             "static constexpr int kPosWarps = AH >= kFlashWarps ? 12 : 16;"),),
    "plan64_positional_only": PLAN64 + VARIANTS["positional_only"],
    "plan64_flash_only": PLAN64 + VARIANTS["flash_only"],
    "plan64_geometry_only": PLAN64 + VARIANTS["geometry_only"],
    "plan64_projection_only": PLAN64 + VARIANTS["projection_only"],
    "positional_only": DRAIN,
    "flash_only": NO_PROJECTION + NO_BASIS,
    "geometry_only": NO_PROJECTION + DRAIN,
    "projection_only": NO_PAIRS + NO_BASIS + DRAIN,
}
CHECKED = ("committed", "whole_24", "pairs6_24", "pos8_4", "ring3", "parent", "plan64",
           "plan64_pos", "first")
SHAPES = ((24, True), (4, False))  # (AH, SH term): self_eq and plain self layers
B, N, KA = 2, 1024, 3
C, HC = 256, 64  # --head-width 32: 128, 32
SIGMA_D, SIGMA_A = 0.2, 15.0


def _compile(name, src_dir, out_dir, procs):
    lib = os.path.join(out_dir, f"{name}.so")
    procs[name] = (lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
         os.path.join(src_dir, "rpe_attention_femb.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def _usage(log):
    """'AH=24: R registers, S bytes spilled; ...' of each kernel instance
    in nvcc's -Xptxas -v output."""
    lines = log.splitlines()
    usage = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m or not re.search(r"femb_ws_kernel|tc_kernel", m.group(1)):
            continue
        ah = re.search(r"kernelILi(\d+)ELi(\d+)E", m.group(1))
        after = "\n".join(lines[i + 1:i + 5])
        spill = re.search(r"(\d+) bytes spill stores", after)
        regs = re.search(r"Used (\d+) registers", after)
        usage.append(f"AH={ah.group(1) if ah else '?'} HC={ah.group(2) if ah else '?'}: "
                     f"{regs.group(1) if regs else '?'} registers, "
                     f"{spill.group(1) if spill else '?'} bytes spilled")
    return "; ".join(usage)


def _entry(lib, name):
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _build_variants(parent, variants):
    out_dir = os.path.join(_build.BUILD_DIR, "probe_femb")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = {}
    for name, edits in variants.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC_DIR, src)
        path = os.path.join(src, HEADER)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"probe_rpe_attention_femb: {old!r} not found once in {HEADER}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        _compile(name, src, out_dir, procs)
    if parent:
        _compile("parent", os.path.join(parent, "se3et_tpu_torch", "csrc"), out_dir, procs)
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: {_usage(log)}", flush=True)
        fns[name] = _entry(lib, "se3et_rpe_attention_femb_bf16")
        if name == "committed" and HC == 32:
            fns["first"] = _entry(lib, "se3et_rpe_attention_femb_cuda_bf16")
    return fns


def l2_bytes(ah: int) -> float:
    """Bytes the ws form moves through L2 per launch at the serving shape."""
    nblk, ntiles = N // 16, N // 32
    qp = B * N * ntiles * ah * C * 2
    kv = B * nblk * ntiles * ah * 2 * 32 * HC * 2
    q = B * nblk * ntiles * ah * 16 * HC * 2 if ah >= 8 else B * ah * N * HC * 2
    g = B * nblk * C * 64 * 2
    return qp + kv + q + g + B * ah * N * HC * 4


def main():
    global C, HC
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an unpacked earlier checkout whose K16 is timed beside")
    parser.add_argument("--head-width", type=int, choices=(64, 32), default=64,
                        help="64: se3ete's shapes (C 256); 32: se3ete2's (C 128)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_rpe_attention_femb: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.head_width == 32:
        C, HC = 128, 32
    fns = _build_variants(args.parent, VARIANTS_32 if HC == 32 else VARIANTS)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    points = (torch.rand((B, N, 3), generator=g) * 4 - 2).to(dev)
    masks = torch.ones((B, N), dtype=torch.bool, device=dev)
    masks[1, -40:] = False
    points[1, -40:] = 0.0
    km = masks.to(torch.uint8)
    pts = rpe_attention.point_rows(points)
    pts3 = points.contiguous()
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, KA + 1, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, N, KA, 3)
    wd, wa = (((torch.rand((C, C), generator=g) * 2 - 1) * C ** -0.5).to(dev) for _ in range(2))
    deg_d, deg_a, gtab, gt = rpe_attention.femb_tables(wd, wa, SIGMA_A, torch.bfloat16)
    inv_d = 2.0 / (embedding.D_INDEX_MAX * SIGMA_D)
    rows = masks[:, None, :, None]
    for ah, with_sh in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
        q, k, v = rnd(B, ah, N, HC), rnd(B, ah, N, HC), rnd(B, ah, N, HC)
        qp = rnd(B, N, ah, C) * C ** -0.5
        qw = (torch.randn((B, 3, ah, N), generator=g) * 0.3).to(dev) if with_sh else None
        kw = dict(scale=HC ** -0.5, sigma_d=SIGMA_D, sigma_a=SIGMA_A)
        want = rpe_attention.rpe_self_attention_femb_plain(q, k, v, qp, masks, qw, pts, knn,
                                                           wd, wa, **kw)
        res = selfcheck.check_rpe_attention_femb(points, masks, ah, c=HC, cc=C, with_sh=with_sh,
                                                 reps=1)
        runs = {}
        for name, fn in fns.items():
            out = torch.empty_like(want)

            def call(fn=fn, out=out):
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                                km.data_ptr(), qw.data_ptr() if with_sh else None,
                                pts.data_ptr(), pts3.data_ptr(), knn.data_ptr(),
                                gtab.data_ptr(), gt.data_ptr(), out.data_ptr(), B, ah, N, HC,
                                C, pts.shape[1], deg_d, deg_a, KA, HC ** -0.5, inv_d,
                                2.0 / torch.pi, stream), "rpe_attention_femb variant")
            runs[name] = (call, out)
        if args.parent or HC == 32:
            emb = torch.randn((B, N, N, C), generator=g).to(dev, torch.bfloat16)
            runs["K5 ws"] = (lambda e=emb: rpe_attention.rpe_self_attention(
                q, k, v, qp, e, masks, qw, pts if with_sh else None, scale=HC ** -0.5), None)
        for name, (call, _) in runs.items():  # each built and run once, apart
            print(f"AH={ah}: {name} first call", flush=True)
            call()
            torch.cuda.synchronize()
        ms = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms[name].append(selfcheck._time_ms(runs[name][0], 20))
        l2 = l2_bytes(ah)
        cells = []
        for name, (_, out) in runs.items():
            t = min(ms[name])
            flag = ""
            if name in CHECKED:
                diff = float((out - want)[rows.expand_as(want)].abs().max()) / float(
                    want[rows.expand_as(want)].abs().max())
                flag = f", err {diff:.2e}" + ("" if diff <= 1e-2 else " DIFFERS")
            cells.append(f"{name} {t:.4f} ms ({res.bound_ms / t:.1%} of the bound), L2 "
                         f"{l2 / (t * 1e-3) / 1e12:.2f} TB/s{flag}")
        print(f"AH={ah} {'SH' if with_sh else 'no SH'}: bound {res.bound_ms:.4f} ms "
              f"({res.bound_by}), L2 bytes per launch {l2 / 1e9:.3f} GB: " + "; ".join(cells),
              flush=True)


if __name__ == "__main__":
    main()
