"""What holds the tc forms of K6 and K7 back, and how their tiling and warp
split move them.

    python scripts/probe_eq_attention.py [--kernel k6|k6w|k7|k7w|all]   # on a CUDA card

Builds variants of the bf16 K6 and K7 (``eq_tc`` in
``se3et_tpu_torch/csrc/eq_attention.cu``) into
``se3et_tpu_torch/_build/probe_eq/``, each a copy of the source with one
setting changed, compiled with ``-Xptxas -v`` (registers and spills of the
kernel printed; K6's serving instance, positive "sq" without sup).

K6 at head width 64 (``eq_stats_tc_kernel<64, ...>``, ``--kernel k6``; the
``kStats*`` settings):

* ``committed``: the source as it stands (32-key tiles in 8 ring slots, 9
  consumer warps of one 16-row m-tile each, q in shared memory, a
  persistent grid of E x SMs / E blocks, a lane's reference max moved only
  past a slack of 8 in scale * q . k);
* ``mt2``: two m-tiles per warp sharing each k fragment (4 slots);
  ``qregs``: q fragments held in registers;
* ``keys64``: 64-key tiles, two 32-key steps each (4 slots); ``stages4``:
  4 ring slots;
* ``warps7`` / ``warps12``: 7 or 12 consumer warps;
* ``per_item``: one block per (e, pass, block) item instead of the
  persistent walk;
* ``eager``: no slack, the reference max moved whenever a lane's step max
  passes it;
* ablations that compute something else, to show what the time is made
  of: ``no_exp`` (each exp a multiply) and ``no_mma`` (no tensor-core
  products; the fragments still read).

K6 at head width 32 (``eq_stats_tc_kernel<32, ...>``, ``--kernel k6w``; the
``kStats32*`` settings), each variant a whole plan:

* ``committed``: the source as it stands (a plan below that equals it is
  not built again: the probe names it);
* ``plan64``: 64's settings at 32 (32-key tiles, 8 slots, 9 warps, one
  m-tile, q in shared memory, one rescale vote a step);
* ``keys32`` / ``keys64`` / ``keys128``: staged tiles of 32, 64 or 128
  keys (8, 8 and 4 slots: 8, 16 and 32 KB a slot);
* ``stages2`` / ``stages4`` / ``stages6``: ring slots;
* ``mt2``: two m-tiles a warp sharing each k fragment (q in shared
  memory); ``qregs`` / ``qsmem``: q in registers or in shared memory;
* ``warps7`` / ``warps11`` / ``warps12``: 7, 11 or 12 consumer warps
  (``warps12_qsmem``: 12 with q in shared memory, under 13 warps' 128
  registers);
* ``headvote`` / ``stepvote``: a lane's rescale voted once a head (a
  head's exps free to start while the later heads' products run) or once a
  32-key step (64's way);
* ablations ``no_exp`` and ``no_mma`` as at 64;
* ``first``: the first design (the CUDA-core ``eq_stats_kernel<bf16, 4,
  32>``, ``se3et_eq_attention_stats_cuda_bf16``) of the committed build.

K7 at head width 64 (``eq_apply_tc_kernel<64>``, ``--kernel k7``):

* ``committed``: the source as it stands (wgmma, three warpgroups of 64
  query rows per block, 64-key k and v tiles in 4 ring slots, q in
  registers, a persistent grid of H x SMs / H blocks grouped by head: one
  pass at the serving shape);
* ``warps8``: two warpgroups (two passes); ``stages8``: 8 ring slots;
* ``per_item``: one block per (head, pass, block) item;
* ablations: ``no_exp`` (each exp a multiply) and ``no_mma`` (no products:
  each wgmma an integer mix of its register operand, k and v not read).

K7 at head width 32 (``eq_apply_tc_kernel<32>``, ``--kernel k7w``; the
``kApply32*`` settings):

* ``committed``: the source as it stands (128-key tiles under the 64-byte
  swizzle, q k^T on m64n128k16, in 6 ring slots; three warpgroups; every
  consumer branch warp-uniform);
* ``keys64`` / ``keys32``: 64- or 32-key tiles;
* ``stages2`` / ``stages4``: 2 or 4 ring slots; ``warps8``: two consumer
  warpgroups (two passes);
* ``per_item``: one block per (head, pass, block) item;
* ablations ``no_exp`` and ``no_mma`` as at 64;
* ``first``: the first design (the CUDA-core ``eq_apply_kernel<bf16, 4,
  32>``, ``se3et_eq_attention_apply_cuda_bf16``) of the committed build.

At the serving shapes of se3ete.3dmatch (q, k, v (6, 4, 1024, 64) bf16)
and se3ete2.3dmatch (head width 32), 24 query rows and 40 keys masked at
the end, it times each variant's C entry point with CUDA events in turns
(the list forward, then backward; the smaller time kept), checks each
against the plain version (K6: every output within 1e-3 of its scale; K7:
within 1e-2 of max |out|, its kernel-vs-plain tolerance), and prints per
variant its registers, spills and any ptxas line about wgmma (a
serialisation), the blocks resident per SM, the grid, and the bytes the
kernel moves through L2 per launch (K6: k[e] once per pass and staged tile
of each block; K7: k[e, h] and v[e, h] for every e once per pass of each
block; q once, the row statistics, partials and outputs once) with their
rate, and the exponential rate (one per score with a valid key) against
the card's 4.18e12/s.  Prints the card first.
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

from se3et_tpu_torch.ops.kernels import _build, eq_attention, selfcheck  # noqa: E402

KEYS = "constexpr int kStatsKeys = 32;"
STAGES = "constexpr int kStatsStages = 8;"
WARPS = "constexpr int kStatsConsumers = 9;"
MT = "constexpr int kStatsMT = 1;"
QSMEM = "constexpr bool kStatsQInSmem = true;"
SLACK = "constexpr float kSlackScaled = 8.f;"
PERSISTENT = "constexpr bool kPersistent = true;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
MMA0 = "mma_bf16(s[mt][h][jn], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);"
MMA1 = "mma_bf16(s[mt][h][jn + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);"
NO_EXP = ((EX2, "y = x * 0.5f;"),)
# ablation, not the function: the products as an integer mix of the
# fragments (outputs differ)
K6_NO_MMA = ((MMA0, "s[mt][h][jn][0] += __uint_as_float((a[mt][0] ^ b[0]) & 0x3f7fffffu);"),
             (MMA1, "s[mt][h][jn + 1][0] += __uint_as_float((a[mt][3] ^ b[3]) & 0x3f7fffffu);"))
K6_VARIANTS = {
    "committed": (),
    "mt2": ((MT, "constexpr int kStatsMT = 2;"), (STAGES, "constexpr int kStatsStages = 4;")),
    "qregs": ((QSMEM, "constexpr bool kStatsQInSmem = false;"),),
    "keys64": ((KEYS, "constexpr int kStatsKeys = 64;"),
               (STAGES, "constexpr int kStatsStages = 4;")),
    "stages4": ((STAGES, "constexpr int kStatsStages = 4;"),),
    "warps7": ((WARPS, "constexpr int kStatsConsumers = 7;"),),
    "warps12": ((WARPS, "constexpr int kStatsConsumers = 12;"),),
    "per_item": ((PERSISTENT, "constexpr bool kPersistent = false;"),),
    "eager": ((SLACK, "constexpr float kSlackScaled = 0.f;"),),
    "no_exp": NO_EXP,
    "no_mma": K6_NO_MMA,
}
# K6 at head width 32: each variant sets every kStats32* value it names
W6 = {"keys": "kStats32Keys", "stages": "kStats32Stages", "warps": "kStats32Consumers",
      "mt": "kStats32MT", "qsmem": "kStats32QInSmem", "vote": "kStats32HeadVote"}


def _w6_line(key, src):
    """The committed source's line of the head-width-32 setting ``key``."""
    m = re.search(rf"constexpr (int|bool) {W6[key]} = [^;]+;", src)
    return m.group(0)


def _w6(**plan):
    """Edits of the source that set the named head-width-32 settings."""
    src = open(os.path.join(_build.CSRC_DIR, "eq_attention.cu")).read()
    edits = []
    for key, value in plan.items():
        line = _w6_line(key, src)
        kind = line.split()[1]
        text = ("true" if value else "false") if kind == "bool" else str(value)
        new = f"constexpr {kind} {W6[key]} = {text};"
        if new != line:
            edits.append((line, new))
    return tuple(edits)


K6W_PLANS = {
    "committed": {},
    "plan64": dict(keys=32, stages=8, warps=9, mt=1, qsmem=True, vote=False),
    "keys32": dict(keys=32, stages=8), "keys64": dict(keys=64, stages=8),
    "keys128": dict(keys=128, stages=4),
    "stages2": dict(stages=2), "stages4": dict(stages=4), "stages6": dict(stages=6),
    "mt2": dict(mt=2, qsmem=True), "qregs": dict(qsmem=False), "qsmem": dict(qsmem=True),
    "warps7": dict(warps=7), "warps11": dict(warps=11), "warps12": dict(warps=12),
    "warps12_qsmem": dict(warps=12, qsmem=True),
    "headvote": dict(vote=True), "stepvote": dict(vote=False),
}
# a plan that is the committed one is built and timed once, as "committed"
K6W_SAME = [name for name, plan in K6W_PLANS.items() if name != "committed" and not _w6(**plan)]
K6W_VARIANTS = {**{name: _w6(**plan) for name, plan in K6W_PLANS.items() if name not in K6W_SAME},
                "no_exp": NO_EXP, "no_mma": K6_NO_MMA}
A_STAGES = "constexpr int kApplyStages = 4;"
A_WARPS = "constexpr int kApplyConsumers = 12;"
A_PERSISTENT = "constexpr bool kApplyPersistent = true;"
A_QK64 = "wgmma_rs<0>(&s[8 * c][0], qf[kk], d);"
A_QK32 = "wgmma_rs_n32<0>(&s[4 * c][0], qf[kk], d);"
A_QK128 = "wgmma_rs_n128<0>(&s[16 * c][0], qf[kk], d);"
A_PV64 = "wgmma_rs<1>(&o[0][0], p, d);"
A_PV32 = "wgmma_rs_n32<1>(&o[0][0], p, d);"
# ablations of K7 (outputs differ): the exps as a multiply; no products,
# each wgmma an integer mix of its register operand (of every score, and of
# every p, so that no exp is folded or dead; k and v are not read)
QK_MIX = ("\n#pragma unroll\n"
          "for (int i = 0; i < P::kChunk / 2; ++i) (&s[P::kChunk / 8 * c][0])[i] += "
          "__uint_as_float((qf[kk][i & 3] + i) & 0x3f7fffffu);")
A_NO_MMA = ((A_QK64, QK_MIX), (A_QK32, QK_MIX), (A_QK128, QK_MIX),
            (A_PV64, "o[0][kc] += __uint_as_float((p[0] ^ p[1] ^ p[2] ^ p[3]) & 0x3f7fffffu);"),
            (A_PV32, "o[0][kc] += __uint_as_float((p[0] ^ p[1] ^ p[2] ^ p[3]) & 0x3f7fffffu);"))
K7_VARIANTS = {
    "committed": (),
    "warps8": ((A_WARPS, "constexpr int kApplyConsumers = 8;"),),
    "stages8": ((A_STAGES, "constexpr int kApplyStages = 8;"),),
    "per_item": ((A_PERSISTENT, "constexpr bool kApplyPersistent = false;"),),
    "no_exp": NO_EXP,
    "no_mma": A_NO_MMA,
}
W_KEYS = "constexpr int kApply32Keys = 128;"
W_STAGES = "constexpr int kApply32Stages = 6;"
W_WARPS = "constexpr int kApply32Consumers = 12;"
K7W_VARIANTS = {
    "committed": (),
    "keys64": ((W_KEYS, "constexpr int kApply32Keys = 64;"),),
    "keys32": ((W_KEYS, "constexpr int kApply32Keys = 32;"),),
    "stages2": ((W_STAGES, "constexpr int kApply32Stages = 2;"),),
    "stages4": ((W_STAGES, "constexpr int kApply32Stages = 4;"),),
    "warps8": ((W_WARPS, "constexpr int kApply32Consumers = 8;"),),
    "per_item": ((A_PERSISTENT, "constexpr bool kApplyPersistent = false;"),),
    "no_exp": NO_EXP,
    "no_mma": A_NO_MMA,
}
# K6's and K7's first designs, timed beside the head-width-32 variants from
# the committed build: (C entry point, mangled kernel name)
FIRST = "first"
FIRSTS = {"k6w": ("se3et_eq_attention_stats_cuda_bf16", "eq_stats_kernelI13__nv_bfloat16Li4ELi32E"),
          "k7w": ("se3et_eq_attention_apply_cuda_bf16", "eq_apply_kernelI13__nv_bfloat16Li4ELi32E")}
# per kernel: variants, the entry function whose registers are printed,
# the C entry point (pointers, ints), the occupancy query and the head width
KERNELS = {
    "k6": (K6_VARIANTS, "eq_stats_tc_kernelILi64ELi1ELb0E", "se3et_eq_attention_stats_bf16", 10,
           7, "se3et_eq_attention_stats_blocks_per_sm", 64),
    "k6w": (K6W_VARIANTS, "eq_stats_tc_kernelILi32ELi1ELb0E", "se3et_eq_attention_stats_bf16",
            10, 7, "se3et_eq_attention_stats_blocks_per_sm", 32),
    "k7": (K7_VARIANTS, "eq_apply_tc_kernelILi64E", "se3et_eq_attention_apply_bf16", 8, 6,
           "se3et_eq_attention_apply_blocks_per_sm", 64),
    "k7w": (K7W_VARIANTS, "eq_apply_tc_kernelILi32E", "se3et_eq_attention_apply_bf16", 8, 6,
            "se3et_eq_attention_apply_blocks_per_sm", 32),
}
A = E = 6
H, N, M = 4, 1024, 1024


def _setting(edits, line):
    """The value of the setting on source line ``line`` in a variant's
    build: its edit's, else the line's own."""
    for old, new in edits:
        if old == line:
            line = new
            break
    value = re.search(r"= ([^;]+);", line).group(1)
    return value == "true" if " bool " in line else int(value)


def _k6_lines(kernel):
    """K6's source lines of the tile keys, m-tiles and consumer warps of the
    width ``kernel`` probes."""
    if kernel == "k6":
        return KEYS, MT, WARPS
    src = open(os.path.join(_build.CSRC_DIR, "eq_attention.cu")).read()
    return tuple(_w6_line(key, src) for key in ("keys", "mt", "warps"))


def _usage(lines, entry):
    """Registers and spills of the kernel whose mangled name holds ``entry``
    in an ``-Xptxas -v`` log."""
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            after = "\n".join(lines[i + 1:i + 5])
            spill = re.search(r"(\d+) bytes spill stores", after)
            regs = re.search(r"Used (\d+) registers", after)
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} bytes spilled")
    return "?"


def _build_variants(kernel):
    variants, entry, symbol, n_ptr, n_int, occupancy, c = KERNELS[kernel]
    out_dir = os.path.join(_build.BUILD_DIR, "probe_eq", kernel)
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, edits in variants.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC_DIR, src)
        path = os.path.join(src, "eq_attention.cu")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"probe_eq_attention: {old!r} not found once in eq_attention.cu")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(src, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {kernel} {name}:\n{log}")
        lines = log.splitlines()
        usage[name] = _usage(lines, entry)
        serial = sorted({line.strip() for line in lines if "wgmma" in line})
        if serial:
            usage[name] += "; ptxas: " + " | ".join(serial)
        lib = ctypes.CDLL(os.path.join(src, "lib.so"))
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = getattr(lib, occupancy)
        occ.argtypes = [ctypes.c_int] * 2
        occ.restype = ctypes.c_int
        libs[name] = (fn, lambda m, occ=occ: occ(m, c))
        if kernel in FIRSTS and name == "committed":  # the first design, same build
            symbol_first, entry_first = FIRSTS[kernel]
            first = getattr(lib, symbol_first)
            first.argtypes = fn.argtypes
            first.restype = ctypes.c_int
            libs[FIRST] = (first, lambda m: None)
            usage[FIRST] = _usage(lines, entry_first)
    return libs, usage


def _valid_tiles(km, keys):
    return sum(1 for j in range(-(-M // keys)) if bool(km[j * keys:(j + 1) * keys].any()))


def _block_passes(units, warps, groups, sms):
    """(blocks per group, passes, block-passes with a unit) of a persistent
    grid of ``groups`` x SMs / groups blocks."""
    per = max(1, min(sms // groups, -(-units // warps)))
    passes = -(-units // (per * warps))
    busy = sum(1 for lb in range(per) for p in range(passes) if (p * per + lb) * warps < units)
    return per, passes, busy


def grid_and_l2(kernel, edits, km, sms):
    """(blocks, passes, bytes through L2 per launch) of a variant (K7's
    first design: None, None and the bytes of one read of each input)."""
    c = KERNELS[kernel][6]
    q_bytes = A * H * N * c * 2
    if kernel in ("k6", "k6w"):
        out_bytes = 2 * A * E * H * N * 4 + 2 * A * E * -(-N // 16) * 4
        if edits is None:
            return None, None, q_bytes + E * H * M * c * 2 + out_bytes
        keys, mt, warps = (_setting(edits, line) for line in _k6_lines(kernel))
        units = A * -(-N // (16 * mt))
        bpe, passes, busy = _block_passes(units, warps, E, sms)
        kv_bytes = E * busy * _valid_tiles(km, keys) * H * keys * c * 2
        return E * bpe, passes, kv_bytes + q_bytes + out_bytes
    io_bytes = 2 * A * E * H * N * 4 + A * H * N * c * 4
    if edits is None:
        return None, None, q_bytes + 2 * E * H * M * c * 2 + io_bytes
    if kernel == "k7":
        keys, warps = 64, _setting(edits, A_WARPS)
    else:
        keys, warps = _setting(edits, W_KEYS), _setting(edits, W_WARPS)
    units = A * -(-N // 64)  # warpgroup units of 64 query rows
    bph, passes, busy = _block_passes(units, warps // 4, H, sms)
    kv_bytes = H * busy * E * _valid_tiles(km, keys) * 2 * keys * c * 2
    return H * bph, passes, kv_bytes + q_bytes + io_bytes


def _runs(kernel, libs, dev):
    """{variant: (launch, outputs)} and the plain version's outputs."""
    C = KERNELS[kernel][6]
    g = torch.Generator().manual_seed(0)
    q = torch.randn((A, H, N, C), generator=g).to(dev, torch.bfloat16)
    k = torch.randn((E, H, M, C), generator=g).to(dev, torch.bfloat16)
    v = torch.randn((E, H, M, C), generator=g).to(dev, torch.bfloat16)
    qmask = torch.arange(N, device=dev) < N - 24
    kmask = torch.arange(M, device=dev) < M - 40
    stream = torch.cuda.current_stream().cuda_stream
    qm, km = qmask.to(torch.uint8), kmask.to(torch.uint8)
    runs = {}
    if kernel in ("k6", "k6w"):
        want = eq_attention.eq_attention_stats_plain(q, k, qmask, kmask)
        counts = float(qmask.sum()) * float(kmask.sum())
        for name, (fn, _) in libs.items():
            # the first design writes a slot per 8 rows, its sums not yet
            # divided by the valid (n, m) count
            parts, div = (-(-N // 8), counts + 1e-9) if name == FIRST else (
                eq_attention.eq_attention_stats_parts(H, N, C, q.dtype), 1.0)
            rowmax = torch.empty((A, E, H, N), dtype=torch.float32, device=dev)
            rowsum = torch.empty_like(rowmax)
            gpart = torch.empty((A, E, parts), dtype=torch.float32, device=dev)
            spart = torch.empty_like(gpart)

            def call(fn=fn, outs=(rowmax, rowsum, gpart, spart)):
                _build.check(fn(q.data_ptr(), k.data_ptr(), qm.data_ptr(), km.data_ptr(), None,
                                None, *(t.data_ptr() for t in outs), A, E, H, N, M, C, 1,
                                stream), "K6 variant")
            runs[name] = (call, lambda o=(rowmax, rowsum, gpart), d=div:
                          (o[0], o[1], o[2].sum(dim=-1) / d))
        return runs, want, kmask
    rowmax, rowsum, _ = eq_attention.eq_attention_stats_plain(q, k, qmask, kmask)
    w = torch.rand((A, E), generator=g).to(dev)
    w = w / w.sum(dim=1, keepdim=True)
    want = (eq_attention.eq_attention_apply_plain(q, k, v, w, rowmax, rowsum, kmask),)
    for name, (fn, _) in libs.items():
        out = torch.empty((A, H, N, C), dtype=torch.float32, device=dev)

        def call(fn=fn, out=out):
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                            rowmax.data_ptr(), rowsum.data_ptr(), km.data_ptr(), out.data_ptr(),
                            A, E, H, N, M, C, stream), "K7 variant")
        runs[name] = (call, lambda out=out: (out,))
    return runs, want, kmask


def probe(kernel, dev, sms):
    if kernel == "k6w":
        print(f"k6w: {', '.join(K6W_SAME) or 'no plan'} = the committed plan", flush=True)
    libs, usage = _build_variants(kernel)
    runs, want, kmask = _runs(kernel, libs, dev)
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name].append(selfcheck._time_ms(runs[name][0], 20))
    exps = A * E * H * N * int(kmask.sum())
    # K6: within 1e-3 of each output's scale; K7: 1e-2 of max |out|
    tol = 1e-3 if kernel in ("k6", "k6w") else 1e-2
    for name, (_, outputs) in runs.items():
        diff = max(float((x - y).abs().max()) / float(y.abs().max())
                   for x, y in zip(outputs(), want))
        t = min(ms[name])
        blocks, passes, l2 = grid_and_l2(kernel, KERNELS[kernel][0].get(name), kmask.cpu(),
                                         sms)
        flag = "" if diff <= tol else f" DIFFERS {diff:.2e}"
        grid = ("the first design's own grid" if blocks is None else
                f"{libs[name][1](M)} block(s) per SM, grid {blocks} x {passes} pass(es)")
        print(f"{kernel} {name}: {t:.4f} ms ({', '.join(f'{x:.4f}' for x in ms[name])}); "
              f"{usage[name]}; {grid}; "
              f"L2 {l2 / 1e6:.1f} MB per launch, {l2 / (t * 1e-3) / 1e12:.2f} TB/s; "
              f"exps {exps / (t * 1e-3) / 1e12:.2f}e12/s (card {selfcheck.EXP_RATE / 1e12:.2f}"
              f"e12/s); max diff / scale {diff:.2e}{flag}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("k6", "k6w", "k7", "k7w", "all"), default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_eq_attention: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel in (("k6", "k6w", "k7", "k7w") if args.kernel == "all" else (args.kernel,)):
        probe(kernel, dev, sms)


if __name__ == "__main__":
    main()
