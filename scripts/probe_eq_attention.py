"""What holds K6's tc form back, and how its tiling and warp split move it.

    python scripts/probe_eq_attention.py      # on a CUDA card (nvcc needed)

Builds variants of the bf16 K6 (``eq_tc`` in
``se3et_tpu_torch/csrc/eq_attention.cu``) into
``se3et_tpu_torch/_build/probe_eq/``, each a copy of the source with one
setting changed, compiled with ``-Xptxas -v`` (registers and spills of the
serving instance, positive "sq" without sup, printed):

* ``committed``: the source as it stands (32-key tiles in 8 ring slots, 9
  consumer warps of one 16-row m-tile each, q in shared memory, a
  persistent grid of E x SMs / E blocks, a lane's reference max moved only
  past a slack of 64 in q . k);
* ``mt2``: two m-tiles per warp sharing each k fragment (4 slots);
  ``qregs``: q fragments held in registers;
* ``keys64``: 64-key tiles (4 slots); ``stages4``: 4 ring slots;
* ``warps7`` / ``warps12``: 7 or 12 consumer warps;
* ``per_item``: one block per (e, pass, block) item instead of the
  persistent walk;
* ``eager``: no slack, the reference max moved whenever a lane's tile max
  passes it;
* ablations that compute something else, to show what the time is made
  of: ``no_exp`` (each exp a multiply) and ``no_mma`` (no tensor-core
  products; the fragments still read).

At the serving shape of se3ete.3dmatch (q, k (6, 4, 1024, 64) bf16, 24
query rows and 40 keys masked at the end) it times each variant's C entry
point with CUDA events in turns (the list forward, then backward; the
smaller time kept), checks each against K6's plain version (every output
within 1e-3 of its scale), and prints per variant the blocks resident per
SM, the grid, and the bytes the kernel moves through L2 per launch (k[e]
once per pass and staged tile of each block, q once, the row statistics
and partials once) with their rate, and the exponential rate (one per score
with a valid key) against the card's 4.18e12/s.  Prints the card first.
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

from se3et_tpu_torch.ops.kernels import _build, eq_attention, selfcheck  # noqa: E402

KEYS = "constexpr int kKeys = 32;"
STAGES = "constexpr int kStages = 8;"
SLACK = "constexpr float kSlack = 64.f;"
WARPS = "constexpr int kConsumers = 9;"
MT = "constexpr int kMT = 1;"
QSMEM = "constexpr bool kQInSmem = true;"
PERSISTENT = "constexpr bool kPersistent = true;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
MMA0 = "mma_bf16(s[mt][h][jn], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);"
MMA1 = "mma_bf16(s[mt][h][jn + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);"
VARIANTS = {
    "committed": (),
    "mt2": ((MT, "constexpr int kMT = 2;"), (STAGES, "constexpr int kStages = 4;")),
    "qregs": ((QSMEM, "constexpr bool kQInSmem = false;"),),
    "keys64": ((KEYS, "constexpr int kKeys = 64;"), (STAGES, "constexpr int kStages = 4;")),
    "stages4": ((STAGES, "constexpr int kStages = 4;"),),
    "warps7": ((WARPS, "constexpr int kConsumers = 7;"),),
    "warps12": ((WARPS, "constexpr int kConsumers = 12;"),),
    "per_item": ((PERSISTENT, "constexpr bool kPersistent = false;"),),
    "eager": ((SLACK, "constexpr float kSlack = 0.f;"),),
    # ablations, not the function: the exps as a multiply, the products as
    # an integer mix of the fragments (outputs differ)
    "no_exp": ((EX2, "y = x * 0.5f;"),),
    "no_mma": ((MMA0, "s[mt][h][jn][0] += __uint_as_float((a[mt][0] ^ b[0]) & 0x3f7fffffu);"),
               (MMA1, "s[mt][h][jn + 1][0] += __uint_as_float((a[mt][3] ^ b[3]) & 0x3f7fffffu);")),
}
A = E = 6
H, N, M, C = 4, 1024, 1024, 64


def _setting(edits, line, default):
    for old, new in edits:
        if old == line:
            return int(re.search(r"= (\d+)", new).group(1)) if "int" in new else "true" in new
    return default


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_eq")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
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
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        usage[name] = "?"
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "eq_stats_tc_kernelILi1ELb0E" in line:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                usage[name] = (f"{regs.group(1) if regs else '?'} registers, "
                               f"{spill.group(1) if spill else '?'} bytes spilled")
        lib = ctypes.CDLL(os.path.join(src, "lib.so"))
        lib.se3et_eq_attention_stats_bf16.argtypes = [ctypes.c_void_p] * 10 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.se3et_eq_attention_stats_bf16.restype = ctypes.c_int
        lib.se3et_eq_attention_stats_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.se3et_eq_attention_stats_blocks_per_sm.restype = ctypes.c_int
        libs[name] = lib
    return libs, usage


def grid_and_l2(edits, km, sms):
    """(blocks, passes, bytes through L2 per launch) of a variant."""
    keys = _setting(edits, KEYS, 32)
    warps = _setting(edits, WARPS, 9)
    units = A * -(-N // (16 * _setting(edits, MT, 1)))
    bpe = max(1, min(sms // E, -(-units // warps)))
    passes = -(-units // (bpe * warps))
    block_passes = sum(1 for lb in range(bpe) for p in range(passes)
                       if (p * bpe + lb) * warps < units)
    tiles = sum(1 for j in range(-(-M // keys)) if bool(km[j * keys:(j + 1) * keys].any()))
    k_bytes = E * block_passes * tiles * H * keys * C * 2
    q_bytes = A * H * N * C * 2
    out_bytes = 2 * A * E * H * N * 4 + 2 * A * E * -(-N // 16) * 4
    return E * bpe, passes, k_bytes + q_bytes + out_bytes


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_eq_attention: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs, usage = _build_variants()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    q = torch.randn((A, H, N, C), generator=g).to(dev, torch.bfloat16)
    k = torch.randn((E, H, M, C), generator=g).to(dev, torch.bfloat16)
    qmask = torch.arange(N, device=dev) < N - 24
    kmask = torch.arange(M, device=dev) < M - 40
    want = eq_attention.eq_attention_stats_plain(q, k, qmask, kmask)
    stream = torch.cuda.current_stream().cuda_stream
    qm, km = qmask.to(torch.uint8), kmask.to(torch.uint8)
    parts = eq_attention.eq_attention_stats_parts(H, N, C, q.dtype)
    runs = {}
    for name, lib in libs.items():
        rowmax = torch.empty((A, E, H, N), dtype=torch.float32, device=dev)
        rowsum = torch.empty_like(rowmax)
        gpart = torch.empty((A, E, parts), dtype=torch.float32, device=dev)
        spart = torch.empty_like(gpart)

        def call(lib=lib, outs=(rowmax, rowsum, gpart, spart)):
            _build.check(lib.se3et_eq_attention_stats_bf16(
                q.data_ptr(), k.data_ptr(), qm.data_ptr(), km.data_ptr(), None, None,
                *(t.data_ptr() for t in outs), A, E, H, N, M, C, 1, stream), "K6 variant")
        runs[name] = (call, (rowmax, rowsum, gpart))
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name].append(selfcheck._time_ms(runs[name][0], 20))
    exps = A * E * H * N * int(kmask.sum())
    for name, (_, (rowmax, rowsum, gpart)) in runs.items():
        got = (rowmax, rowsum, gpart.sum(dim=-1))
        diff = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(got, want))
        t = min(ms[name])
        blocks, passes, l2 = grid_and_l2(VARIANTS[name], kmask.cpu(), sms)
        flag = "" if diff <= 1e-3 else f" DIFFERS {diff:.2e}"
        print(f"{name}: {t:.4f} ms ({', '.join(f'{x:.4f}' for x in ms[name])}); {usage[name]}; "
              f"{libs[name].se3et_eq_attention_stats_blocks_per_sm(M)} block(s) per SM, grid "
              f"{blocks} x {passes} pass(es); L2 {l2 / 1e6:.1f} MB per launch, "
              f"{l2 / (t * 1e-3) / 1e12:.2f} TB/s; exps {exps / (t * 1e-3) / 1e12:.2f}e12/s "
              f"(card {selfcheck.EXP_RATE / 1e12:.2f}e12/s); max diff / scale {diff:.2e}{flag}",
              flush=True)


if __name__ == "__main__":
    main()
