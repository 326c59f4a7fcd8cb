"""What holds K4's rows form back, and how its plan moves it.

    python scripts/probe_sinkhorn.py   # on a CUDA card

Builds variants of ``se3et_tpu_torch/csrc/sinkhorn.cu`` into
``se3et_tpu_torch/_build/probe_sinkhorn/``, each a copy of the source with
one setting changed, compiled with ``-Xptxas -v`` (registers and spills of
the rows-form instance the variant's plan picks at the serving shape):

* ``committed``: the source as it stands (2 lanes per row at 65 x 65);
* ``lanes1`` / ``lanes4``: 1 or 4 lanes per row (the largest register
  slice ``kMaxChunk`` set to 68, with an instance for 68-entry slices, or
  to 20 entries);
* ``patches2`` / ``patches4``: 2 or 4 patches per block, each synchronising
  its own warps on its own named barrier;
* ``chains1`` / ``chains3`` / ``chains4``: independent FMA chains per dot
  product;
* ``wide576``: the instance built for blocks of up to 576 threads (96
  registers a thread) at the serving shape, in place of the one for 256;
* ``approx``: ``lg2.approx`` / ``ex2.approx`` in the loop in place of
  ``logf`` / ``expf``;
* ``smem``: the first design (``sinkhorn_smem_kernel``), the yardstick;
* ablations that compute something else, to show what the time is made
  of: ``no_dot`` (each dot product one 16-byte shared load and four FMAs:
  the chain floor of log, exp, shuffle and barrier) and
  ``no_transcendentals`` (log and exp as multiply-adds).

At the serving shape of se3ete.3dmatch (256 patches of 65 x 65 float32 from
``selfcheck.sinkhorn_inputs``) it times each variant's C entry point with
CUDA events over 20 launches at 100 iterations and at 0 (the prologue and
epilogue alone), in turns (the list forward, then backward; the smaller
time kept), and prints per variant the plan (lanes per row, slice width,
warps per patch, patches per block), registers and spills, ms per launch,
ms without iterations, us per iteration, and the largest difference from
the plain version on valid entries (K4's tolerance 1e-4) on those inputs
and at large scores (valid scores scaled to reach 176, as the seed-0
weights give ``entry()``'s pair, with a patch of one valid entry).  Then
the committed build at one and two patches per SM (132 and 264 patches,
in turns), and, at large scores, the plain version and the committed
build against the plain version in float64 after 1 and 100 iterations
(how far float32 itself drifts).  Last, the training step's Sinkhorn at
the same shape: the committed forward (K4) and the backward, which
replays ``sinkhorn_scan`` eagerly, timed with CUDA events and by
``torch.profiler`` (device time and kernel launches).  Prints the card
first.
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

from se3et_tpu_torch.ops.kernels import _build, selfcheck, sinkhorn  # noqa: E402

CHUNK = "constexpr int kMaxChunk = 36;"
PATCHES = "constexpr int kPatchesPerBlock = 1;"
CHAINS = "constexpr int kChains = 2;"
WIDTHS = "constexpr int kChunks[] = {4, 8, 12, 16, 20, 24, 28, 32, 36};"
CASE36 = "      case 36: return launch_rows_for<36>(p, s, mu, nu, o, batch, m, n, iters, st);"
NARROW = "if (p.patches * p.warps * 32 <= kNarrowThreads)"
LOG = "float log_step(float x) { return logf(x); }"
EXP = "float exp_step(float x) { return expf(x); }"
DOT = "const float4 w = *reinterpret_cast<const float4*>(x + k);"
VARIANTS = {
    "committed": (),
    "lanes1": ((CHUNK, "constexpr int kMaxChunk = 68;"), (WIDTHS, WIDTHS[:-2] + ", 68};"),
               (CASE36, CASE36 + "\n" + CASE36.replace("36", "68"))),
    "lanes4": ((CHUNK, "constexpr int kMaxChunk = 20;"),),
    "patches2": ((PATCHES, "constexpr int kPatchesPerBlock = 2;"),),
    "patches4": ((PATCHES, "constexpr int kPatchesPerBlock = 4;"),),
    "chains1": ((CHAINS, "constexpr int kChains = 1;"),),
    "chains3": ((CHAINS, "constexpr int kChains = 3;"),),
    "chains4": ((CHAINS, "constexpr int kChains = 4;"),),
    "wide576": ((NARROW, "if (false)"),),
    "approx": (
        (LOG, 'float log_step(float x) { float y; asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) '
              ': "f"(x)); return y * 0.69314718f; }'),
        (EXP, 'float exp_step(float x) { float y; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) '
              ': "f"(x * 1.44269504f)); return y; }'),
    ),
    "smem": (),
    # ablations (outputs differ): the dot product as one 16-byte shared load
    # and four FMAs (the loop keeps its dependence on the other side); log
    # and exp as multiply-adds
    "no_dot": ((DOT, "const float4 w = *reinterpret_cast<const float4*>(x); "
                     "if (k > 0) break;"),),
    "no_transcendentals": ((LOG, "float log_step(float x) { return x * 1e-3f - 1.f; }"),
                           (EXP, "float exp_step(float x) { return x * 1e-3f + 1.f; }")),
}
ABLATIONS = ("no_dot", "no_transcendentals")
B, M, N, ITERS, REPS = 256, 65, 65, 100, 20


def _build_variants():
    out_dir = os.path.join(_build.BUILD_DIR, "probe_sinkhorn")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(_build.CSRC_DIR, src)
        path = os.path.join(src, "sinkhorn.cu")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"probe_sinkhorn: {old!r} not found once in sinkhorn.cu")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(src, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(src, "lib.so"))
        fn = lib.se3et_sinkhorn_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan_fn = lib.se3et_sinkhorn_plan
        plan_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        plan_fn.restype = ctypes.c_int
        plan = (ctypes.c_int * 6)()
        plan_fn(M, N, plan)
        plan = tuple(plan)
        entry = ("sinkhorn_smem_kernel" if name == "smem" or plan[0] != 1
                 else f"sinkhorn_rows_kernelILi{plan[2]}ELi{_instance(name, plan)}E")
        libs[name] = (fn, plan, _usage(log, entry))
    return libs


def _instance(name, plan):
    """Threads per block of the rows-form instance a variant launches."""
    return 576 if name == "wide576" or plan[4] * plan[3] * 32 > 256 else 256


def _usage(log, entry):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            after = "\n".join(lines[i + 1:i + 5])
            spill = re.search(r"(\d+) bytes spill stores", after)
            regs = re.search(r"Used (\d+) registers", after)
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} bytes spilled")
    return "registers not reported"


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_sinkhorn: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = _build_variants()
    dev = torch.device("cuda")
    inputs = {"serving": selfcheck.sinkhorn_inputs(B, M, N, dev),
              "large": selfcheck.sinkhorn_inputs(B, M, N, dev, single_entry=True, peak=176.0)}
    stream = torch.cuda.current_stream().cuda_stream
    outs, calls = {}, {}
    for name, (fn, plan, _) in libs.items():
        out = torch.empty_like(inputs["serving"][0])
        form = 2 if name == "smem" else plan[0]

        def call(iters, case="serving", fn=fn, out=out, form=form):
            padded, mu, nu, _ = inputs[case]
            _build.check(fn(padded.data_ptr(), mu.data_ptr(), nu.data_ptr(), out.data_ptr(),
                            B, M, N, iters, form, stream), "K4 variant")
        outs[name], calls[name] = out, call
    ms = {name: {ITERS: [], 0: []} for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for iters in (ITERS, 0):
                ms[name][iters].append(
                    selfcheck._time_ms(lambda c=calls[name], i=iters: c(i), REPS))
    want = {case: sinkhorn.sinkhorn_plain(*inputs[case][:3], ITERS) for case in inputs}
    for name, (_, plan, usage) in libs.items():
        diff = {}
        for case, (_, _, _, valid) in inputs.items():
            calls[name](ITERS, case)
            torch.cuda.synchronize()
            diff[case] = float((outs[name] - want[case])[valid].abs().max())
        full, none = min(ms[name][ITERS]), min(ms[name][0])
        flag = "" if max(diff.values()) <= 1e-4 or name in ABLATIONS else " DIFFERS"
        shape = ("first design, one 256-thread block per patch" if name == "smem" else
                 f"{plan[1]} lanes per row, slices of {plan[2]}, {plan[3]} warps per patch, "
                 f"{plan[4]} patch(es) per block")
        print(f"K4 {name}: {shape}; {usage}; {full:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ms[name][ITERS])}), {none:.4f} ms at 0 "
              f"iterations, {(full - none) / ITERS * 1e3:.3f} us per iteration; max diff on "
              f"valid entries {diff['serving']:.3e}, at large scores {diff['large']:.3e}{flag}",
              flush=True)
    committed = _runner(libs["committed"])
    _occupancy(committed, dev)
    _drift(committed, inputs["large"])
    _backward(*inputs["serving"][:3])


def _runner(lib):
    """The variant's C entry point as ``f(padded, mu, nu, iters) -> out``."""
    fn, plan, _ = lib
    stream = torch.cuda.current_stream().cuda_stream

    def run(padded, mu, nu, iters):
        out = torch.empty_like(padded)
        _build.check(fn(padded.data_ptr(), mu.data_ptr(), nu.data_ptr(), out.data_ptr(),
                        padded.shape[0], M, N, iters, plan[0], stream), "K4 variant")
        return out
    return run


def _occupancy(run, dev):
    """ms per launch at one and two patches per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {b: selfcheck.sinkhorn_inputs(b, M, N, dev)[:3] for b in (sms, 2 * sms)}
    ms = {b: [] for b in cases}
    for order in (list(cases), list(cases)[::-1]):
        for b in order:
            ms[b].append(selfcheck._time_ms(lambda a=cases[b]: run(*a, ITERS), REPS))
    print("K4 committed by patches per SM: " + "; ".join(
        f"{b} patches ({b // sms} per SM) {min(t):.4f} ms" for b, t in ms.items()), flush=True)


def _drift(run, case):
    """At large scores: the plain version in float32 and the committed
    build against the plain version in float64, on valid entries."""
    padded, mu, nu, valid = case
    line = []
    for iters in (1, ITERS):
        ref = sinkhorn.sinkhorn_plain(padded.double(), mu.double(), nu.double(), iters)
        plain = sinkhorn.sinkhorn_plain(padded, mu, nu, iters).double()
        kern = run(padded, mu, nu, iters).double()
        err = {name: float((x - ref)[valid].abs().max())
               for name, x in (("plain", plain), ("kernel", kern))}
        line.append(f"{iters} iteration(s): plain float32 {err['plain']:.3e}, committed "
                    f"{err['kernel']:.3e}")
    print("K4 at large scores against float64: " + "; ".join(line), flush=True)


def _backward(padded, mu, nu):
    """The training step's Sinkhorn: K4 forward, then the eager backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scores = padded.clone().requires_grad_(True)
    grad = torch.randn(scores.shape, generator=torch.Generator().manual_seed(0)).to(scores)

    def step():
        sinkhorn.sinkhorn(scores, mu, nu, ITERS).backward(grad)
    ms = selfcheck._time_ms(step, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    device = sum(getattr(e, attr) for e in events) / 1e3
    k4 = sum(getattr(e, attr) for e in events if "sinkhorn_rows_kernel" in e.key) / 1e3
    print(f"K4 training step ({B}, {M}, {N}), {ITERS} iterations: forward + backward "
          f"{ms:.2f} ms by events; kernels {device:.2f} ms device over "
          f"{sum(e.count for e in events)} launches, of which K4 {k4:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
