"""Which functions of the port launch PyTorch's own kernels in one served pair.

    python scripts/probe_serving_ops.py   # on a CUDA card

Builds ``chip_smoke.py``'s cell (se3ete.3dmatch on the port's serving cut,
synthetic pair 0 at point_limit 20000 with host influence, weights from
the experiment's seed), serves the pair eagerly twice to warm up, then once
under ``torch.profiler`` with Python stacks.  The profiler ties each kernel
to the PyTorch operator that launched it; the script charges the kernel's
device time to the innermost function of the port on that operator's
Python stack.
The captured graph replays the same kernels (its launch counts equal the
eager pair's), so this is also where a replayed pair's time goes.

Prints the card, the pair's kernel total, the part launched by PyTorch
operators (the rest is the port's own CUDA kernels, launched outside any
operator), the 30 functions of the port whose operators take the most
device time (ms, kernels, operator names), and the same by file.
"""

import collections
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


def _port_line(event):
    """The innermost function of the port on an operator's Python stack, as
    ``se3et_tpu_torch/<file>(<line of its def>): <name>``, or None.  The
    stack is the event's own where the profiler fills it, else the chain
    of Python function events above it."""
    names = list(event.stack or [])
    if not names:
        parent = event.cpu_parent
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
    for name in names:  # innermost first
        m = _FRAME.match(name)
        if m and "se3et_tpu_torch/" in m.group(1):
            path = m.group(1)[m.group(1).rindex("se3et_tpu_torch/"):]
            return f"{path}({m.group(2)}): {m.group(3)}"
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_serving_ops: no CUDA device", file=sys.stderr)
        return 1
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from se3et_tpu_torch.data.influence import precompute_influence
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)
    data = pyramid_to_tensors(precompute_influence(pair, cfg.model), "cuda")
    forward = make_forward(SE3ETModel(cfg.model, seed=cfg.seed).eval())
    for _ in range(2):
        forward(data)
    torch.cuda.synchronize()
    # verbose: the profiler then fills each operator's Python stack (with
    # CUDA activity on, with_stack alone records none)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True,
                 experimental_config=_ExperimentalConfig(verbose=True)) as prof:
        forward(data)
        torch.cuda.synchronize()

    events = prof.events()
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    by_line = collections.defaultdict(lambda: [0.0, 0, collections.Counter()])
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        row = by_line[_port_line(e) or "outside the port"]
        row[0] += sum(k.duration for k in e.kernels) / 1e3
        row[1] += len(e.kernels)
        row[2][e.name] += len(e.kernels)
    by_op = sum(r[0] for r in by_line.values())
    print(f"one eager pair: kernels {total:.3f} ms, launched by PyTorch operators "
          f"{by_op:.3f} ms ({sum(r[1] for r in by_line.values())} kernels), the port's own "
          f"kernels (outside any operator) {total - by_op:.3f} ms", flush=True)
    print("by function of the port (innermost on the operator's stack; the line of "
          "its def):", flush=True)
    ranked = sorted(by_line.items(), key=lambda kv: kv[1][0], reverse=True)
    for line, (ms, n, ops) in ranked[:30]:
        names = ", ".join(f"{op} x{c}" for op, c in ops.most_common(3))
        print(f"  {ms:8.3f} ms  {n:5d} kernels  {line[:90]}  [{names}]", flush=True)
    by_file = collections.defaultdict(lambda: [0.0, 0])
    for line, (ms, n, _) in by_line.items():
        f = line.split("(")[0]
        by_file[f][0] += ms
        by_file[f][1] += n
    print("by file:", flush=True)
    for f, (ms, n) in sorted(by_file.items(), key=lambda kv: kv[1][0], reverse=True):
        print(f"  {ms:8.3f} ms  {n:5d} kernels  {f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
