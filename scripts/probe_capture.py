"""Which calls of the serving forward stop it from being captured into a
CUDA graph, and whether it captures.

    python scripts/probe_capture.py [--tree DIR]   # on a CUDA card

Imports the port from DIR (default: this checkout; for another commit, a
``git archive`` of it unpacked under the gitignored
``se3et_tpu_torch/_build/``).  On each serving route -- the tiny float32
cuts (materialised; flash; flash with ``serve_femb``; materialised on a
pair without host influence, so K15 runs) and se3ete.3dmatch in bf16 at
the JAX entry's stage caps with host influence -- it serves one pair
eagerly to warm up, then once more under
``torch.cuda.set_sync_debug_mode("warn")``, and prints every line of the
port whose call made the host wait for the card (a value read back, or a
copy from pageable host memory), with its count per pair.  Then, route by
route, it captures ``model(data, train=False, with_registration=True)``
into a ``torch.cuda.CUDAGraph`` after two warm-up calls on a side stream
(PyTorch's recipe), replays it and compares every output with the eager
forward bit for bit, or prints the capture's error and attempts no further
capture (a failed capture can leave the stream unusable).  Prints the card
first.
"""

import argparse
import collections
import dataclasses
import os
import subprocess
import sys
import traceback
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("materialised", "flash", "flash_femb", "device_influence", "entry_width")


def _route(route, dev):
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.entry import ENTRY_POINTS, entry_config
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, tiny_config, tiny_flash_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    base = serving_config(make_cfg("se3ete.3dmatch"))
    if route == "entry_width":
        cfg, points = entry_config(), ENTRY_POINTS
    elif route.startswith("flash"):
        cfg, points = tiny_flash_config(base), 600
    else:
        cfg, points = tiny_config(base), 250
    mcfg = dataclasses.replace(cfg.model, serve_femb=route == "flash_femb")
    pair = synthetic_pair(0, cfg.pipeline, None if route == "device_influence" else mcfg,
                          points, 2.0)
    model = SE3ETModel(mcfg, seed=3, device=dev).eval()
    return (lambda d: model(d, train=False, with_registration=True),
            pyramid_to_tensors(pair, dev))


def _sync_sites(forward, data, tree):
    """{port line: count} of the calls that synchronised in one forward."""
    sites = collections.Counter()
    port = os.path.join(tree, "se3et_tpu_torch") + os.sep

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(port)]
        f = frames[-1] if frames else None
        sites[f"{os.path.relpath(f.filename, tree)}:{f.lineno} {f.line.strip()}"
              if f else "outside the port"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            forward(data)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def _capture(forward, data):
    """Capture, replay and compare with eager; returns a line of text and
    whether the capture went through."""
    want = forward(data)
    static = {k: v.clone() for k, v in data.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            forward(static)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = forward(static)
    except RuntimeError as err:  # the finding this probe reports
        return f"capture failed: {type(err).__name__}: {str(err).splitlines()[0][:300]}", False
    graph.replay()
    torch.cuda.synchronize()
    differ = [k for k, v in want.items()
              if torch.is_tensor(v) and not torch.equal(_bits(out[k]), _bits(v))]
    return ("captured; replay equal to eager bit for bit, every output" if not differ
            else f"captured; replay differs from eager in {differ}"), True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO, help="the checkout whose port is probed")
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        print("probe_capture: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, tree)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    print(f"tree {tree}", flush=True)
    dev = torch.device("cuda", 0)
    runs = {r: _route(r, dev) for r in ROUTES}
    for route, (forward, data) in runs.items():
        forward(data)  # warm-up: kernel builds, attributes, handles, caches
        sites = _sync_sites(forward, data, tree)
        print(f"{route}: {sum(sites.values())} synchronising calls per pair", flush=True)
        for site, n in sites.most_common():
            print(f"  {n:3d}  {site}", flush=True)
    for route, (forward, data) in runs.items():
        text, ok = _capture(forward, data)
        print(f"{route}: {text}", flush=True)
        if not ok:
            print("no further capture attempted", flush=True)
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
