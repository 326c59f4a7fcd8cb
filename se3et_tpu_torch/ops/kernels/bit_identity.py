"""This checkout's kernels against another checkout's, on one card: outputs
held bit for bit (or within a stated tolerance where a kernel changed on
purpose) and kernel times taken in turns.

    python -m se3et_tpu_torch.ops.kernels.bit_identity --other <another checkout>

Each checkout runs in processes of its own, with its own package, wrappers
and ``csrc`` (built with the same flags into its own
``se3et_tpu_torch/_build``), on the same seeded inputs: the other, this,
this, the other.  The first run of each saves its outputs; the four runs
time the kernels in ``TIMED`` with CUDA events.  Cases, at the serving
shapes of se3ete.3dmatch (bf16) and the tiny float32 widths:

* K3 (geometric embedding) at N = 1024, C = 256 in bf16, and N = 128,
  C = 64 in float32;
* K5 (flash RPE self-attention) on random inputs: AH = 24 with the SH term
  and AH = 4 without, at both widths;
* K12 (fused conv) at the stage-0 (x (2, 20000, 192), H 24) and stage-1
  (x (2, 10000, 384), H 32) shapes, and K13 at the s0 -> s1 strided shape;
* K16 (fused-embedding attention) at AH = 24 with SH and AH = 4 without,
  at both widths.

Each case is held bit for bit unless ``TOLERANCES`` names it: then the
largest difference over the other checkout's largest magnitude must stay
within the stated bound.  Prints one line per case, the times per turn,
the card's name and power limit, and exits non-zero if any case fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

TIMED = ("K12 stage 0", "K12 stage 1", "K3 N=1024 C=256 bf16")
REPS = 20  # launches per timing
# kernels redesigned on purpose, with their bound against the other build:
# K3 in bf16 now rounds the bases and G to bf16 (the TPU kernel's chain),
# where the first design rounded only the row (a bf16 ulp and the rounding
# of G, 1e-2 of the scale as the kernel-vs-plain check states); K12's float32
# sums of the gather run in another order before the per-k rounding (1e-2,
# as its kernel-vs-plain check states)
TOLERANCES = {"K3 N=1024 C=256 bf16": 1e-2, "K12 stage 0": 1e-2, "K12 stage 1": 1e-2}


def _cases(dev):
    """[(name, fn)] on seeded inputs; ``fn`` returns a tensor or a tuple."""
    from se3et_tpu_torch.ops.kernels import embedding, rpe_attention, selfcheck
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(0)
    cases = []
    for n, cc, hc, dtype in ((1024, 256, 64, torch.bfloat16), (128, 64, 16, torch.float32)):
        points = (torch.rand((2, n, 3), generator=g) * 4 - 2).to(dev)
        masks = torch.ones((2, n), dtype=torch.bool, device=dev)
        masks[1, -40:] = False
        sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
        idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
        knn = torch.gather(points, 1, idx.reshape(2, -1, 1).expand(-1, -1, 3)).reshape(
            2, n, 3, 3)
        w = [((torch.rand(s, generator=g) * 2 - 1) * cc ** -0.5).to(dev)
             for s in ((cc, cc), (cc,), (cc, cc), (cc,))]
        tag = "bf16" if dtype == torch.bfloat16 else "float32"
        cases.append((f"K3 N={n} C={cc} {tag}",
                      lambda p=points, k=knn, w=w, dt=dtype: embedding.geometric_embedding(
                          p, k, *w, 0.2, 15.0, out_dtype=dt)))
        rnd = lambda *s: torch.randn(s, generator=g).to(dev, dtype)  # noqa: E731
        emb = rnd(2, n, n, cc)
        pts = rpe_attention.point_rows(points)
        for ah, with_sh in ((24, True), (4, False)):
            q, k, v = rnd(2, ah, n, hc), rnd(2, ah, n, hc), rnd(2, ah, n, hc)
            qp = rnd(2, n, ah, cc) * cc ** -0.5
            qw = (torch.randn((2, 3, ah, n), generator=g) * 0.3).to(dev) if with_sh else None
            sh = "SH" if with_sh else "no SH"
            args = (q, k, v, qp, emb, masks, qw, pts if with_sh else None)
            cases.append((f"K5 AH={ah} {sh} N={n} C={cc} {tag}",
                           lambda a=args, hc=hc: rpe_attention.rpe_self_attention_with_lse(
                               *a, scale=hc ** -0.5)))
            femb = (q, k, v, qp, masks, qw, pts, knn, w[0], w[2])
            cases.append((f"K16 AH={ah} {sh} N={n} C={cc} {tag}",
                          lambda a=femb, hc=hc: rpe_attention.rpe_self_attention_femb(
                              *a, scale=hc ** -0.5, sigma_d=0.2, sigma_a=15.0)))
    bf = torch.bfloat16
    for name, nq, ns, h, ac, ac2 in (("K12 stage 0", 20000, 20000, 24, 192, 0),
                                     ("K12 stage 1", 10000, 10000, 32, 384, 0),
                                     ("K13 s0 -> s1", 10000, 20000, 24, 192, 768)):
        nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, dev) for _ in range(2)])
        x = torch.randn((2, ns, ac), generator=g).to(dev, bf)
        infl = (torch.rand((2, nq, h, 15), generator=g).to(dev) * (nbr < ns)[..., None]).to(bf)
        rhs = (torch.randn((ac, 15 * ac), generator=g) * (15 * ac) ** -0.5).to(dev, bf).t()
        if ac2:
            x2 = torch.randn((2, ns, ac2), generator=g).to(dev, bf)
            cases.append((name, lambda a=(x, nbr, infl, x2, rhs): wc.gather_wf_max_mm(*a)))
        else:
            cases.append((name, lambda a=(x, nbr, infl, rhs): wc.gather_wf_mm(*a)))
    return cases


def _worker(tree: str, out: str, save: bool) -> None:
    """One run in checkout ``tree``: the outputs (saved when ``save``) and
    the ms of the ``TIMED`` cases."""
    sys.path[0] = tree  # in place of this script's directory
    from se3et_tpu_torch.ops.kernels import _build, selfcheck

    _build.build()
    cases = dict(_cases(torch.device("cuda", 0)))
    outs = {}
    with torch.no_grad():
        for name, fn in cases.items():
            got = fn()
            outs[name] = [t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
        torch.cuda.synchronize()
        ms = {name: selfcheck._time_ms(cases[name], REPS) for name in TIMED}
    if save:
        torch.save(outs, out + ".pt")
    with open(out + ".json", "w") as f:
        json.dump(ms, f)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="root of the other checkout")
    parser.add_argument("--worker", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    parser.add_argument("--save", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bit_identity: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        _worker(*args.worker, args.save)
        return 0
    if not args.other:
        parser.error("--other is required")
    mine = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    other = os.path.abspath(args.other)
    work = os.path.join(mine, "se3et_tpu_torch", "_build", "before_after")
    os.makedirs(work, exist_ok=True)
    turns = [("other", other), ("this", mine), ("this", mine), ("other", other)]
    times = {"this": [], "other": []}
    for i, (who, tree) in enumerate(turns):
        out = os.path.join(work, f"turn{i}")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree, out] + (
            ["--save"] if i < 2 else [])
        subprocess.run(cmd, check=True, cwd=tree)
        with open(out + ".json") as f:
            times[who].append(json.load(f))
    theirs = torch.load(os.path.join(work, "turn0.pt"))
    ours = torch.load(os.path.join(work, "turn1.pt"))
    bad = 0
    for name, a in ours.items():
        b = theirs[name]
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x.float() - y.float()).abs().max()) / max(
            float(y.float().abs().max()), 1e-30) for x, y in zip(a, b))
        if name in TOLERANCES:
            ok = diff <= TOLERANCES[name]
            verdict = (f"{'within' if ok else 'OUTSIDE'} {TOLERANCES[name]} of the other's scale "
                       f"(max |diff| / max |other| {diff:.3e}; bit-identical {same})")
        else:
            ok = same
            verdict = "bit-identical" if same else f"DIFFERS (max |diff| / max |other| {diff:.3e})"
        print(f"{name}: {verdict}", flush=True)
        bad += not ok
    for name in TIMED:
        print(f"{name} ms in turns (other, this, this, other): "
              f"other {[round(t[name], 4) for t in times['other']]} (median "
              f"{statistics.median(t[name] for t in times['other']):.4f}), this "
              f"{[round(t[name], 4) for t in times['this']]} (median "
              f"{statistics.median(t[name] for t in times['this']):.4f})", flush=True)
    print(_card())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
