"""Hold K3 (geometric embedding) and K5 (flash RPE self-attention) built
from this checkout's sources against the same kernels built from another
checkout's, bit for bit, on the card.

    python -m se3et_tpu_torch.ops.kernels.bit_identity --other <another checkout>

Both builds run through the port's own wrappers on the same inputs (the
serving shapes of se3ete.3dmatch and the tiny float32 widths): first with
this checkout's libraries, then with the other checkout's ``csrc`` compiled
with the same flags into its own ``se3et_tpu_torch/_build``.  Prints one
line per case and exits non-zero if any output differs in any bit.
"""

import argparse
import os
import sys

import torch

from se3et_tpu_torch.ops.kernels import _build, embedding, rpe_attention


def _cases(dev):
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
        cases.append((f"K3 points{tuple(points.shape)} C={cc} {dtype}",
                      lambda p=points, k=knn, w=w, dt=dtype: embedding.geometric_embedding(
                          p, k, *w, 0.2, 15.0, out_dtype=dt)))
        emb = embedding.geometric_embedding(points, knn, *w, 0.2, 15.0, out_dtype=dtype)
        for ah, with_sh in ((24, True), (4, False)):
            rnd = lambda *s: torch.randn(s, generator=g).to(dev, dtype)  # noqa: E731
            q, k, v = rnd(2, ah, n, hc), rnd(2, ah, n, hc), rnd(2, ah, n, hc)
            qp = rnd(2, n, ah, cc) * cc ** -0.5
            qw = (torch.randn((2, 3, ah, n), generator=g) * 0.3).to(dev) if with_sh else None
            pts = rpe_attention.point_rows(points) if with_sh else None
            args = (q, k, v, qp, emb, masks, qw, pts)
            cases.append((f"K5 AH={ah} {'SH' if with_sh else 'no SH'} N={n} C={cc} {dtype}",
                           lambda a=args, hc=hc: rpe_attention.rpe_self_attention_with_lse(
                               *a, scale=hc ** -0.5)))
    return cases


def _run(cases):
    outs = []
    with torch.no_grad():
        for _, fn in cases:
            out = fn()
            outs.append(out if isinstance(out, tuple) else (out,))
    torch.cuda.synchronize()
    return outs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bit_identity: no CUDA device", file=sys.stderr)
        return 1
    cases = _cases(torch.device("cuda", 0))
    mine = _run(cases)
    _build.CSRC_DIR = os.path.join(os.path.abspath(args.other), "se3et_tpu_torch", "csrc")
    _build.BUILD_DIR = os.path.join(os.path.abspath(args.other), "se3et_tpu_torch", "_build")
    _build._library.cache_clear()
    _build.function.cache_clear()
    theirs = _run(cases)
    bad = 0
    for (name, _), a, b in zip(cases, mine, theirs):
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
        print(f"{name}: {'bit-identical' if same else f'DIFFERS (max |diff| {diff:.3e})'}")
        bad += not same
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
