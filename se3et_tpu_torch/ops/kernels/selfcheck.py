r"""Kernel-versus-plain checks and timings on the card.

Each check calls one kernel wrapper and its plain PyTorch version on the
same CUDA tensors, reports the largest absolute difference against the
stated tolerance, and times both with CUDA events.  Used by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.ops.kernels import embedding, sinkhorn, windowed_conv

SOURCES = {
    "gather_wf": ("se3et_tpu_torch/csrc/gather_wf.cu",
                  "se3et_tpu/ops/pallas/windowed_conv.py:893"),
    "neighbor_max": ("se3et_tpu_torch/csrc/neighbor_max.cu",
                     "se3et_tpu/ops/pallas/windowed_conv.py:840"),
    "geometric_embedding": ("se3et_tpu_torch/csrc/geometric_embedding.cu",
                            "se3et_tpu/ops/pallas/embedding.py:416"),
    "sinkhorn": ("se3et_tpu_torch/csrc/sinkhorn.cu",
                 "se3et_tpu/ops/pallas/sinkhorn.py:72"),
}
WRAPPERS = {
    "gather_wf": windowed_conv.gather_wf,
    "neighbor_max": windowed_conv.neighbor_max,
    "geometric_embedding": embedding.geometric_embedding,
    "sinkhorn": sinkhorn.sinkhorn,
}


@dataclasses.dataclass
class CheckResult:
    name: str
    shape: str
    max_abs_err: float
    tol: float
    ms: float
    plain_ms: float

    @property
    def ok(self) -> bool:
        return self.max_abs_err <= self.tol


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name, shape, kernel_fn, plain_fn, tol_fn, reps, mask=None):
    with prec.compute_dtype_scope("float32"):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if mask is not None:
            diff = diff[mask]
        err = float(diff.max())
        tol = tol_fn(want)
        ms = _time_ms(kernel_fn, reps)
        plain_ms = _time_ms(plain_fn, reps)
    return CheckResult(name, shape, err, tol, ms, plain_ms)


def local_neighbors(nq, ns, h, generator, device, spread=64):
    """(1, nq, h) int32 neighbour rows near the query's own index (Morton-like
    locality), about a quarter of them sentinels (== ns)."""
    q = torch.arange(nq, device=device)[:, None] * ns // nq
    off = torch.randint(-spread, spread, (nq, h), generator=generator).to(device)
    nbr = (q + off).clamp(0, ns - 1)
    drop = torch.rand((nq, h), generator=generator).to(device) < 0.25
    return torch.where(drop, torch.full_like(nbr, ns), nbr).to(torch.int32)[None]


def check_gather_wf(nbr, ns, ac, k=15, dtype=torch.bfloat16, seed=0, reps=10):
    """K1 on x (B, ns, ac) with the given (B, Nq, H) neighbours; bf16 tolerance
    1e-2 * max|out| (fp32 sums in a different order, one bf16 rounding)."""
    g = torch.Generator().manual_seed(seed)
    dev = nbr.device
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(dev, dtype)
    infl = (torch.rand((b, nq, h, k), generator=g).to(dev)
            * (nbr < ns)[..., None]).to(dtype)
    tol = (lambda w: 1e-2 * float(w.float().abs().max())) if dtype == torch.bfloat16 \
        else (lambda w: 1e-5 * float(w.abs().max()))
    return _compare(
        "gather_wf", f"x{tuple(x.shape)} nbr{tuple(nbr.shape)} K={k} {dtype}",
        lambda: windowed_conv.gather_wf(x, nbr, infl),
        lambda: windowed_conv.gather_wf_plain(x, nbr, infl), tol, reps)


def check_neighbor_max(nbr, ns, ac, dtype=torch.bfloat16, seed=1, reps=10):
    """K2; exact (tolerance 0)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nbr.shape[0], ns, ac), generator=g).to(nbr.device, dtype)
    return _compare(
        "neighbor_max", f"x{tuple(x.shape)} nbr{tuple(nbr.shape)} {dtype}",
        lambda: windowed_conv.neighbor_max(x, nbr),
        lambda: windowed_conv.neighbor_max_plain(x, nbr), lambda w: 0.0, reps)


def check_embedding(points, masks, c=256, k=3, sigma_d=0.2, sigma_a=15.0,
                    out_dtype=torch.bfloat16, seed=2, reps=3):
    """K3 on (B, N, 3) points (k nearest valid neighbours, self excluded);
    tolerance on valid rows and columns 1e-2 * max|emb| in bf16 (one
    rounding) and 1e-3 * max|emb| in float32 (FMA order in the near-zero
    distances of self-pairs moves the Chebyshev argument)."""
    g = torch.Generator().manual_seed(seed)
    dev = points.device
    b, n, _ = points.shape
    bound = 1.0 / math.sqrt(c)
    wd, wa = ((torch.rand((c, c), generator=g) * 2 - 1) * bound for _ in range(2))
    bd, ba = ((torch.rand((c,), generator=g) * 2 - 1) * bound for _ in range(2))
    wd, wa, bd, ba = (t.to(dev) for t in (wd, wa, bd, ba))
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, k + 1, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(
        b, n, k, 3)
    valid = masks[:, :, None] & masks[:, None, :]
    return _compare(
        "geometric_embedding", f"points{tuple(points.shape)} C={c} {out_dtype}",
        lambda: embedding.geometric_embedding(points, knn, wd, bd, wa, ba, sigma_d,
                                              sigma_a, out_dtype=out_dtype),
        lambda: embedding.geometric_embedding_plain(points, knn, wd, bd, wa, ba,
                                                    sigma_d, sigma_a,
                                                    out_dtype=out_dtype),
        lambda w: (1e-2 if out_dtype == torch.bfloat16 else 1e-3)
        * float(w.float()[valid].abs().max()), reps, mask=valid)


def sinkhorn_inputs(b, m, n, device, seed=3):
    """(padded scores, log_mu, log_nu, valid) as LearnableLogOptimalTransport
    builds them, with masked rows and columns, one patch with every row
    masked and one with every column masked."""
    rng = np.random.RandomState(seed)
    rows = rng.rand(b, m - 1) > 0.2
    cols = rng.rand(b, n - 1) > 0.2
    rows[0] = False
    cols[1] = False
    rv = np.concatenate([rows, np.ones((b, 1), bool)], 1)
    cv = np.concatenate([cols, np.ones((b, 1), bool)], 1)
    valid = rv[:, :, None] & cv[:, None, :]
    padded = rng.normal(size=(b, m, n)) * 2.0
    padded[:, -1, :] = padded[:, :, -1] = 1.0
    nr, nc = rows.sum(1), cols.sum(1)
    norm = -np.log(nr + nc + 1e-9)
    mu = np.concatenate([np.repeat(norm[:, None], m - 1, 1),
                         (np.log(nc + 1e-9) + norm)[:, None]], 1)
    nu = np.concatenate([np.repeat(norm[:, None], n - 1, 1),
                         (np.log(nr + 1e-9) + norm)[:, None]], 1)
    out = [np.where(valid, padded, -1e12), np.where(rv, mu, -1e12),
           np.where(cv, nu, -1e12), valid]
    return [torch.from_numpy(np.asarray(a, np.float32 if a.dtype != bool else bool))
            .to(device) for a in out]


def check_sinkhorn(b=256, m=65, n=65, iters=100, device="cuda", reps=5):
    """K4 in float32; tolerance 1e-4 absolute on valid entries."""
    padded, mu, nu, valid = sinkhorn_inputs(b, m, n, device)
    return _compare(
        "sinkhorn", f"scores({b}, {m}, {n}) iters={iters} float32",
        lambda: sinkhorn.sinkhorn(padded, mu, nu, iters),
        lambda: sinkhorn.sinkhorn_plain(padded, mu, nu, iters),
        lambda w: 1e-4, reps, mask=valid)
