r"""Kernel-versus-plain checks and timings on the card.

Each check calls one kernel wrapper and its plain PyTorch version on the
same CUDA tensors, reports the largest absolute difference against the
stated tolerance, and times both with CUDA events, plus, where one
PyTorch call computes the same function, that call (``library_ms``, a
yardstick the port never calls).  Each result carries the kernel's bound:
the larger of the bytes it must move (each input read once, each output
written once) over the card's memory rate and its operations over the
peak rate for the inputs' type (:data:`PEAK`).  Used by ``chip_smoke.py``
and ``tests/test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import math

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.ops.kernels import (
    embedding, eq_attention, rpe_attention, sinkhorn, windowed_conv,
)

SOURCES = {
    "gather_wf": ("se3et_tpu_torch/csrc/gather_wf.cu",
                  "se3et_tpu/ops/pallas/windowed_conv.py:893"),
    "neighbor_max": ("se3et_tpu_torch/csrc/neighbor_max.cu",
                     "se3et_tpu/ops/pallas/windowed_conv.py:840"),
    "geometric_embedding": ("se3et_tpu_torch/csrc/geometric_embedding.cu",
                            "se3et_tpu/ops/pallas/embedding.py:416"),
    "sinkhorn": ("se3et_tpu_torch/csrc/sinkhorn.cu",
                 "se3et_tpu/ops/pallas/sinkhorn.py:72"),
    "rpe_self_attention": ("se3et_tpu_torch/csrc/rpe_attention.cu",
                           "se3et_tpu/ops/pallas/rpe_attention.py:265"),
    "eq_attention_stats": ("se3et_tpu_torch/csrc/eq_attention.cu",
                           "se3et_tpu/ops/pallas/eq_attention.py:155"),
    "eq_attention_apply": ("se3et_tpu_torch/csrc/eq_attention.cu",
                           "se3et_tpu/ops/pallas/eq_attention.py:233"),
    "gather_wf_bwd": ("se3et_tpu_torch/csrc/gather_wf_bwd.cu",
                      "se3et_tpu/ops/pallas/windowed_conv.py:469"),
    "neighbor_max_bwd": ("se3et_tpu_torch/csrc/neighbor_max_bwd.cu",
                         "se3et_tpu/ops/pallas/windowed_conv.py:758"),
    "geometric_embedding_bwd": ("se3et_tpu_torch/csrc/geometric_embedding.cu",
                                "se3et_tpu/ops/pallas/embedding.py:336"),
    "rpe_attention_bwd": ("se3et_tpu_torch/csrc/rpe_attention_bwd.cu",
                          "se3et_tpu/ops/pallas/rpe_attention.py:617"),
    "gather_wf_mm": ("se3et_tpu_torch/csrc/gather_wf_mm.cu",
                     "se3et_tpu/ops/pallas/windowed_conv.py:994"),
    "gather_wf_max_mm": ("se3et_tpu_torch/csrc/gather_wf_mm.cu",
                         "se3et_tpu/ops/pallas/windowed_conv.py:1229"),
    "gather_wf_max": ("se3et_tpu_torch/csrc/gather_wf_max.cu",
                      "se3et_tpu/ops/pallas/windowed_conv.py:1352"),
    "influence": ("se3et_tpu_torch/csrc/influence.cu",
                  "se3et_tpu/ops/pallas/windowed_conv.py:202"),
    "rpe_self_attention_femb": ("se3et_tpu_torch/csrc/rpe_attention_femb.cu",
                                "se3et_tpu/ops/pallas/rpe_attention.py:495"),
}
WRAPPERS = {
    "gather_wf": windowed_conv.gather_wf,
    "neighbor_max": windowed_conv.neighbor_max,
    "geometric_embedding": embedding.geometric_embedding,
    "sinkhorn": sinkhorn.sinkhorn,
    "rpe_self_attention": rpe_attention.rpe_self_attention,
    "eq_attention_stats": eq_attention.eq_attention_stats,
    "eq_attention_apply": eq_attention.eq_attention_apply,
    "gather_wf_bwd": windowed_conv.gather_wf_bwd,
    "neighbor_max_bwd": windowed_conv.neighbor_max_bwd,
    "geometric_embedding_bwd": embedding.geometric_embedding_bwd,
    "rpe_attention_bwd": rpe_attention.rpe_attention_bwd,
    "gather_wf_mm": windowed_conv.gather_wf_mm,
    "gather_wf_max_mm": windowed_conv.gather_wf_max_mm,
    "gather_wf_max": windowed_conv.gather_wf_max,
    "influence": windowed_conv.influence,
    "rpe_self_attention_femb": rpe_attention.rpe_self_attention_femb,
}
SERVING = ("gather_wf", "neighbor_max", "geometric_embedding", "sinkhorn",
           "rpe_self_attention", "eq_attention_stats", "eq_attention_apply",
           "gather_wf_mm", "gather_wf_max_mm", "gather_wf_max")
TRAINING = ("gather_wf_bwd", "neighbor_max_bwd", "geometric_embedding_bwd",
            "rpe_attention_bwd")
# kernels of the routes off the default one: device influence (pyramids
# without host weights) and the in-attention fused embedding (serve_femb)
ROUTES = ("influence", "rpe_self_attention_femb")

# NVIDIA H100 SXM data-sheet peaks (dense): memory bytes/s, and operations/s
# by input type (bf16 on the tensor cores, float32 outside them)
MEMORY_RATE = 3.35e12
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
# exponentials/s: the special-function units return 16 exp2 results per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
EXP_RATE = 132 * 16 * 1.98e9


@dataclasses.dataclass
class CheckResult:
    name: str
    shape: str
    max_abs_err: float
    tol: float
    ms: float
    plain_ms: float
    bound_ms: float = float("nan")
    bound_by: str = ""
    library_ms: Optional[float] = None
    launches: int = 0  # on the main path, filled in by the caller
    route_ms: Optional[float] = None  # the unfused route's time (K12-K14), a yardstick
    device_ms: Optional[float] = None  # the kernel's own device time per call (profiler)
    two_calls_ms: Optional[float] = None  # two PyTorch calls computing the function (K7)
    first_ms: Optional[float] = None  # the first design on the same inputs (K1, K2, K5-K7,
    # K8-K11, K14, K15)
    # every device kernel of one wrapper call (K11: its products too), and
    # the first design's kernel, per call (profiler)
    call_device_ms: Optional[float] = None
    first_device_ms: Optional[float] = None
    # K1, K8, K9 and K15: the form its shape took, whether its output equals
    # its first design's and its own on a second call bit for bit; K8 and K9:
    # distinct (tile, query) pairs over B * Nq
    form: Optional[str] = None
    bitwise: Optional[bool] = None
    reread: Optional[float] = None
    # K15, K5-K7 and K16: per call replayed from a CUDA graph
    # (selfcheck.replay_ms), the form and (K5-K7, K15) its first design
    replay_ms: Optional[float] = None
    first_replay_ms: Optional[float] = None
    route_replay_ms: Optional[float] = None  # K12's unfused route replayed
    # K8's tiles form on the card: its tile plan's build from the reverse
    # index (ms by events) and whether it equals the plain version's
    plan_ms: Optional[float] = None
    plan_ok: Optional[bool] = None

    @property
    def ok(self) -> bool:
        return self.max_abs_err <= self.tol and self.plan_ok is not False


def bound(nbytes: float, ops: float, dtype, exps: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes", "operations" or "exps") for ``nbytes`` moved,
    ``ops`` operations on inputs of ``dtype`` and ``exps`` exponentials."""
    times = {"bytes": nbytes / MEMORY_RATE * 1e3, "operations": ops / PEAK[dtype] * 1e3,
             "exps": exps / EXP_RATE * 1e3}
    kind = max(times, key=times.get)
    return times[kind], kind


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _with_bound(res: CheckResult, nbytes, ops, dtype, library=None, reps=3,
                exps=0.0) -> CheckResult:
    res.bound_ms, res.bound_by = bound(nbytes, ops, dtype, exps)
    if library is not None:
        res.library_ms = _time_ms(library, reps)
    return res


def _bag_inputs(x, nbr):
    """x (B, Ns, AC) as one (B*(Ns+1), AC) table with a zero row per cloud
    for the sentinel, and nbr (B, Nq, H) as int64 rows of that table."""
    b, ns, ac = x.shape
    table = torch.cat([x, x.new_zeros(b, 1, ac)], dim=1).reshape(b * (ns + 1), ac)
    offs = torch.arange(b, device=x.device)[:, None, None] * (ns + 1)
    return table, nbr.long() + offs


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


def replay_ms(fn, reps: int = 20) -> float:
    """Time per call of ``fn`` replayed from a CUDA graph of ``reps`` calls:
    device time with the graph's launch gaps, no host time and no profiler
    (whose later sessions in a process lose kernels).  The smallest of
    three timed replays, after a warm-up call and one replay."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return min(times)


def device_ms(fn, kernel: str, reps: int = 10) -> Optional[float]:
    """Device time per call of the kernels whose name holds ``kernel`` ("":
    every device kernel of the call), from
    ``torch.profiler`` over ``reps`` calls of ``fn`` (after one warm-up);
    a profile that lists none is taken once more, and None is returned
    where neither lists the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        if events:
            break
    else:
        return None
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    return sum(getattr(e, attr) for e in events) / 1e3 / reps


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


def check_gather_wf(nbr, ns, ac, k=15, dtype=torch.bfloat16, seed=0, reps=10,
                    device_kernel=None, first=False):
    """K1 on x (B, ns, ac) with the given (B, Nq, H) neighbours, on the form
    ``windowed_conv.gather_wf_form`` names; bf16 tolerance 1e-2 * max|out|
    (fp32 sums in a different order, one bf16 rounding), float32 1e-5 *
    max|out|.  With ``device_kernel`` (a kernel name) also that kernel's
    device time per call; with ``first`` the first design's time on the
    same inputs (events, and its kernel's device time where
    ``device_kernel`` is given) and ``bitwise``: the output equals the
    first design's and a second call of its own bit for bit."""
    g = torch.Generator().manual_seed(seed)
    dev = nbr.device
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(dev, dtype)
    infl = (torch.rand((b, nq, h, k), generator=g).to(dev)
            * (nbr < ns)[..., None]).to(dtype)
    tol = (lambda w: 1e-2 * float(w.float().abs().max())) if dtype == torch.bfloat16 \
        else (lambda w: 1e-5 * float(w.abs().max()))
    form = windowed_conv.gather_wf_form(h, dtype, k, ac)
    kernel_fn = lambda: windowed_conv.gather_wf(x, nbr, infl)  # noqa: E731
    res = _compare(
        "gather_wf", f"x{tuple(x.shape)} nbr{tuple(nbr.shape)} K={k} {dtype} ({form} form)",
        kernel_fn, lambda: windowed_conv.gather_wf_plain(x, nbr, infl), tol, reps)
    res.form = form
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
    if first:
        first_fn = lambda: windowed_conv._gather_wf_forward(x, nbr, infl,  # noqa: E731
                                                            form="first")
        got = kernel_fn()
        res.bitwise = bool(torch.equal(_bits(got), _bits(first_fn()))
                           and torch.equal(_bits(got), _bits(kernel_fn())))
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "gather_wf_kernel")
    # library: one embedding_bag sum per (query, kernel point) over its
    # neighbours, weighted by the influence
    table, idx = _bag_inputs(x, nbr)
    idx_k = idx[:, :, None, :].expand(b, nq, k, h).reshape(-1, h)
    w_k = infl.permute(0, 1, 3, 2).reshape(-1, h).contiguous()
    nvalid = int((nbr < ns).sum())
    out_bytes = b * nq * k * ac * x.element_size()
    return _with_bound(res, _nbytes(x, nbr, infl) + out_bytes, 2.0 * nvalid * k * ac, dtype,
                       lambda: F.embedding_bag(idx_k, table, per_sample_weights=w_k,
                                               mode="sum"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a 2- or 4-byte tensor (-0.0 apart from +0.0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_neighbor_max(nbr, ns, ac, dtype=torch.bfloat16, seed=1, reps=10,
                       device_kernel=None, first=False):
    """K2 on the form ``neighbor_max_form`` names; exact (tolerance 0).
    With ``device_kernel`` (a kernel name) also that kernel's device time
    per call; with ``first`` also the time of the first design on the same
    inputs (``first_ms``)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nbr.shape[0], ns, ac), generator=g).to(nbr.device, dtype)
    kern = lambda: windowed_conv.neighbor_max(x, nbr)  # noqa: E731
    res = _compare(
        "neighbor_max", f"x{tuple(x.shape)} nbr{tuple(nbr.shape)} {dtype} "
        f"({windowed_conv.neighbor_max_form(ac, dtype)} form)",
        kern, lambda: windowed_conv.neighbor_max_plain(x, nbr), lambda w: 0.0, reps)
    if device_kernel is not None:
        res.device_ms = device_ms(kern, device_kernel)
    if first:
        res.first_ms = _time_ms(lambda: windowed_conv._neighbor_max_forward(x, nbr, "first"),
                                reps)
    # library: embedding_bag max over the neighbour rows, sentinels reading
    # the zero row (the plain version's max includes 0 where a row has one)
    table, idx = _bag_inputs(x, nbr)
    idx2 = idx.reshape(-1, nbr.shape[2])
    b, nq, h = nbr.shape
    nvalid = int((nbr < x.shape[1]).sum())
    return _with_bound(res, _nbytes(x, nbr) + b * nq * x.shape[2] * x.element_size(),
                       float(nvalid * x.shape[2]), dtype,
                       lambda: F.embedding_bag(idx2, table, mode="max"))


def check_embedding(points, masks, c=256, k=3, sigma_d=0.2, sigma_a=15.0,
                    out_dtype=torch.bfloat16, seed=2, reps=3):
    """K3 on (B, N, 3) points (k nearest valid neighbours, self excluded);
    tolerance on valid rows and columns 1e-3 * max|emb| in float32 (FMA
    order in the near-zero distances of self-pairs moves the Chebyshev
    argument) and, in bf16, that plus one bf16 ulp at max|emb|: the kernel
    and the plain version round the same bases, G and rows, and their float32
    sums differ only in order, so a row lands at most an ulp apart."""
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
    res = _compare(
        "geometric_embedding", f"points{tuple(points.shape)} C={c} {out_dtype}",
        lambda: embedding.geometric_embedding(points, knn, wd, bd, wa, ba, sigma_d,
                                              sigma_a, out_dtype=out_dtype),
        lambda: embedding.geometric_embedding_plain(points, knn, wd, bd, wa, ba,
                                                    sigma_d, sigma_a,
                                                    out_dtype=out_dtype),
        lambda w: _emb_tol(float(w.float()[valid].abs().max()), out_dtype), reps, mask=valid)
    # Chebyshev basis terms per output element: deg_d + k * deg_a, one FMA
    # (2 operations) per term and channel
    deg_d, deg_a, _, _ = embedding._folded_projections(wd, wa, sigma_a)
    out_bytes = b * n * n * c * torch.empty((), dtype=out_dtype).element_size()
    ops = 2.0 * b * n * n * c * (deg_d + k * deg_a)
    return _with_bound(res, _nbytes(points, knn, wd, bd, wa, ba) + out_bytes, ops, out_dtype)


def _emb_tol(scale: float, dtype) -> float:
    """K3's tolerance at output scale ``scale`` (see :func:`check_embedding`)."""
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7) if dtype == torch.bfloat16 else 0.0
    return 1e-3 * scale + ulp


def sinkhorn_inputs(b, m, n, device, seed=3, *, single_entry=False, peak=None):
    """(padded scores, log_mu, log_nu, valid) as LearnableLogOptimalTransport
    builds them, with masked rows and columns, one patch with every row
    masked and one with every column masked.  With ``single_entry`` patch 2
    keeps one valid entry (row 0, column 0; the dustbins masked too); with
    ``peak`` the scores are scaled so the largest magnitude is ``peak`` (the
    seed-0 weights give ``entry()``'s pair valid scores up to ~176)."""
    rng = np.random.RandomState(seed)
    rows = rng.rand(b, m - 1) > 0.2
    cols = rng.rand(b, n - 1) > 0.2
    rows[0] = False
    cols[1] = False
    rv = np.concatenate([rows, np.ones((b, 1), bool)], 1)
    cv = np.concatenate([cols, np.ones((b, 1), bool)], 1)
    if single_entry:
        rv[2] = np.arange(m) == 0
        cv[2] = np.arange(n) == 0
    valid = rv[:, :, None] & cv[:, None, :]
    padded = rng.normal(size=(b, m, n)) * 2.0
    padded[:, -1, :] = padded[:, :, -1] = 1.0
    if peak is not None:
        padded *= peak / np.abs(padded).max()
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


def check_sinkhorn(b=256, m=65, n=65, iters=100, device="cuda", reps=5, device_kernel=None,
                   form=None, **inputs):
    """K4 in float32 on :func:`sinkhorn_inputs` (``inputs`` passed on), on
    the form :func:`sinkhorn.sinkhorn_form` names or on ``form``; tolerance
    1e-4 absolute on valid entries, and the output finite wherever the
    plain version's is (an error of inf otherwise).  With ``device_kernel``
    (a kernel name) also the device time of that kernel per call."""
    padded, mu, nu, valid = sinkhorn_inputs(b, m, n, device, **inputs)
    kern = lambda: sinkhorn._sinkhorn_forward(padded, mu, nu, iters, form)  # noqa: E731
    plain = lambda: sinkhorn.sinkhorn_plain(padded, mu, nu, iters)  # noqa: E731
    res = _compare(
        "sinkhorn", f"scores({b}, {m}, {n}) iters={iters} float32 form "
        f"{form or sinkhorn.sinkhorn_form(m, n)}", kern, plain, lambda w: 1e-4, reps,
        mask=valid)
    got, want = kern(), plain()
    if bool((torch.isfinite(want) & ~torch.isfinite(got)).any()):
        res.max_abs_err = float("inf")
    if device_kernel is not None:
        res.device_ms = device_ms(kern, device_kernel)
    # per iteration a row and a column multiply-reduce over every entry
    return _with_bound(res, 2 * _nbytes(padded) + _nbytes(mu, nu),
                       4.0 * iters * b * m * n, torch.float32)


def check_rpe_attention(points, masks, ah, c=64, cc=256, with_sh=True,
                        dtype=torch.bfloat16, seed=4, reps=3, device_kernel=None,
                        replay=False, first=False):
    """K5 on the coarse points (B, N, 3) and key masks (B, N): random q, k,
    v (B, AH, N, c), qp (B, N, AH, C), emb (B, N, N, C) in ``dtype`` and,
    with ``with_sh``, qw (B, 3, AH, N).  Tolerance on valid query rows
    1e-2 * max|out| in bf16 (p rounded to bf16 at other running maxima,
    float32 sums in another order) and 1e-4 * max|out| in float32.  With
    ``device_kernel``, also that kernel's device time per call; with
    ``replay``, the call's time replayed from a CUDA graph
    (:func:`replay_ms`); with ``first``, the first design's
    (``_rpe_forward(..., form="cuda")``, the CUDA-core kernel) time on the
    same inputs by events, replayed (with ``replay``) and as its kernel's
    device time (with ``device_kernel``)."""
    g = torch.Generator().manual_seed(seed)
    dev = points.device
    b, n, _ = points.shape
    rnd = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev, dtype)  # noqa: E731
    q, k, v = rnd(b, ah, n, c), rnd(b, ah, n, c), rnd(b, ah, n, c)
    qp = rnd(b, n, ah, cc, sc=cc ** -0.5)
    emb = rnd(b, n, n, cc)
    qw = (torch.randn((b, 3, ah, n), generator=g) * 0.3).to(dev) if with_sh else None
    pts = rpe_attention.point_rows(points) if with_sh else None
    scale = 1.0 / math.sqrt(c)
    rows = masks[:, None, :, None].expand(b, ah, n, c)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    kernel_fn = lambda: rpe_attention.rpe_self_attention(  # noqa: E731
        q, k, v, qp, emb, masks, qw, pts, scale=scale)
    res = _compare(
        "rpe_self_attention",
        f"q(B={b}, AH={ah}, N={n}, c={c}) emb C={cc} {'with' if with_sh else 'no'} SH {dtype}",
        kernel_fn,
        lambda: rpe_attention.rpe_self_attention_plain(q, k, v, qp, emb, masks, qw, pts,
                                                       scale=scale),
        lambda w: tol * float(w[rows].abs().max()), reps, mask=rows)
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
    if replay:
        res.replay_ms = replay_ms(kernel_fn)
    if first:
        first_fn = lambda: rpe_attention._rpe_forward(  # noqa: E731
            q, k, v, qp, emb, masks, qw, pts, scale, False, form="cuda")
        res.first_ms = _time_ms(first_fn, reps)
        if replay:
            res.first_replay_ms = replay_ms(first_fn)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "rpe_attention_kernel")
    nkeys = int(masks.sum())  # valid keys of the B clouds
    ops = 2.0 * ah * n * nkeys * (2 * c + cc) + (8.0 * ah * n * nkeys if with_sh else 0.0)
    nbytes = _nbytes(q, k, v, qp, emb, masks) + b * ah * n * c * 4
    if with_sh:
        nbytes += _nbytes(qw, pts)
    # one exp per score with a valid key
    return _with_bound(res, nbytes, ops, dtype, exps=float(ah * n * nkeys))


def _eq_inputs(q_masks, k_masks, a, h, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    dev = q_masks.device
    n, m = q_masks.shape[0], k_masks.shape[0]
    q = torch.randn((a, h, n, c), generator=g).to(dev, dtype)
    k = torch.randn((a, h, m, c), generator=g).to(dev, dtype)
    v = torch.randn((a, h, m, c), generator=g).to(dev, dtype)
    sup_q = (torch.rand((a, h), generator=g) + 0.5).to(dev)
    sup_k = (torch.rand((a, h), generator=g) + 0.5).to(dev)
    return q, k, v, sup_q, sup_k


def check_eq_stats(q_masks, k_masks, a=6, h=4, c=64, with_sup=False, positive="sq",
                   dtype=torch.bfloat16, seed=5, reps=3, device_kernel=None, replay=False,
                   first=False):
    """K6 on random q (A, H, N, c), k (A, H, M, c) with the given masks and
    ``positive`` mode.  The error reported is the largest over the outputs
    (row max, row sum, attn_ae[, sup]) of max|got - want| / max|want|,
    tolerance 1e-3: float32 sums in another order, the row sum accumulated
    online in base 2 (ex2.approx in the bf16 form).  With ``device_kernel``
    (a kernel name) also the device time of that kernel per call; with
    ``replay``, the call's time replayed from a CUDA graph
    (:func:`replay_ms`); with ``first``, the first design's
    (``_eq_attention_stats(..., form="cuda")``, the CUDA-core kernel) time
    on the same inputs by events, replayed (with ``replay``) and as its
    kernel's device time (with ``device_kernel``)."""
    q, k, _, sup_q, sup_k = _eq_inputs(q_masks, k_masks, a, h, c, dtype, seed)
    sq, sk = (sup_q, sup_k) if with_sup else (None, None)
    kern = lambda: eq_attention.eq_attention_stats(  # noqa: E731
        q, k, q_masks, k_masks, sq, sk, positive=positive)
    plain = lambda: eq_attention.eq_attention_stats_plain(  # noqa: E731
        q, k, q_masks, k_masks, sq, sk, positive=positive)
    with prec.compute_dtype_scope("float32"):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max(float((g_ - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                  for g_, w_ in zip(got, want))
        res = CheckResult(
            "eq_attention_stats",
            f"q(A={a}, H={h}, N={q.shape[2]}, c={c}) M={k.shape[2]} positive={positive} "
            f"{'with' if with_sup else 'no'} sup {dtype} (error relative to output scale)",
            err, 1e-3, _time_ms(kern, reps), _time_ms(plain, reps))
        if device_kernel is not None:
            res.device_ms = device_ms(kern, device_kernel)
        if replay:
            res.replay_ms = replay_ms(kern)
        if first:
            first_fn = lambda: eq_attention._eq_attention_stats(  # noqa: E731
                q, k, q_masks, k_masks, sq, sk, positive=positive, form="cuda")
            res.first_ms = _time_ms(first_fn, reps)
            if replay:
                res.first_replay_ms = replay_ms(first_fn)
            if device_kernel is not None:
                res.first_device_ms = device_ms(first_fn, "eq_stats_kernel")
    e, m, n = k.shape[0], k.shape[2], q.shape[2]
    nbytes = _nbytes(q, k, q_masks, k_masks) + 2 * a * e * h * n * 4 + a * e * 4
    ops = 2.0 * a * e * h * n * m * c
    # one exp per score with a valid key
    exps = float(a * e * h * n * int(k_masks.sum()))
    return _with_bound(res, nbytes, ops, dtype, exps=exps)


def check_eq_apply(q_masks, k_masks, a=6, h=4, c=64, dtype=torch.bfloat16, seed=6,
                   reps=3, device_kernel=None, two_calls=False, zero_rows=(), replay=False,
                   first=False):
    """K7 on random q, k, v, the plain version's row statistics and
    normalised random weights w (A, E), the anchors in ``zero_rows`` with
    all-zero weights; tolerance 1e-2 * max|out| in bf16 (p rounded to bf16,
    sums in another order), 1e-4 in float32.  With ``device_kernel`` (a
    kernel name) also the device time of that kernel per call; with
    ``two_calls`` the time of two PyTorch calls computing the same function
    (``scaled_dot_product_attention`` over the A * E * H heads with the key
    mask, then the w-weighted sum over e; the heads expanded beforehand),
    a yardstick the port never calls; with ``replay``, the call's time
    replayed from a CUDA graph (:func:`replay_ms`); with ``first``, the
    first design's (``_eq_attention_apply(..., form="cuda")``) time on the
    same inputs by events and (with ``replay``) replayed."""
    q, k, v, _, _ = _eq_inputs(q_masks, k_masks, a, h, c, dtype, seed)
    rowmax, rowsum, _ = eq_attention.eq_attention_stats_plain(q, k, q_masks, k_masks)
    g = torch.Generator().manual_seed(seed + 1)
    w = torch.rand((a, k.shape[0]), generator=g).to(q.device)
    w = w / w.sum(dim=1, keepdim=True)
    w[list(zero_rows)] = 0.0
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    kern = lambda: eq_attention.eq_attention_apply(  # noqa: E731
        q, k, v, w, rowmax, rowsum, k_masks)
    res = _compare(
        "eq_attention_apply",
        f"q(A={a}, H={h}, N={q.shape[2]}, c={c}) M={k.shape[2]} {dtype}",
        kern,
        lambda: eq_attention.eq_attention_apply_plain(q, k, v, w, rowmax, rowsum, k_masks),
        lambda want: tol * float(want.abs().max()), reps)
    e, m, n = k.shape[0], k.shape[2], q.shape[2]
    if device_kernel is not None:
        res.device_ms = device_ms(kern, device_kernel)
    if replay:
        res.replay_ms = replay_ms(kern)
    if first:
        first_fn = lambda: eq_attention._eq_attention_apply(  # noqa: E731
            q, k, v, w, rowmax, rowsum, k_masks, form="cuda")
        res.first_ms = _time_ms(first_fn, reps)
        if replay:
            res.first_replay_ms = replay_ms(first_fn)
    if two_calls:
        qe = q[:, None].expand(a, e, h, n, c).reshape(a * e * h, n, c)
        ke = k[None].expand(a, e, h, m, c).reshape(a * e * h, m, c)
        ve = v[None].expand(a, e, h, m, c).reshape(a * e * h, m, c)
        mask = k_masks[None, :]
        wf = w.float()

        def library():
            o = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=mask)
            return torch.einsum("ae,aehnc->ahnc", wf, o.reshape(a, e, h, n, c).float())
        res.two_calls_ms = _time_ms(library, reps)
    nbytes = _nbytes(q, k, v, w, rowmax, rowsum, k_masks) + a * h * n * c * 4
    ops = 2.0 * a * e * h * n * m * 2 * c
    return _with_bound(res, nbytes, ops, dtype, exps=float(a * e * h * n * int(k_masks.sum())))


def _compare_many(name, shape, kernel_fn, plain_fn, tol, reps):
    """Like :func:`_compare` for functions returning several tensors (None
    entries skipped): the error is the largest over the outputs of
    max|got - want| / max|want|, against ``tol``."""
    with prec.compute_dtype_scope("float32"):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  / max(float(w.float().abs().max()), 1e-30)
                  for g, w in zip(got, want) if w is not None)
        ms = _time_ms(kernel_fn, reps)
        plain_ms = _time_ms(plain_fn, reps)
    return CheckResult(name, shape + " (error relative to output scale)", err, tol, ms, plain_ms)


def tile_rereads(nbr, ns, tile) -> float:
    """Distinct (source tile, query) pairs of a neighbour set over B * Nq:
    how often K8's tiles form reads a dwf row (and K9's a query's out and
    share rows), on average."""
    b, nq, h = nbr.shape
    valid = (nbr >= 0) & (nbr < ns)
    q = torch.arange(nq, device=nbr.device)[None, :, None].expand(b, nq, h)
    key = (torch.arange(b, device=nbr.device)[:, None, None] * (ns // tile + 1)
           + nbr.long() // tile) * nq + q
    return torch.unique(key[valid]).numel() / (b * nq)


def tile_plan_matches(nbr, ns) -> bool:
    """K8's tile plan built on the card from the reverse index of ``nbr``
    equals :func:`windowed_conv.tile_plan` (its plain version) in ``off``
    and in the entries it lists."""
    b, nq, h = nbr.shape
    ent, off = windowed_conv.tile_plan_from_reverse_index(
        *windowed_conv.reverse_index(nbr, ns), nq, h, ns)
    want_ent, want_off = windowed_conv.tile_plan(nbr, ns, windowed_conv.GATHER_WF_BWD_TILE)
    return torch.equal(off, want_off) and all(
        torch.equal(ent[i, lo:hi], want_ent[i, lo:hi])
        for i, (lo, hi) in enumerate(off[:, [0, -1]].tolist()))


def check_gather_wf_bwd(nbr, ns, ac, k=15, seed=7, reps=5, device_kernel=None, first=False):
    """K8 in float32 on dwf (B, Nq, K*ac) for the given neighbours, on the
    form ``windowed_conv.gather_wf_bwd_form`` names (its tile plan or
    reverse index is built by the first call, before the timing, as the
    first backward over a neighbour set builds it for all its convs);
    tolerance 1e-5 * max|dx| (float32 sums in another order).  Library:
    the backward of the ``F.embedding_bag`` sum that :func:`check_gather_wf`
    times for K1.  On the card the tiles form's plan is held against its
    plain version (``plan_ok``) and its build from the set's reverse index
    timed (``plan_ms``).  With ``device_kernel`` (a kernel name) also that
    kernel's device time per call and that of every kernel of the call;
    with ``first`` the first design's time on the same inputs (events, and
    its two kernels' device time where ``device_kernel`` is given) and
    ``bitwise``: the form's dx equals the first design's and a second call
    of its own bit for bit.  ``reread``: :func:`tile_rereads` at the
    tiles form's tile."""
    g = torch.Generator().manual_seed(seed)
    dev = nbr.device
    b, nq, h = nbr.shape
    dwf = torch.randn((b, nq, k * ac), generator=g).to(dev)
    infl = torch.rand((b, nq, h, k), generator=g).to(dev) * (nbr < ns)[..., None]
    form = windowed_conv.gather_wf_bwd_form(nq, h, k, ac)
    kernel_fn = lambda: windowed_conv.gather_wf_bwd(dwf, nbr, infl, ns)  # noqa: E731
    res = _compare(
        "gather_wf_bwd",
        f"dwf{tuple(dwf.shape)} nbr{tuple(nbr.shape)} Ns={ns} float32 ({form} form)",
        kernel_fn, lambda: windowed_conv.gather_wf_bwd_plain(dwf, nbr, infl, ns),
        lambda w: 1e-5 * float(w.abs().max()), reps)
    first_fn = lambda: windowed_conv._gather_wf_bwd(dwf, nbr, infl, ns,  # noqa: E731
                                                    form="first")
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
        res.call_device_ms = device_ms(kernel_fn, "")
    if first:
        got = kernel_fn()
        res.bitwise = bool(torch.equal(got.view(torch.int32), first_fn().view(torch.int32))
                           and torch.equal(got.view(torch.int32),
                                           kernel_fn().view(torch.int32)))
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "")
    res.form = form
    if form == "tiles":
        res.reread = tile_rereads(nbr, ns, windowed_conv.GATHER_WF_BWD_TILE)
        if dev.type == "cuda":
            res.plan_ok = tile_plan_matches(nbr, ns)
            order, offsets = windowed_conv._shared_reverse_index(nbr, ns)
            res.plan_ms = _time_ms(lambda: windowed_conv.tile_plan_from_reverse_index(
                order, offsets, nq, h, ns), reps)
    table, idx = _bag_inputs(torch.zeros((b, ns, ac), device=dev), nbr)
    table.requires_grad_(True)
    idx_k = idx[:, :, None, :].expand(b, nq, k, h).reshape(-1, h)
    w_k = infl.permute(0, 1, 3, 2).reshape(-1, h).contiguous()
    bag = F.embedding_bag(idx_k, table, per_sample_weights=w_k, mode="sum")
    d_bag = dwf.reshape(-1, ac)
    nvalid = int((nbr < ns).sum())
    # one neighbour structure: the index the kernel reads in place of nbr
    # (the reverse index, or the tile plan, of the same size)
    rev_bytes = 4 * (b * nq * h + b * (ns + 1))
    nbytes = _nbytes(dwf, infl) + rev_bytes + b * ns * ac * 4
    return _with_bound(res, nbytes, 2.0 * nvalid * k * ac, torch.float32,
                       lambda: torch.autograd.grad(bag, table, d_bag, retain_graph=True))


def check_neighbor_max_bwd(nbr, ns, ac, seed=8, reps=5, device_kernel=None, first=False):
    """K9 in float32 on x (B, ns, ac) with integer-valued entries (so that
    ties occur) and its forward max, on the form
    ``windowed_conv.neighbor_max_bwd_form`` names (its tile plan or reverse
    index built by the first call, before the timing, as the set's first
    backward builds it); tolerance 1e-5 * max|dx| (shares added in another
    order).  With ``device_kernel`` (a substring of the kernels' names) also
    those kernels' device time per call and that of every kernel of the
    call; with ``first`` the first design's time on the same inputs
    (events, and its two kernels' device time where ``device_kernel`` is
    given) and ``bitwise``: the form's dx equals the first design's and a
    second call of its own bit for bit.  ``reread``: :func:`tile_rereads`
    at the tile plan's tile (the tiles form reads a query's out and share
    rows once per source tile).  No single PyTorch call splits ties like
    this (``embedding_bag``'s max backward routes to one index)."""
    g = torch.Generator().manual_seed(seed)
    dev = nbr.device
    b, nq, h = nbr.shape
    x = torch.randint(-8, 9, (b, ns, ac), generator=g).float().to(dev)
    out = windowed_conv.neighbor_max_plain(x, nbr)
    dout = torch.randn((b, nq, ac), generator=g).to(dev)
    form = windowed_conv.neighbor_max_bwd_form(nq, h, ac)
    kernel_fn = lambda: windowed_conv.neighbor_max_bwd(dout, x, out, nbr)  # noqa: E731
    res = _compare(
        "neighbor_max_bwd",
        f"dout{tuple(dout.shape)} nbr{tuple(nbr.shape)} Ns={ns} float32 ({form} form)",
        kernel_fn, lambda: windowed_conv.neighbor_max_bwd_plain(dout, x, out, nbr),
        lambda w: 1e-5 * float(w.abs().max()), reps)
    res.form = form
    first_fn = lambda: windowed_conv._neighbor_max_bwd(dout, x, out, nbr,  # noqa: E731
                                                       form="first")
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
        res.call_device_ms = device_ms(kernel_fn, "")
    if first:
        got = kernel_fn()
        res.bitwise = bool(torch.equal(_bits(got), _bits(first_fn()))
                           and torch.equal(_bits(got), _bits(kernel_fn())))
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "")
    if form == "tiles":
        res.reread = tile_rereads(nbr, ns, windowed_conv.GATHER_WF_BWD_TILE)
    nvalid = int((nbr < ns).sum())
    # one neighbour structure, nbr (its reverse index and tile plan are
    # derived copies)
    nbytes = _nbytes(x, nbr, out, dout) + b * ns * ac * 4
    return _with_bound(res, nbytes, 2.0 * nvalid * ac, torch.float32)


def check_embedding_bwd(points, masks, c=256, k=3, sigma_d=0.2, sigma_a=15.0,
                        grad_dtype=torch.bfloat16, seed=9, reps=3, device_kernel=None,
                        first=False, ties=False):
    """K10 on the coarse points with a random cotangent d_emb (B, N, N, C)
    in ``grad_dtype``, on the form ``embedding.geometric_embedding_bwd_form``
    names.  Error relative to each output's scale, tolerance 1e-2: float32
    sums over B*N*N pairs in another order (the tc form: per block on the
    tensor cores, then over blocks), and where two of the k angle
    projections of an element agree to rounding the kernel (K3's arithmetic)
    and the plain version (its own) may route to different k.  With
    ``ties`` the second neighbour of every third query row repeats the first
    (exact ties), the third neighbour of the next rows lies 1e-4 beside the
    first (near ties), and every seventh column of wa is 0, so that in those
    channels the three projections are all 0 and the first argmax sends the
    whole gradient to T_a(angle_0).  With ``device_kernel`` (a kernel name)
    also that kernel's device time per call and that of every kernel of the
    call; with ``first`` the first design's time on the same inputs (events,
    and its kernel's device time where ``device_kernel`` is given)."""
    g = torch.Generator().manual_seed(seed)
    dev = points.device
    b, n, _ = points.shape
    bound_w = 1.0 / math.sqrt(c)
    wd, wa = ((torch.rand((c, c), generator=g) * 2 - 1) * bound_w for _ in range(2))
    bd, ba = ((torch.rand((c,), generator=g) * 2 - 1) * bound_w for _ in range(2))
    wd, wa, bd, ba = (t.to(dev) for t in (wd, wa, bd, ba))
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, k + 1, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(
        b, n, k, 3)
    if ties:
        knn[:, ::3, 1] = knn[:, ::3, 0]
        knn[:, 1::3, 2] = knn[:, 1::3, 0] + 1e-4
        wa[:, ::7] = 0.0
    d_emb = torch.randn((b, n, n, c), generator=g).to(dev, grad_dtype)
    args = (d_emb, points, knn, wd, bd, wa, ba, sigma_d, sigma_a)
    kernel_fn = lambda: embedding.geometric_embedding_bwd(*args)  # noqa: E731
    form = embedding.geometric_embedding_bwd_form(c, grad_dtype)
    res = _compare_many(
        "geometric_embedding_bwd", f"d_emb{tuple(d_emb.shape)} {grad_dtype} ({form} form)",
        kernel_fn, lambda: embedding.geometric_embedding_bwd_plain(*args), 1e-2, reps)
    first_fn = lambda: embedding._geometric_embedding_bwd(*args, form="cuda")  # noqa: E731
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
        res.call_device_ms = device_ms(kernel_fn, "")
    if first:
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "embedding_bwd_kernel")
    deg_d, deg_a, _, _ = embedding._folded_projections(wd, wa, sigma_a)
    # per d_emb element: deg_d + deg_a basis accumulations and the k angle
    # projections recomputed for the argmax, one FMA (2 operations) each, at
    # the peak of the cotangent's type (as K3's bound takes its output's)
    ops = 2.0 * b * n * n * c * (deg_d + deg_a + k * deg_a)
    nbytes = _nbytes(d_emb, points, knn, wd, wa, ba) + 2 * c * c * 4 + 2 * c * 4
    return _with_bound(res, nbytes, ops, grad_dtype)


def check_rpe_attention_bwd(points, masks, ah, c=64, cc=256, with_sh=True,
                            dtype=torch.bfloat16, seed=10, reps=3, device_kernel=None,
                            first=False, qw_scale=0.3, replay=False):
    """K11 (and the contractions after it) on the inputs of
    :func:`check_rpe_attention` with K5's own output and row log-sum-exp
    and a random float32 cotangent.  Error relative to each gradient's
    scale, tolerance 1e-2 in bf16 (the tc form rounds P, dS, dO and the
    embedding to bf16 before each product, with float32 sums; d_emb and
    the bf16 gradients rounded from float32 sums in another order) and
    1e-4 in float32.  With ``device_kernel`` (a kernel name) also that
    kernel's device time per call and that of every kernel of the call;
    with ``replay`` the call's time replayed from a CUDA graph
    (:func:`replay_ms`); with ``first`` the first design's time on the same
    inputs (events, and its kernel's device time where ``device_kernel`` is
    given)."""
    g = torch.Generator().manual_seed(seed)
    dev = points.device
    b, n, _ = points.shape
    rnd = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev, dtype)  # noqa: E731
    q, k, v = rnd(b, ah, n, c), rnd(b, ah, n, c), rnd(b, ah, n, c)
    qp = rnd(b, n, ah, cc, sc=cc ** -0.5)
    emb = rnd(b, n, n, cc)
    qw = (torch.randn((b, 3, ah, n), generator=g) * qw_scale).to(dev) if with_sh else None
    pts = rpe_attention.point_rows(points) if with_sh else None
    scale = 1.0 / math.sqrt(c)
    out, lse = rpe_attention.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, pts,
                                                         scale=scale)
    dout = torch.randn((b, ah, n, c), generator=g).to(dev)
    args = (q, k, v, qp, emb, masks, qw, pts, dout, out, lse)
    kernel_fn = lambda: rpe_attention.rpe_attention_bwd(*args, scale=scale)  # noqa: E731
    form = rpe_attention.rpe_attention_bwd_form(ah, c, cc, dtype)
    res = _compare_many(
        "rpe_attention_bwd",
        f"q(B={b}, AH={ah}, N={n}, c={c}) emb C={cc} {'with' if with_sh else 'no'} SH {dtype} "
        f"({form} form)",
        kernel_fn, lambda: rpe_attention.rpe_attention_bwd_plain(*args, scale=scale),
        1e-2 if dtype == torch.bfloat16 else 1e-4, reps)
    first_fn = lambda: rpe_attention._rpe_attention_bwd(*args, scale, form="cuda")  # noqa: E731
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
        res.call_device_ms = device_ms(kernel_fn, "")
    if replay:
        res.replay_ms = replay_ms(kernel_fn)
    if first:
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "rpe_attention_bwd_kernel")
    nkeys = int(masks.sum())
    # recompute q.k, qp.emb, dO.v; contractions dv, dk, dq (c each), dqp and
    # d_emb (C each); the SH term's few operations per pair are left out
    ops = 2.0 * ah * n * nkeys * (5 * c + 3 * cc)
    nbytes = _nbytes(q, k, v, qp, emb, masks, dout, out, lse) + _nbytes(q, k, v, qp, emb)
    if with_sh:
        nbytes += 2 * _nbytes(qw) + _nbytes(pts)
    return _with_bound(res, nbytes, ops, dtype)


def _pair_set(out, mask):
    """The (ref point, src point) pairs of a registration output where
    ``mask``, as a set of float tuples."""
    ref, src = (out[k].detach().cpu().double().numpy() for k in
                ("ref_corr_points", "src_corr_points"))
    keep = mask.detach().cpu().numpy()
    return {tuple(r) + tuple(s) for r, s in zip(ref[keep], src[keep])}


def registration_agreement(got: dict, want: dict, acceptance_radius: float,
                           tol: float = 1e-3) -> tuple[bool, str]:
    """Whether the registration ``got`` agrees with ``want``: two outputs of
    :func:`se3et_tpu_torch.nn.matching.local_global_registration` from
    matching scores that differ by rounding.

    The registration is discontinuous in its scores: top-k correspondence
    picks, the best-hypothesis argmax and the ``res < acceptance_radius``
    inlier masks are discrete, and a score difference far below any
    tolerance can flip one.  So the transforms are held to ``tol`` only
    where the comparison is continuous: both sides chose the same valid
    correspondences and the same final inliers (as point pairs), and those
    inliers (at least 3, not on one line) determine the fit.  Otherwise
    ``got``'s transform must be a finite proper rigid transform that aligns
    every final inlier of ``want`` within ``acceptance_radius``.  Returns
    (ok, description)."""
    tg = got["estimated_transform"].detach().cpu().double()
    tw = want["estimated_transform"].detach().cpu().double()
    w_in = _pair_set(want, want["corr_inliers"])
    same = (_pair_set(got, got["corr_valid"]) == _pair_set(want, want["corr_valid"])
            and _pair_set(got, got["corr_inliers"]) == w_in)
    pts = np.array([p[:3] for p in w_in]).reshape(-1, 3)
    sv = np.linalg.svd(pts - pts.mean(0), compute_uv=False) if len(pts) >= 3 else [1.0, 0.0]
    determined = len(pts) >= 3 and sv[1] > 1e-3 * sv[0]
    err = float((tg - tw).abs().max())
    if same and determined:
        return err <= tol, f"same decisions, {len(w_in)} inliers: |dT| {err:.2e} (tol {tol:.0e})"
    rot = tg[:3, :3]
    proper = (bool(torch.isfinite(tg).all())
              and float((rot.T @ rot - torch.eye(3, dtype=rot.dtype)).abs().max()) < 1e-4
              and abs(float(torch.linalg.det(rot)) - 1.0) < 1e-4
              and torch.equal(tg[3], torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tg.dtype)))
    if w_in:
        ref = torch.tensor([p[:3] for p in w_in], dtype=tg.dtype)
        src = torch.tensor([p[3:] for p in w_in], dtype=tg.dtype)
        res = float(torch.linalg.norm(ref - (src @ rot.T + tg[:3, 3]), dim=-1).max())
    else:
        res = 0.0
    why = "other decisions" if not same else f"{len(w_in)} inliers do not determine the fit"
    return (proper and res < acceptance_radius,
            f"{why}: |dT| {err:.2e} not gated; proper {proper}, largest residual of the "
            f"reference's inliers {res:.3e} (acceptance radius {acceptance_radius})")


def skip_reuse(nbr: torch.Tensor, ns: int, tile: int = 64) -> dict:
    """What a strided skip max over ``nbr`` (B, Nq, H) must read, by the
    K12/K13 tiling (``tile`` flattened (b, q) rows per block): the valid
    references, the distinct source rows summed over the tiles, the tiles,
    and the tiles with a valid neighbour.  Counted on whatever device
    ``nbr`` lies on."""
    b, nq, h = nbr.shape
    valid = (nbr >= 0) & (nbr < ns)
    rows = (torch.arange(b, device=nbr.device)[:, None, None] * nq
            + torch.arange(nq, device=nbr.device)[None, :, None]).expand(b, nq, h)
    cloud = torch.arange(b, device=nbr.device)[:, None, None].expand(b, nq, h)
    key = ((rows // tile) * (b * ns) + cloud * ns + nbr.long())[valid]
    return {"valid": int(valid.sum()), "distinct": int(torch.unique(key).numel()),
            "tiles": -(-b * nq // tile), "live_tiles": int(torch.unique(rows[valid] // tile).numel())}


def check_fused_conv(name, nbr, ns, ac, ac_out=0, ac2=0, k=15, dtype=torch.bfloat16,
                     seed=11, reps=5, device_kernel=None, first=False, replay=False):
    """K12 (``name`` "gather_wf_mm"), K13 ("gather_wf_max_mm") or K14
    ("gather_wf_max") on random x (B, ns, ac), influence, expanded weight
    (K*ac, ac_out) and skip payload (B, ns, ac2) for the given neighbours.
    The error is relative to the conv output's scale, tolerance 1e-2 in bf16
    (the per-k rounding of the gathered sums to bf16 can land an ulp apart
    where the float32 sums differ in order) and 1e-4 in float32; the skip
    max must equal the plain version's bit for bit (else the error is inf).
    ``route_ms`` times the unfused route that computes the same function
    (K1 + ``torch.matmul`` (+ K2) for K12/K13, K1 + K2 for K14), a
    yardstick of several library calls, not one.  With ``device_kernel`` (a
    substring of the kernel's name) ``device_ms`` is its device time per
    call from the profiler; with ``first`` (K12, K14) ``first_ms`` times its
    first design on the same inputs; with ``replay`` (K12) the kernel, its
    first design (with ``first``) and the unfused route are also timed
    replayed from a CUDA graph (:func:`replay_ms`)."""
    g = torch.Generator().manual_seed(seed)
    dev = nbr.device
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(dev, dtype)
    infl = (torch.rand((b, nq, h, k), generator=g).to(dev) * (nbr < ns)[..., None]).to(dtype)
    # the expanded weight as the model builds it: a transposed view of a
    # contiguous (A*Cout, K*AC) tensor (the layout K12/K13 read)
    rhs = (torch.randn((ac_out or 8, k * ac), generator=g) * (k * ac) ** -0.5).to(dev, dtype).t()
    x2 = torch.randn((b, ns, ac2 or 8), generator=g).to(dev, dtype)
    wc = windowed_conv
    fns = {
        "gather_wf_mm": (lambda: (wc.gather_wf_mm(x, nbr, infl, rhs), None),
                         lambda: (wc.gather_wf_mm_plain(x, nbr, infl, rhs), None),
                         lambda: (wc.gather_wf(x, nbr, infl) @ rhs).float()),
        "gather_wf_max_mm": (lambda: wc.gather_wf_max_mm(x, nbr, infl, x2, rhs),
                             lambda: wc.gather_wf_max_mm_plain(x, nbr, infl, x2, rhs),
                             lambda: ((wc.gather_wf(x, nbr, infl) @ rhs).float(),
                                      wc.neighbor_max(x2, nbr))),
        "gather_wf_max": (lambda: wc.gather_wf_max(x, nbr, infl, x2),
                          lambda: wc.gather_wf_max_plain(x, nbr, infl, x2),
                          lambda: (wc.gather_wf(x, nbr, infl), wc.neighbor_max(x2, nbr))),
    }
    kernel_fn, plain_fn, route_fn = fns[name]
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    with prec.compute_dtype_scope("float32"), torch.no_grad():
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = float((got[0].float() - want[0].float()).abs().max()) / max(
            float(want[0].float().abs().max()), 1e-30)
        if want[1] is not None and not torch.equal(got[1], want[1]):
            err = float("inf")
        ms, plain_ms = _time_ms(kernel_fn, reps), _time_ms(plain_fn, reps)
        route_ms = _time_ms(route_fn, reps)
        dev_ms = None if device_kernel is None else device_ms(kernel_fn, device_kernel)
        first_fn = (lambda: wc._gather_wf_mm_forward(x, nbr, infl, rhs, "first")) \
            if name == "gather_wf_mm" else \
            (lambda: wc._gather_wf_max_forward(x, nbr, infl, x2, "first"))
        first_ms = None if not first else _time_ms(first_fn, reps)
        replays = None if not replay else (
            replay_ms(kernel_fn), replay_ms(first_fn) if first else None, replay_ms(route_fn))
    skip = f" skip{tuple(x2.shape)}" if name != "gather_wf_mm" else ""
    mm = f" W({k * ac}, {ac_out})" if name != "gather_wf_max" else \
        f" K={k} ({wc.gather_wf_max_form(h, dtype, ac, x2.shape[2])} form)"
    res = CheckResult(name, f"x{tuple(x.shape)} nbr{tuple(nbr.shape)}{mm}{skip} {dtype} "
                      "(error relative to output scale)", err, tol, ms, plain_ms,
                      route_ms=route_ms, device_ms=dev_ms, first_ms=first_ms)
    if replays:
        res.replay_ms, res.first_replay_ms, res.route_replay_ms = replays
    if name == "gather_wf_mm":
        res.form = wc.gather_wf_mm_form(h, dtype, rhs.shape[1])
    nvalid = int((nbr < ns).sum())
    esz = x.element_size()
    nbytes = _nbytes(x, nbr, infl)
    ops = 2.0 * nvalid * k * ac
    if name == "gather_wf_max":
        nbytes += b * nq * k * ac * esz
    else:
        nbytes += _nbytes(rhs) + b * nq * ac_out * 4
        ops += 2.0 * b * nq * k * ac * ac_out
    if name != "gather_wf_mm":
        nbytes += _nbytes(x2) + b * nq * ac2 * esz
        ops += float(nvalid * ac2)
    return _with_bound(res, nbytes, ops, dtype)


def check_influence(q_points, s_points, nbr, kernel_points, sigma, mode="linear",
                    out_dtype=torch.bfloat16, reps=10, device_kernel=None, first=False,
                    replay=False):
    """K15 on the given (B, Nq, 3) / (B, Ns, 3) points, (B, Nq, H) neighbours
    and (K, 3) kernel points, on the form ``windowed_conv.influence_form``
    names.  The error is the largest over (infl, inf_sum)
    of max|got - want| / max|want|: 1e-2 in bf16 (one rounding of weights
    <= 1; float32 sums in another order may land an ulp apart), 1e-5 in
    float32.  With ``device_kernel`` (a kernel name) also that kernel's
    device time per call; with ``first`` the first design's time on the
    same inputs (events, and its kernel's device time where
    ``device_kernel`` is given) and ``bitwise``: both outputs equal the
    first design's and a second call's of their own bit for bit; with
    ``replay`` the time per call replayed from a CUDA graph
    (:func:`replay_ms`; the first design's too with ``first``)."""
    kp = torch.as_tensor(kernel_points, dtype=torch.float32, device=q_points.device)
    args = (q_points, s_points, nbr, kp)
    kw = dict(sigma=sigma, mode=mode, out_dtype=out_dtype)
    b, nq, h = nbr.shape
    k = kp.shape[0]
    form = windowed_conv.influence_form(h, k, out_dtype)
    kernel_fn = lambda: windowed_conv.influence(*args, **kw)  # noqa: E731
    res = _compare_many(
        "influence", f"q{tuple(q_points.shape)} nbr{tuple(nbr.shape)} K={k} "
        f"{mode} {out_dtype} ({form} form)",
        kernel_fn, lambda: windowed_conv.influence_plain(*args, **kw),
        1e-2 if out_dtype == torch.bfloat16 else 1e-5, reps)
    res.form = form
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
    if first:
        first_fn = lambda: windowed_conv.influence(*args, **kw, form="first")  # noqa: E731
        got, again, want = kernel_fn(), kernel_fn(), first_fn()
        res.bitwise = all(torch.equal(_bits(x), _bits(y)) and torch.equal(_bits(x), _bits(z))
                          for x, y, z in zip(got, want, again))
        res.first_ms = _time_ms(first_fn, reps)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "influence_kernel")
        if replay:
            res.first_replay_ms = replay_ms(first_fn, reps)
    if replay:
        res.replay_ms = replay_ms(kernel_fn, reps)
    out_bytes = b * nq * h * k * torch.empty((), dtype=out_dtype).element_size() \
        + b * nq * k * 4
    # per (query, neighbour, kernel point): the offset's dot product with
    # the kernel point, the expanded square, sqrt and the weight, about 12
    # operations, and one add of the H-sum
    ops = 13.0 * b * nq * h * k
    return _with_bound(res, _nbytes(q_points, s_points, nbr, kp) + out_bytes, ops,
                       torch.float32)


def check_rpe_attention_femb(points, masks, ah, c=64, cc=256, k=3, sigma_d=0.2, sigma_a=15.0,
                             with_sh=True, dtype=torch.bfloat16, seed=12, reps=3,
                             device_kernel=None, replay=False, first=False):
    """K16 on the coarse points (B, N, 3) and key masks (B, N): random q, k,
    v (B, AH, N, c), qp (B, N, AH, C) in ``dtype``, random projections
    (C, C) and, with ``with_sh``, qw (B, 3, AH, N); the k nearest valid
    neighbours of each point.  Tolerance on valid query rows 1e-2 *
    max|out| in bf16 (K5's; the kernel and the plain version round the same
    bases, G and rows, their float32 sums differ in order, so a row can
    land an ulp apart) and 1e-4 * max|out| in float32.  The kernel takes
    its tables folded once, before the calls, as the serving route folds
    them once a forward.  With ``device_kernel``, also that kernel's device
    time per call; with ``replay``, the call's time replayed from a CUDA
    graph (:func:`replay_ms`); with ``first``, the first design's
    (``_femb_forward(..., form="cuda")``, the CUDA-core kernel) time on the
    same inputs by events, replayed (with ``replay``) and as its kernel's
    device time (with ``device_kernel``)."""
    g = torch.Generator().manual_seed(seed)
    dev = points.device
    b, n, _ = points.shape
    rnd = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev, dtype)  # noqa: E731
    q, kk, v = rnd(b, ah, n, c), rnd(b, ah, n, c), rnd(b, ah, n, c)
    qp = rnd(b, n, ah, cc, sc=cc ** -0.5)
    bound_w = 1.0 / math.sqrt(cc)
    wd, wa = (((torch.rand((cc, cc), generator=g) * 2 - 1) * bound_w).to(dev) for _ in range(2))
    qw = (torch.randn((b, 3, ah, n), generator=g) * 0.3).to(dev) if with_sh else None
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, k + 1, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b, n, k, 3)
    pts = rpe_attention.point_rows(points)
    scale = 1.0 / math.sqrt(c)
    rows = masks[:, None, :, None].expand(b, ah, n, c)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    kw = dict(scale=scale, sigma_d=sigma_d, sigma_a=sigma_a)
    tables = rpe_attention.femb_tables(wd, wa, sigma_a, dtype) if dev.type == "cuda" else None
    kernel_fn = lambda: rpe_attention.rpe_self_attention_femb(  # noqa: E731
        q, kk, v, qp, masks, qw, pts, knn, wd, wa, tables=tables, **kw)
    res = _compare(
        "rpe_self_attention_femb",
        f"q(B={b}, AH={ah}, N={n}, c={c}) C={cc} {'with' if with_sh else 'no'} SH {dtype}",
        kernel_fn,
        lambda: rpe_attention.rpe_self_attention_femb_plain(q, kk, v, qp, masks, qw, pts, knn,
                                                            wd, wa, **kw),
        lambda w: tol * float(w[rows].abs().max()), reps, mask=rows)
    if device_kernel is not None:
        res.device_ms = device_ms(kernel_fn, device_kernel)
    if replay:
        res.replay_ms = replay_ms(kernel_fn)
    if first:
        first_fn = lambda: rpe_attention._femb_forward(  # noqa: E731
            q, kk, v, qp, masks, qw, pts, knn, wd, wa, scale, sigma_d, sigma_a, tables,
            form="cuda")
        res.first_ms = _time_ms(first_fn, reps)
        if replay:
            res.first_replay_ms = replay_ms(first_fn)
        if device_kernel is not None:
            res.first_device_ms = device_ms(first_fn, "rpe_attention_kernel")
    deg_d, deg_a, _, _ = embedding._folded_projections(wd, wa, sigma_a)
    nkeys = int(masks.sum())  # valid keys of the B clouds
    # per (query, valid key): the distance and k angle projections (deg_d +
    # k * deg_a terms per channel), the positional product (AH x C), the
    # content and value products (2 x AH x c), one FMA (2 operations) each,
    # and the SH term's few operations
    ops = 2.0 * n * nkeys * ((deg_d + k * deg_a) * cc + ah * cc + 2 * ah * c)
    if with_sh:
        ops += 8.0 * ah * n * nkeys
    nbytes = _nbytes(q, kk, v, qp, masks, points, knn, wd, wa) + b * ah * n * c * 4
    if with_sh:
        nbytes += _nbytes(qw)
    return _with_bound(res, nbytes, ops, dtype, exps=float(ah * n * nkeys))
