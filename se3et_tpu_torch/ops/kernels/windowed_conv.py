r"""E2PN conv gather and neighbour max-pool kernels (K1, K2).

Counterpart of ``se3et_tpu/ops/pallas/windowed_conv.py``.  The TPU kernels
there read Morton-segment *windows* of the source features through
one-hot matmuls, because a TPU has no fast row gather; a GPU has one, so
these kernels index neighbours directly and read no window maps (and
drop no neighbours).  Their JAX counterpart is the exact gather route of
``se3et_tpu/nn/epn.py`` (``KPConvInterSO3`` without ``window``, and
``max_pool_neighbors``).

* :func:`gather_wf` (K1, ``csrc/gather_wf.cu``) replaces
  ``windowed_gather_wf`` and the gather half of ``windowed_gather_wf_mm``,
  ``windowed_gather_wf_max`` and ``windowed_gather_wf_max_mm``; the E2PN
  weight matmul that those fuse in stays a ``torch.matmul`` (as the JAX
  exact route leaves it to XLA).
* :func:`neighbor_max` (K2, ``csrc/neighbor_max.cu``) replaces
  ``windowed_max_pool`` and the skip half of the fused max variants.

Both are differentiable with respect to the features (training): their
backwards are kernels too, :func:`gather_wf_bwd` (K8,
``csrc/gather_wf_bwd.cu``, replaces ``_wf_bwd_win``) and
:func:`neighbor_max_bwd` (K9, ``csrc/neighbor_max_bwd.cu``, replaces
``_max_bwd_win``).  They sum into source rows in a fixed order through a
reverse index of the neighbour set (:func:`reverse_index`, built at the
first backward over a neighbour tensor and shared by every later one, so
once per set for all its convs), so gradients are reproducible bit for
bit.  Influence is geometry and takes no gradient.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (building it on first use) or raises.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from se3et_tpu_torch.ops.geometry import batched_gather_rows
from se3et_tpu_torch.ops.kernels import _build

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def gather_wf_plain(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor) -> torch.Tensor:
    """wf[b, q, k*AC + ac] = sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac].

    x: (B, Ns, AC); nbr: (B, Nq, H) int32, sentinel Ns; infl: (B, Nq, H', K)
    with H' >= H (only the first H columns are read).  Accumulates in
    float32 and returns x's dtype.
    """
    b, nq, h = nbr.shape
    g = batched_gather_rows(x, nbr).float()  # (B, Nq, H, AC)
    wf = torch.einsum("bqhc,bqhk->bqkc", g, infl[:, :, :h].float())
    return wf.reshape(b, nq, -1).to(x.dtype)


def neighbor_max_plain(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """out[b, q, :] = max_h (nbr valid ? x[b, nbr, :] : 0); x: (B, Ns, AC)."""
    return batched_gather_rows(x, nbr).amax(dim=2)


def reverse_index(nbr: torch.Tensor, ns: int):
    """Reverse (CSR) index of a neighbour set nbr (B, Nq, H) over ``ns``
    source rows: ``order`` (B, Nq*H) int32, the flat (q*H + h) slots sorted
    stably by their source, and ``offsets`` (B, ns + 1) int32, so that the
    slots of source s are ``order[b, offsets[b, s]:offsets[b, s + 1]]``.
    Sentinel slots (== ns) sort after ``offsets[b, ns]`` and are skipped."""
    b = nbr.shape[0]
    vals, order = torch.sort(nbr.reshape(b, -1), dim=1, stable=True)
    bounds = torch.arange(ns + 1, dtype=vals.dtype, device=nbr.device).expand(b, -1)
    offsets = torch.searchsorted(vals, bounds.contiguous())
    return order.to(torch.int32).contiguous(), offsets.to(torch.int32).contiguous()


# neighbour tensor -> ((ns, version), its reverse index), dropped with the tensor
_REVERSE = WeakIdKeyDictionary()


def _shared_reverse_index(nbr: torch.Tensor, ns: int):
    """:func:`reverse_index` of ``nbr``, built on first use and reused while
    the same tensor lives unchanged: the convs of one neighbour set, and
    steps over the same pair, share one sort."""
    key = (ns, nbr._version)
    memo = _REVERSE.get(nbr)
    if memo is None or memo[0] != key:
        memo = (key, reverse_index(nbr, ns))
        _REVERSE[nbr] = memo
    return memo[1]


def _scatter_rows(rows: torch.Tensor, nbr: torch.Tensor, ns: int) -> torch.Tensor:
    """dx[b, s] = sum of rows[b, q, h] over the slots with nbr[b, q, h] == s
    (sentinel slots dropped); rows (B, Nq, H, AC) float32."""
    b, nq, h, ac = rows.shape
    idx = torch.where((nbr >= 0) & (nbr < ns), nbr, ns).long()
    idx = idx + torch.arange(b, device=nbr.device)[:, None, None] * (ns + 1)
    dx = rows.new_zeros((b * (ns + 1), ac))
    dx.index_add_(0, idx.reshape(-1), rows.reshape(-1, ac))
    return dx.reshape(b, ns + 1, ac)[:, :ns]


def gather_wf_bwd_plain(dwf: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                        ns: int) -> torch.Tensor:
    """Plain version of K8: the gradient of :func:`gather_wf_plain` with
    respect to x, in float32,
    ``dx[b, s, ac] = sum_{(q, h): nbr[b, q, h] = s} sum_k infl[b, q, h, k]
    dwf[b, q, k*AC + ac]``; dwf (B, Nq, K*AC) -> dx (B, ns, AC)."""
    b, nq, h = nbr.shape
    k = infl.shape[3]
    g = torch.einsum("bqhk,bqkc->bqhc", infl[:, :, :h].float(),
                     dwf.float().reshape(b, nq, k, -1))
    return _scatter_rows(g, nbr, ns)


def neighbor_max_bwd_plain(dout: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                           nbr: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: the gradient of :func:`neighbor_max_plain` with
    respect to x.  ``dout[b, q, c]`` is split evenly over the neighbours
    whose value ties the max ``out``, sentinel shadow zeros included in the
    count; the shadow zeros' shares are dropped (the gradient of ``jnp.max``
    over the sentinel-zeroed gather of the JAX package)."""
    ns = x.shape[1]
    tie = batched_gather_rows(x, nbr) == out[:, :, None, :]  # (B, Nq, H, AC)
    share = dout.float() / tie.sum(dim=2).clamp_min(1)
    return _scatter_rows(tie * share[:, :, None, :], nbr, ns).to(x.dtype)


def _check_common(x, nbr):
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported feature dtype {x.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"neighbour indices must be int32, got {nbr.dtype}")
    if x.ndim != 3 or nbr.ndim != 3 or nbr.shape[0] != x.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} nbr {tuple(nbr.shape)}")
    if nbr.device != x.device:
        raise ValueError("x and nbr must be on the same device")


def _gather_wf_forward(x, nbr, infl):
    if x.device.type == "cpu":
        return gather_wf_plain(x, nbr, infl)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, nq, h = nbr.shape
    k = infl.shape[3]
    if infl.shape[:2] != (b, nq) or infl.shape[2] < h:
        raise ValueError(f"bad influence shape {tuple(infl.shape)}")
    x = x.contiguous()
    nbr = nbr.contiguous()
    infl = infl[:, :, :h].to(x.dtype).contiguous()
    out = torch.empty((b, nq, k * x.shape[2]), dtype=x.dtype, device=x.device)
    fn = _build.function("gather_wf", f"se3et_gather_wf_{_DTYPES[x.dtype]}", 4, 6)
    _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), out.data_ptr(),
                    b, x.shape[1], nq, h, k, x.shape[2],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "gather_wf launch")
    gather_wf.launches += 1
    return out


class _GatherWF(torch.autograd.Function):
    """K1 forward, K8 backward (features only)."""

    @staticmethod
    def forward(ctx, x, nbr, infl):
        ctx.save_for_backward(infl)
        ctx.nbr, ctx.ns = nbr, x.shape[1]  # the tensor itself: the reverse index's key
        return _gather_wf_forward(x, nbr, infl)

    @staticmethod
    def backward(ctx, dwf):
        infl, = ctx.saved_tensors
        return gather_wf_bwd(dwf, ctx.nbr, infl, ctx.ns), None, None


def gather_wf(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor) -> torch.Tensor:
    """K1 (``csrc/gather_wf.cu``, replaces the TPU ``windowed_gather_wf``):
    see :func:`gather_wf_plain`; ``infl`` is cast to x's dtype.  Bound by
    device memory; the source notes the design.  Differentiable in ``x``
    (backward K8, :func:`gather_wf_bwd`)."""
    _check_common(x, nbr)
    if infl.requires_grad:
        raise ValueError("gather_wf: influence is geometry and takes no gradient")
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherWF.apply(x, nbr, infl)
    return _gather_wf_forward(x, nbr, infl)


gather_wf.launches = 0


def gather_wf_bwd(dwf: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                  ns: int) -> torch.Tensor:
    """K8 (``csrc/gather_wf_bwd.cu``, replaces the TPU ``_wf_bwd_win``): see
    :func:`gather_wf_bwd_plain`; float32.  Reads the reverse index of
    ``nbr`` (built at its first backward, then shared).  Bound by device
    memory; the source notes the design."""
    if dwf.device.type == "cpu":
        return gather_wf_bwd_plain(dwf, nbr, infl, ns)
    if dwf.device.type != "cuda":
        raise ValueError(f"unsupported device {dwf.device}")
    if dwf.dtype != torch.float32 or nbr.dtype != torch.int32:
        raise TypeError("gather_wf_bwd takes float32 gradients and int32 indices")
    b, nq, h = nbr.shape
    k = infl.shape[3]
    ac = dwf.shape[2] // k
    if dwf.shape != (b, nq, k * ac) or infl.shape[:2] != (b, nq) or infl.shape[2] < h:
        raise ValueError("bad gather_wf_bwd input shapes")
    order, offsets = _shared_reverse_index(nbr, ns)
    dwf = dwf.contiguous()
    infl = infl[:, :, :h].float().contiguous()
    g = torch.empty((b, nq * h, ac), dtype=torch.float32, device=dwf.device)
    dx = torch.empty((b, ns, ac), dtype=torch.float32, device=dwf.device)
    fn = _build.function("gather_wf_bwd", "se3et_gather_wf_bwd_f32", 6, 6)
    _build.check(fn(dwf.data_ptr(), infl.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), b, ns, nq, h, k, ac,
                    torch.cuda.current_stream(dwf.device).cuda_stream),
                 "gather_wf_bwd launch")
    gather_wf_bwd.launches += 1
    return dx


gather_wf_bwd.launches = 0


def _neighbor_max_forward(x, nbr):
    if x.device.type == "cpu":
        return neighbor_max_plain(x, nbr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, nq, h = nbr.shape
    x = x.contiguous()
    nbr = nbr.contiguous()
    out = torch.empty((b, nq, x.shape[2]), dtype=x.dtype, device=x.device)
    fn = _build.function("neighbor_max", f"se3et_neighbor_max_{_DTYPES[x.dtype]}", 3, 5)
    _build.check(fn(x.data_ptr(), nbr.data_ptr(), out.data_ptr(),
                    b, x.shape[1], nq, h, x.shape[2],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "neighbor_max launch")
    neighbor_max.launches += 1
    return out


class _NeighborMax(torch.autograd.Function):
    """K2 forward, K9 backward."""

    @staticmethod
    def forward(ctx, x, nbr):
        out = _neighbor_max_forward(x, nbr)
        ctx.save_for_backward(x, out)
        ctx.nbr = nbr  # the tensor itself: the reverse index's key
        return out

    @staticmethod
    def backward(ctx, dout):
        x, out = ctx.saved_tensors
        return neighbor_max_bwd(dout, x, out, ctx.nbr), None


def neighbor_max(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """K2 (``csrc/neighbor_max.cu``, replaces the TPU ``windowed_max_pool``):
    see :func:`neighbor_max_plain`; bit-identical to it.  Bound by device
    memory; the source notes the design.  Differentiable in ``x`` (backward
    K9, :func:`neighbor_max_bwd`)."""
    _check_common(x, nbr)
    if torch.is_grad_enabled() and x.requires_grad:
        return _NeighborMax.apply(x, nbr)
    return _neighbor_max_forward(x, nbr)


neighbor_max.launches = 0


def neighbor_max_bwd(dout: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
    """K9 (``csrc/neighbor_max_bwd.cu``, replaces the TPU ``_max_bwd_win``):
    see :func:`neighbor_max_bwd_plain`; float32, ``out`` the saved forward
    max.  Reads the reverse index of ``nbr`` as :func:`gather_wf_bwd` does.
    Bound by device memory; the source notes the design."""
    if x.device.type == "cpu":
        return neighbor_max_bwd_plain(dout, x, out, nbr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t.dtype != torch.float32 for t in (dout, x, out)) or nbr.dtype != torch.int32:
        raise TypeError("neighbor_max_bwd takes float32 tensors and int32 indices")
    b, ns, ac = x.shape
    _, nq, h = nbr.shape
    if dout.shape != (b, nq, ac) or out.shape != (b, nq, ac):
        raise ValueError("bad neighbor_max_bwd input shapes")
    order, offsets = _shared_reverse_index(nbr, ns)
    x, nbr, out, dout = (t.contiguous() for t in (x, nbr, out, dout))
    share = torch.empty((b, nq, ac), dtype=torch.float32, device=x.device)
    dx = torch.empty((b, ns, ac), dtype=torch.float32, device=x.device)
    fn = _build.function("neighbor_max_bwd", "se3et_neighbor_max_bwd_f32", 8, 5)
    _build.check(fn(x.data_ptr(), nbr.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    order.data_ptr(), offsets.data_ptr(), share.data_ptr(), dx.data_ptr(),
                    b, ns, nq, h, ac, torch.cuda.current_stream(x.device).cuda_stream),
                 "neighbor_max_bwd launch")
    neighbor_max_bwd.launches += 1
    return dx


neighbor_max_bwd.launches = 0
