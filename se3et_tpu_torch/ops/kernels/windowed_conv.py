r"""E2PN conv gather and neighbour max-pool kernels (K1, K2, K12-K14).

Counterpart of ``se3et_tpu/ops/pallas/windowed_conv.py``.  The TPU kernels
there read Morton-segment *windows* of the source features through
one-hot matmuls, because a TPU has no fast row gather; a GPU has one, so
these kernels index neighbours directly and read no window maps (and
drop no neighbours).  Their JAX counterpart is the exact gather route of
``se3et_tpu/nn/epn.py`` (``KPConvInterSO3`` without ``window``, and
``max_pool_neighbors``).

* :func:`gather_wf` (K1, ``csrc/gather_wf.cu``, in three forms chosen by
  :func:`gather_wf_form`) replaces
  ``windowed_gather_wf``; the E2PN weight matmul after it stays a
  ``torch.matmul`` (as the JAX exact route leaves it to XLA).
* :func:`neighbor_max` (K2, ``csrc/neighbor_max.cu``, in two forms chosen
  by :func:`neighbor_max_form`) replaces ``windowed_max_pool``.
* The serving forms (``serve_fused_conv``), forward only like their TPU
  counterparts: :func:`gather_wf_mm` (K12, ``csrc/gather_wf_mm.cu``)
  replaces ``windowed_gather_wf_mm`` (gather + weight product, no wf
  tensor written); :func:`gather_wf_max_mm` (K13, same source) replaces
  ``windowed_gather_wf_max_mm`` (K12 + the strided skip's max);
  :func:`gather_wf_max` (K14, ``csrc/gather_wf_max.cu``, in two forms
  chosen by :func:`gather_wf_max_form`) replaces ``windowed_gather_wf_max``
  (wf and the skip max in one launch; the weight product follows as a
  ``torch.matmul``).  Which conv takes which form is
  :func:`gather_wf_mm_fits`, :func:`gather_wf_max_mm_fits` and
  :func:`gather_wf_max_fits`.

K1 and K2 are differentiable with respect to the features (training): their
backwards are kernels too, :func:`gather_wf_bwd` (K8,
``csrc/gather_wf_bwd.cu``, replaces ``_wf_bwd_win``, in two forms chosen
by :func:`gather_wf_bwd_form`) and :func:`neighbor_max_bwd` (K9,
``csrc/neighbor_max_bwd.cu``, replaces ``_max_bwd_win``).  They sum into
source rows in a fixed order through the reverse index of the neighbour
set (:func:`reverse_index`; K8's tiles form through a tile plan merged
from it on the card, :func:`tile_plan_from_reverse_index`), built at the
first backward over a neighbour tensor and shared by every later one, so
one sort per set for all its convs; so gradients are reproducible bit for
bit.  Influence is geometry and takes no gradient.

:func:`influence` (K15, ``csrc/influence.cu``) replaces
``influence_windowed_pallas``: the kernel-point influence weights of a
(stage, neighbour set) computed on the card, where the pyramid carries no
host influence (:mod:`se3et_tpu_torch.data.influence`).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (building it on first use) or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


# K8's tiles form (csrc/gather_wf_bwd_tiles.cuh): a tile plan entry packs
# the slot's query, its neighbour column and its source row within the tile
# as q << 12 | h << 6 | local, so H <= 64, tiles of at most 64 rows, and
# Nq < 2^19
TILE_Q_SHIFT = 12
TILE_H_SHIFT = 6
TILE_MAX_ROWS = 1 << TILE_H_SHIFT
TILES_MAX_H = 1 << (TILE_Q_SHIFT - TILE_H_SHIFT)
TILES_MAX_NQ = 1 << (31 - TILE_Q_SHIFT)
# source rows of a tile of the tiles form, as its kernels are compiled
# (GATHER_WF_BWD_TILES_T in csrc/gather_wf_bwd_tiles.cuh)
GATHER_WF_BWD_TILE = 32


def tile_plan(nbr: torch.Tensor, ns: int, tile: int):
    """The tile plan of a neighbour set nbr (B, Nq, H) over ``ns`` source
    rows for K8's tiles form: ``ent`` (B, Nq*H) int32, the flat (q*H + h)
    slots sorted stably by their source's tile ``nbr // tile`` -- so by
    (q, h) within a tile -- each packed as ``q << 12 | h << 6 | nbr % tile``;
    and ``off`` (B, ceil(ns / tile) + 1) int32, so that the slots of tile t
    are ``ent[b, off[b, t]:off[b, t + 1]]``.  Slots outside [0, ns) lie
    outside ``ent[b, off[b, 0]:off[b, -1]]`` (negative ones before it,
    sentinels after it) and are never read.  One sort and one
    ``searchsorted``, on the tensor's device: the plain version of
    :func:`tile_plan_from_reverse_index`, which the card runs."""
    b, nq, h = nbr.shape
    if not 1 <= tile <= TILE_MAX_ROWS:
        raise ValueError(f"tile_plan: tiles of 1-{TILE_MAX_ROWS} rows, not {tile}")
    ntiles = -(-ns // tile)
    flat = nbr.reshape(b, -1).to(torch.int32)
    # negative slots take negative keys (floor division), sentinels ntiles
    key = torch.where(flat < ns, torch.div(flat, tile, rounding_mode="floor"), ntiles)
    keys, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(ntiles + 1, dtype=keys.dtype, device=nbr.device).expand(b, -1)
    off = torch.searchsorted(keys, bounds.contiguous(), out_int32=True)
    slot = torch.arange(nq * h, dtype=torch.int32, device=nbr.device)
    packed = (((slot // h) << TILE_Q_SHIFT) | ((slot % h) << TILE_H_SHIFT)) | (flat % tile)
    return torch.gather(packed, 1, order).contiguous(), off


def tile_plan_from_reverse_index(order: torch.Tensor, offsets: torch.Tensor, nq: int, h: int,
                                 ns: int):
    """K8's tile plan of a neighbour set (B, nq, h) over ``ns`` rows, built
    on the card (``csrc/gather_wf_bwd_tiles.cuh`` ``tile_plan_kernel``, a
    merge of each tile's CSR lists in slot order) from its reverse index
    ``(order, offsets)`` (:func:`reverse_index`), so that the set's one sort
    serves K8, K9 and the first design.  Equal to :func:`tile_plan` at
    :data:`GATHER_WF_BWD_TILE` in ``off`` and in ``ent[b, off[b, 0]:off[b,
    -1]]``; the rest of ``ent`` is not written."""
    if order.device.type != "cuda":
        raise ValueError("tile_plan_from_reverse_index runs on the card; tile_plan is its "
                         "plain version")
    b = order.shape[0]
    ent = torch.empty_like(order)
    off = torch.empty((b, -(-ns // GATHER_WF_BWD_TILE) + 1), dtype=torch.int32,
                      device=order.device)
    fn = _build.function("gather_wf_bwd", "se3et_gather_wf_bwd_tile_plan", 4, 5)
    _build.check(fn(order.data_ptr(), offsets.data_ptr(), ent.data_ptr(), off.data_ptr(), b, ns,
                    nq, h, GATHER_WF_BWD_TILE,
                    torch.cuda.current_stream(order.device).cuda_stream),
                 "gather_wf_bwd tile plan launch")
    return ent, off


# neighbour tensor -> (version, {ns: its tile plan}), dropped with the tensor
_TILE_PLANS = WeakIdKeyDictionary()


def _shared_tile_plan(nbr: torch.Tensor, ns: int):
    """The tile plan of ``nbr`` at :data:`GATHER_WF_BWD_TILE`, built on first
    use and reused while the same tensor lives unchanged (keyed as
    :func:`_shared_reverse_index`): on the card from the set's shared
    reverse index (:func:`tile_plan_from_reverse_index`), elsewhere by
    :func:`tile_plan`."""
    memo = _TILE_PLANS.get(nbr)
    if memo is None or memo[0] != nbr._version:
        memo = (nbr._version, {})
        _TILE_PLANS[nbr] = memo
    plan = memo[1].get(ns)
    if plan is None:
        if nbr.device.type == "cuda":
            b, nq, h = nbr.shape
            plan = tile_plan_from_reverse_index(*_shared_reverse_index(nbr, ns), nq, h, ns)
        else:
            plan = tile_plan(nbr, ns, GATHER_WF_BWD_TILE)
        memo[1][ns] = plan
    return plan


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


# K1's tensor-core form holds a row's influence as mma A fragments of 16
# neighbours each, at most 4 of them (H <= 64), and stages neighbour rows in
# 16-byte units (AC a multiple of 8).  Its float32 "rows" form keeps 4
# channels x K <= 16 kernel points of sums a lane and compacts a row's
# valid slots by two 32-slot ballots (H <= 64, AC a multiple of 4); a warp
# takes every slice of its rows, a slice at most 32 16-byte units of the
# row, the slices of a row balanced.  Wider neighbour sets take the first
# design in either dtype.
GATHER_WF_TC_MAX_H = 64
GATHER_WF_ROWS_MAX_H = 64


class GatherWFRowsPlan(NamedTuple):
    """How K1's rows form runs on a shape: the form ("rows", or "first"
    where the rows form does not take it), slices of a row and 16-byte units
    of a slice (0 in the first form)."""
    form: str
    slices: int
    width: int


def gather_wf_rows_plan(h: int, k: int, ac: int) -> GatherWFRowsPlan:
    """K1's float32 plan for ``h`` neighbours, ``k`` kernel points and
    ``ac`` channels, as ``se3et_gather_wf_rows_plan`` in
    ``csrc/gather_wf.cu`` makes it."""
    if not (1 <= k <= _KP and 1 <= h <= GATHER_WF_ROWS_MAX_H and ac >= 4 and ac % 4 == 0):
        return GatherWFRowsPlan("first", 0, 0)
    units = ac // 4
    slices = -(-units // 32)
    return GatherWFRowsPlan("rows", slices, -(-units // slices))


def gather_wf_form(h: int, dtype, k: int, ac: int) -> str:
    """Which hand-written K1 kernel takes a gather over ``h`` neighbours and
    ``k`` kernel points of ``ac`` channels of ``dtype`` features: "tc" (bf16,
    H <= 64: the tensor-core form), "rows" (float32 where
    :func:`gather_wf_rows_plan` takes the shape: every conv of the training
    step) or "first" (the first design: bf16 with H > 64, float32 outside
    the rows form's limits).  Chosen by shape alone; none is a fallback of
    another."""
    if dtype == torch.bfloat16:
        return "tc" if h <= GATHER_WF_TC_MAX_H else "first"
    return gather_wf_rows_plan(h, k, ac).form


_GATHER_WF_SYMBOLS = {"tc": "se3et_gather_wf_tc_bf16", "rows": "se3et_gather_wf_rows_f32",
                      "first": "se3et_gather_wf_{}"}


def _gather_wf_forward(x, nbr, infl, form: Optional[str] = None):
    """K1 on the kernel :func:`gather_wf_form` names, or on ``form`` where
    the caller asks for one ("first" takes every shape with K <= 16)."""
    if x.device.type == "cpu":
        return gather_wf_plain(x, nbr, infl)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, nq, h = nbr.shape
    k, ac = infl.shape[3], x.shape[2]
    chosen = gather_wf_form(h, x.dtype, k, ac)
    form = form or chosen
    if form != "first" and form != chosen:
        raise ValueError(f"K1's {form} form does not take H={h}, K={k}, AC={ac}, {x.dtype}")
    x, nbr = x.contiguous(), nbr.contiguous()
    if form == "rows" and x.data_ptr() % 16:  # a view into a buffer: rows must be 16-byte aligned
        x = x.clone()
    # the influence as it lies: its first h of hs columns, cast only when
    # its dtype differs
    infl = (infl if infl.dtype == x.dtype else infl.to(x.dtype)).contiguous()
    out = torch.empty((b, nq, k * ac), dtype=x.dtype, device=x.device)
    fn = _build.function("gather_wf", _GATHER_WF_SYMBOLS[form].format(_DTYPES[x.dtype]), 4, 7)
    _build.check(fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), out.data_ptr(),
                    b, x.shape[1], nq, h, infl.shape[2], k, ac,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 f"gather_wf launch ({form})")
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
    see :func:`gather_wf_plain`; ``infl`` (B, Nq, H' >= H, K <= 16) is read
    in place, cast to x's dtype where it differs.  The kernel is the one
    :func:`gather_wf_form` names: in bf16 with H <= 64 the tensor-core form
    (AC a multiple of 8, else ``ValueError``), in float32 with H <= 64 and
    AC a multiple of 4 the rows form (bit for bit the first design's
    output; x copied where its rows are not 16-byte aligned), otherwise the
    first design.  Bound by device memory (the wf output); the source notes
    the designs.
    Differentiable in ``x`` (backward K8, :func:`gather_wf_bwd`)."""
    _check_common(x, nbr)
    b, nq, h = nbr.shape
    if infl.ndim != 4 or infl.shape[:2] != (b, nq) or infl.shape[2] < h \
            or not 1 <= infl.shape[3] <= _KP:
        raise ValueError(f"gather_wf: bad influence shape {tuple(infl.shape)}")
    if gather_wf_form(h, x.dtype, infl.shape[3], x.shape[2]) == "tc" and x.shape[2] % 8:
        raise ValueError(f"gather_wf: AC={x.shape[2]} is not a multiple of 8")
    if infl.requires_grad:
        raise ValueError("gather_wf: influence is geometry and takes no gradient")
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherWF.apply(x, nbr, infl)
    return _gather_wf_forward(x, nbr, infl)


gather_wf.launches = 0


def gather_wf_bwd_form(nq: int, h: int, k: int, ac: int) -> str:
    """Which hand-written K8 kernel takes the backward of a gather of ``nq``
    query rows over ``h`` neighbours and ``k`` kernel points of ``ac``
    channels (float32 gradients, the only ones K8 takes): "tiles" (the
    redesign, ``csrc/gather_wf_bwd_tiles.cuh``) where K <= 16, H <= 64 and
    Nq < 2^19 (what its plan entries hold) and AC is a multiple of 4: every
    training shape; else "first" (the first design).  Chosen by shape
    alone; neither is a fallback of the other."""
    return ("tiles" if 1 <= k <= _KP and h <= TILES_MAX_H and nq < TILES_MAX_NQ and ac % 4 == 0
            else "first")


def gather_wf_bwd(dwf: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                  ns: int) -> torch.Tensor:
    """K8 (``csrc/gather_wf_bwd.cu``, replaces the TPU ``_wf_bwd_win``): see
    :func:`gather_wf_bwd_plain`; float32, on the form
    :func:`gather_wf_bwd_form` names.  The tiles form reads the tile plan of
    ``nbr`` (:func:`tile_plan`), the first design its reverse index; each
    is built at the first backward over the tensor, then shared.  Both give
    the same bits.  Bound by device memory; the sources note the designs."""
    return _gather_wf_bwd(dwf, nbr, infl, ns)


def _gather_wf_bwd(dwf, nbr, infl, ns, form: Optional[str] = None):
    """K8 on the form :func:`gather_wf_bwd_form` names, or on ``form`` where
    the caller asks for one ("first" takes every shape with K <= 16)."""
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
    chosen = gather_wf_bwd_form(nq, h, k, ac)
    form = form or chosen
    if form == "tiles" and chosen != "tiles":
        raise ValueError(f"K8's tiles form does not take Nq={nq}, H={h}, K={k}, AC={ac}")
    dwf = dwf.contiguous()
    dx = torch.empty((b, ns, ac), dtype=torch.float32, device=dwf.device)
    stream = torch.cuda.current_stream(dwf.device).cuda_stream
    if form == "tiles":
        if dwf.data_ptr() % 16:  # a view into a buffer: its rows must be 16-byte aligned
            dwf = dwf.clone()
        ent, off = _shared_tile_plan(nbr, ns)
        # the influence as it lies: its first h of hs columns, cast only when
        # its dtype differs
        infl = (infl if infl.dtype == torch.float32 else infl.float()).contiguous()
        work = torch.empty(1, dtype=torch.int32, device=dwf.device)  # the items' counter
        fn = _build.function("gather_wf_bwd", "se3et_gather_wf_bwd_tiles_f32", 6, 8)
        status = fn(dwf.data_ptr(), infl.data_ptr(), ent.data_ptr(), off.data_ptr(),
                    dx.data_ptr(), work.data_ptr(), b, ns, nq, h, infl.shape[2], k, ac,
                    GATHER_WF_BWD_TILE, stream)
    else:
        order, offsets = _shared_reverse_index(nbr, ns)
        infl = infl[:, :, :h].float().contiguous()
        g = torch.empty((b, nq * h, ac), dtype=torch.float32, device=dwf.device)
        fn = _build.function("gather_wf_bwd", "se3et_gather_wf_bwd_f32", 6, 6)
        status = fn(dwf.data_ptr(), infl.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), b, ns, nq, h, k, ac, stream)
    _build.check(status, f"gather_wf_bwd launch ({form})")
    gather_wf_bwd.launches += 1
    return dx


gather_wf_bwd.launches = 0


# K2's forms (csrc/neighbor_max.cu, codes as its entry points'): "rows"
# where a row is a whole number of 16-byte units, "first" (the first
# design) for any other width.  The rows form's plan, as the C
# plan_for makes it: a warp per (query row, slice of 32 x SU units), at
# most ROWS_MAX_SU units a lane, the slices of a row balanced; each lane
# keeps NB = ROWS_LOAD_WORDS / (4 SU) neighbour rows of loads in flight
# (32-bit registers) and 4 SU of maxima; ROWS_WARPS warps a block
NEIGHBOR_MAX_FORMS = {"rows": 1, "first": 2}
ROWS_MAX_SU = 3
ROWS_LOAD_WORDS = 48
ROWS_WARPS = 8
FIRST_THREADS = 128


class NeighborMaxPlan(NamedTuple):
    """How K2 runs on rows of AC elements: the form, 16-byte units a lane
    of a slice, slices a row, neighbour rows in flight a lane and warps a
    block (the first design's su, slices and nb are 0)."""
    form: str
    su: int
    slices: int
    nb: int
    warps: int


def neighbor_max_plan(ac: int, dtype) -> NeighborMaxPlan:
    """K2's plan for rows of ``ac`` elements of ``dtype``, as
    ``se3et_neighbor_max_plan`` in ``csrc/neighbor_max.cu`` makes it."""
    per_unit = 16 // torch.empty((), dtype=dtype).element_size()
    if ac < 1 or ac % per_unit:
        return NeighborMaxPlan("first", 0, 0, 0, FIRST_THREADS // 32)
    units = ac // per_unit
    slices = -(-units // (32 * ROWS_MAX_SU))
    su = -(-units // (32 * slices))
    return NeighborMaxPlan("rows", su, slices, ROWS_LOAD_WORDS // (4 * su), ROWS_WARPS)


def neighbor_max_form(ac: int, dtype) -> str:
    """Which hand-written K2 kernel takes rows of ``ac`` elements: "rows"
    (``neighbor_max_rows_kernel``; AC a multiple of 8 in bf16, of 4 in
    float32: every width of the model) or "first" (``neighbor_max_kernel``,
    the first design; any other width).  Chosen by shape alone, as the C
    entry point chooses; neither is a fallback of the other."""
    return neighbor_max_plan(ac, dtype).form


def _neighbor_max_forward(x, nbr, form: Optional[str] = None):
    """The forward on the kernel :func:`neighbor_max_form` names, or on
    ``form`` where the caller asks for one that takes the width ("first"
    takes any)."""
    if x.device.type == "cpu":
        return neighbor_max_plain(x, nbr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, nq, h = nbr.shape
    form = form or neighbor_max_form(x.shape[2], x.dtype)
    x = x.contiguous()
    nbr = nbr.contiguous()
    if form == "rows" and x.data_ptr() % 16:
        raise ValueError("K2's rows form reads 16-byte units: x must start 16-byte aligned")
    out = torch.empty((b, nq, x.shape[2]), dtype=x.dtype, device=x.device)
    fn = _build.function("neighbor_max", f"se3et_neighbor_max_{_DTYPES[x.dtype]}", 3, 6)
    _build.check(fn(x.data_ptr(), nbr.data_ptr(), out.data_ptr(),
                    b, x.shape[1], nq, h, x.shape[2], NEIGHBOR_MAX_FORMS[form],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 f"neighbor_max launch ({form})")
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
    see :func:`neighbor_max_plain`; bit-identical to it, on the form
    :func:`neighbor_max_form` names.  Bound by device memory; the source
    notes the design.  Differentiable in ``x`` (backward K9,
    :func:`neighbor_max_bwd`)."""
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


# K12 keeps the (64, A*Cout) float32 output tile of its 64 query rows in the
# registers of one 8-warp block per SM (96 per thread at A*Cout = 384); K13's
# first design runs two blocks per SM (its skip max is a latency-bound
# gather), which halves that to 48 per thread (A*Cout = 192), the width
# K13 takes in both forms.  K12 and K13 in bf16 read the
# influence in place into registers and gather on the tensor cores for
# H <= MM_TC_MAX_H (past it the influence fragments and the staged
# neighbour rows outgrow registers and shared memory); wider neighbour
# sets and the float32 K12 and K13 read it as 16 padded weights per (query,
# neighbour).  K13's tensor-core form keeps the skip maxima of a row in
# registers, at most 6 16-byte units for each of a warp's 32 lanes, and
# K14's first design those of its 4 query rows, at most 6 groups of 8
# channels for each of its 128 threads: both take A*C2 <= 1536.  K14's tc
# form slices the payload row as K2 does and keeps the same gate (the JAX
# package's split pools wider skips in K2).
MM_MAX_AC_OUT = 384
MAX_MM_MAX_AC_OUT = 192
MAX_SKIP_AC = 1536
MM_TC_MAX_H = 32
_KP = 16


def gather_wf_mm_fits(ac: int, ac_out: int, k: int) -> bool:
    """Whether K12 takes a conv of AC = A*Cin input and A*Cout = ``ac_out``
    output channels with ``k`` kernel points."""
    return k <= _KP and ac % 8 == 0 and ac_out % 8 == 0 and 0 < ac_out <= MM_MAX_AC_OUT


def gather_wf_max_mm_fits(ac: int, ac_out: int, ac2: int, k: int) -> bool:
    """Whether K13 takes a strided conv (as :func:`gather_wf_mm_fits`) with
    a skip payload of ``ac2`` channels."""
    return (k <= _KP and ac % 8 == 0 and ac_out % 8 == 0 and ac2 % 2 == 0
            and 0 < ac_out <= MAX_MM_MAX_AC_OUT)


def gather_wf_max_fits(ac2: int, k: int) -> bool:
    """Whether K14 takes a strided conv with ``k`` kernel points and a skip
    payload of ``ac2`` channels."""
    return k <= _KP and ac2 % 8 == 0 and 0 < ac2 <= MAX_SKIP_AC


def gather_wf_max_mm_form(h: int, dtype, ac2: int) -> str:
    """Which hand-written K13 kernel takes a strided conv over ``h``
    neighbours of ``dtype`` features with an ``ac2``-channel skip payload:
    "tc" (bf16, H <= MM_TC_MAX_H, AC2 a multiple of 8 up to MAX_SKIP_AC: the
    skip max by 16-byte loads of whole payload rows, then K12's tensor-core
    tile) or "first" (the first design: float32, and bf16 with wider
    neighbour sets or other payloads).  Chosen by shape alone, as the
    wrapper launches; both are kernels, neither a fallback of the other."""
    tc = (dtype == torch.bfloat16 and h <= MM_TC_MAX_H and ac2 % 8 == 0
          and 0 < ac2 <= MAX_SKIP_AC)
    return "tc" if tc else "first"


def gather_wf_mm_plain(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """out[b, q, :] = sum_k wf[b, q, k, :] @ rhs[k*AC:(k+1)*AC, :] in float32,
    wf = :func:`gather_wf_plain` (rounded to x's dtype, as the TPU kernel's
    epilogue rounds each kernel point's sum); rhs (K*AC, A*Cout)."""
    return gather_wf_plain(x, nbr, infl).float() @ rhs.float()


def gather_wf_max_mm_plain(x, nbr, infl, x2, rhs):
    """(:func:`gather_wf_mm_plain`, :func:`neighbor_max_plain` of the skip
    payload x2 (B, Ns, AC2) over the same neighbours)."""
    return gather_wf_mm_plain(x, nbr, infl, rhs), neighbor_max_plain(x2, nbr)


def gather_wf_max_plain(x, nbr, infl, x2):
    """(:func:`gather_wf_plain`, :func:`neighbor_max_plain` of x2)."""
    return gather_wf_plain(x, nbr, infl), neighbor_max_plain(x2, nbr)


def _check_fused(name, x, nbr, infl, rhs=None, x2=None):
    """Checks shared by K12-K14: types, shapes, devices, and no gradient
    (the kernels have no backward, like their TPU counterparts)."""
    _check_common(x, nbr)
    tensors = [t for t in (x, infl, rhs, x2) if t is not None]
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward (serving only): an input requires grad")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    b, nq, h = nbr.shape
    if infl.ndim != 4 or infl.shape[:2] != (b, nq) or infl.shape[2] < h:
        raise ValueError(f"{name}: bad influence shape {tuple(infl.shape)}")
    if rhs is not None and (rhs.ndim != 2 or rhs.shape[0] != infl.shape[3] * x.shape[2]):
        raise ValueError(f"{name}: bad weight shape {tuple(rhs.shape)}")
    if x2 is not None and (x2.dtype != x.dtype or x2.ndim != 3
                           or x2.shape[:2] != x.shape[:2]):
        raise ValueError(f"{name}: bad skip payload {tuple(x2.shape)} {x2.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _padded_influence(infl, h, dtype):
    """(B, Nq, H, 16) influence in ``dtype``, zero past K: one 16-byte
    aligned row of weights per (query, neighbour)."""
    out = infl.new_zeros((*infl.shape[:2], h, _KP), dtype=dtype)
    out[..., :infl.shape[3]] = infl[:, :, :h]
    return out


def mm_panels(rhs: torch.Tensor, k: int, ac: int) -> torch.Tensor:
    """The expanded weight rhs (K*AC, A*Cout) as the tensor-core K12 reads
    it: one contiguous panel per (32-channel chunk c, kernel point k),
    ``panels[c, k, n, :] = rhs[k*AC + 32c : k*AC + 32c + 32, n]`` (zero past
    AC), each 64-byte row's four 16-byte units XOR-swizzled by the row pair
    (unit u at u ^ ((n >> 1) & 3)), the order the kernel's shared tiles
    use, so that one bulk copy lands a panel in place.  The plain version of
    the relayout the K12 wrapper launches on the card (one kernel: a 4.4 MB
    copy at the stage-1 convs)."""
    ac_out = rhs.shape[1]
    nch = -(-ac // 32)
    w = rhs.t().reshape(ac_out, k, ac)
    if nch * 32 != ac:
        w = torch.nn.functional.pad(w, (0, nch * 32 - ac))
    w = w.reshape(ac_out, k, nch, 4, 8)
    n = torch.arange(ac_out, device=rhs.device)
    unit = torch.arange(4, device=rhs.device)[None, :] ^ ((n[:, None] >> 1) & 3)
    w = torch.gather(w, 3, unit[:, None, None, :, None].expand(ac_out, k, nch, 4, 8))
    return w.permute(2, 1, 0, 3, 4).contiguous()


def _launch_mm(name, x, nbr, infl, rhs, x2=None):
    """K12 (x2 None) or K13 on CUDA tensors; returns (out, pooled or None)."""
    b, nq, h = nbr.shape
    k, ac, ac_out = infl.shape[3], x.shape[2], rhs.shape[1]
    x, nbr, rhs = x.contiguous(), nbr.contiguous(), rhs.to(x.dtype)
    out = torch.empty((b, nq, ac_out), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    pooled = None
    if x2 is not None:
        x2 = x2.contiguous()
        pooled = torch.empty((b, nq, x2.shape[2]), dtype=x2.dtype, device=x.device)
        tc = gather_wf_max_mm_form(h, x.dtype, x2.shape[2]) == "tc"
    else:
        tc = x.dtype == torch.bfloat16 and h <= MM_TC_MAX_H
    rhs_t = rhs.t().contiguous()  # (A*Cout, K*AC): free for a transposed view
    if tc:
        # the tensor-core K12 / K13 read the influence as it lies (its first
        # h of hs columns) and the weight as panels
        w = infl.to(x.dtype).contiguous()
        panels = torch.empty((-(-ac // 32), k, ac_out, 4, 8), dtype=x.dtype, device=x.device)
        _build.check(_build.function("gather_wf_mm", "se3et_gather_wf_mm_panels_bf16", 2, 3)(
            rhs_t.data_ptr(), panels.data_ptr(), k, ac, ac_out, stream), f"{name} panels")
        if x2 is None:
            fn = _build.function("gather_wf_mm", "se3et_gather_wf_mm_bf16", 5, 8)
            status = fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), panels.data_ptr(),
                        out.data_ptr(), b, x.shape[1], nq, h, w.shape[2], k, ac, ac_out,
                        stream)
        else:
            fn = _build.function("gather_wf_mm", "se3et_gather_wf_max_mm_tc_bf16", 7, 9)
            status = fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), panels.data_ptr(),
                        out.data_ptr(), x2.data_ptr(), pooled.data_ptr(), b, x.shape[1], nq,
                        h, w.shape[2], k, ac, ac_out, x2.shape[2], stream)
    else:
        w = _padded_influence(infl, h, x.dtype)
        if x2 is None:
            symbol = "se3et_gather_wf_mm_wide_bf16" if x.dtype == torch.bfloat16 \
                else "se3et_gather_wf_mm_f32"
            fn = _build.function("gather_wf_mm", symbol, 5, 7)
            status = fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), rhs_t.data_ptr(),
                        out.data_ptr(), b, x.shape[1], nq, h, k, ac, ac_out, stream)
        else:
            fn = _build.function("gather_wf_mm",
                                 f"se3et_gather_wf_max_mm_{_DTYPES[x.dtype]}", 7, 8)
            status = fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), rhs_t.data_ptr(),
                        out.data_ptr(), x2.data_ptr(), pooled.data_ptr(), b, x.shape[1], nq,
                        h, k, ac, ac_out, x2.shape[2], stream)
    _build.check(status, f"{name} launch")
    return out, pooled


def gather_wf_mm(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                 rhs: torch.Tensor) -> torch.Tensor:
    """K12 (``csrc/gather_wf_mm.cu``, replaces the TPU
    ``windowed_gather_wf_mm``): see :func:`gather_wf_mm_plain`; x (B, Ns,
    AC), rhs (K*AC, A*Cout) cast to x's dtype; returns (B, Nq, A*Cout)
    float32.  Forward only; raises on shapes :func:`gather_wf_mm_fits`
    refuses.  Bound by the tensor-core product at the serving shapes; the
    source notes the design."""
    _check_fused("gather_wf_mm", x, nbr, infl, rhs)
    if not gather_wf_mm_fits(x.shape[2], rhs.shape[1], infl.shape[3]):
        raise ValueError(f"gather_wf_mm does not take AC={x.shape[2]}, "
                         f"A*Cout={rhs.shape[1]}, K={infl.shape[3]}")
    if x.device.type == "cpu":
        return gather_wf_mm_plain(x, nbr, infl, rhs)
    out, _ = _launch_mm("gather_wf_mm", x, nbr, infl, rhs)
    gather_wf_mm.launches += 1
    return out


gather_wf_mm.launches = 0


def gather_wf_max_mm(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                     x2: torch.Tensor, rhs: torch.Tensor):
    """K13 (``csrc/gather_wf_mm.cu``, replaces the TPU
    ``windowed_gather_wf_max_mm``): see :func:`gather_wf_max_mm_plain`;
    returns ((B, Nq, A*Cout) float32, pooled (B, Nq, AC2) in x2's dtype,
    equal to K2's).  The kernel is the one :func:`gather_wf_max_mm_form`
    names: in bf16 with H <= 32 K12's tensor-core tiles with the skip max
    (its conv's sums those of K12's tc form), otherwise the first design.
    Forward only; raises on shapes :func:`gather_wf_max_mm_fits` refuses.
    The source notes the design and its bound."""
    _check_fused("gather_wf_max_mm", x, nbr, infl, rhs, x2)
    if not gather_wf_max_mm_fits(x.shape[2], rhs.shape[1], x2.shape[2], infl.shape[3]):
        raise ValueError(f"gather_wf_max_mm does not take AC={x.shape[2]}, "
                         f"A*Cout={rhs.shape[1]}, AC2={x2.shape[2]}, K={infl.shape[3]}")
    if x.device.type == "cpu":
        return gather_wf_max_mm_plain(x, nbr, infl, x2, rhs)
    out = _launch_mm("gather_wf_max_mm", x, nbr, infl, rhs, x2)
    gather_wf_max_mm.launches += 1
    return out


gather_wf_max_mm.launches = 0


# K14's forms (csrc/gather_wf_max.cu, codes as its entry points'): "tc" in
# bf16 where K1's tensor-core routine takes the conv (H <= 64, AC a multiple
# of 8) and the payload rows are whole 16-byte units, "first" (the first
# design) otherwise.  The tc form's plan, as the C plan_for makes it: conv
# items of GATHER_WF_CHUNK channels with the influence as HS 16-neighbour
# fragments, skip items as K2's rows plan slices the payload row (at most
# ROWS_MAX_SU units a lane, the slices balanced, NB = ROWS_LOAD_WORDS / (4
# SU) rows in flight)
GATHER_WF_MAX_FORMS = {"tc": 1, "first": 2}
GATHER_WF_CHUNK = 32


class GatherWFMaxPlan(NamedTuple):
    """How K14 runs: the form, 16-neighbour fragments HS, conv chunks a
    row, payload units a lane of a slice SU, slices a row and payload rows
    in flight a lane NB (all 0 in the first form)."""
    form: str
    hs: int
    chunks: int
    su: int
    slices: int
    nb: int


def gather_wf_max_plan(h: int, dtype, ac: int, ac2: int) -> GatherWFMaxPlan:
    """K14's plan for ``h`` neighbours, x of ``ac`` and a payload of ``ac2``
    channels of ``dtype``, as ``se3et_gather_wf_max_plan`` in
    ``csrc/gather_wf_max.cu`` makes it."""
    if dtype != torch.bfloat16 or not 1 <= h <= GATHER_WF_TC_MAX_H or ac < 8 or ac % 8 \
            or ac2 < 8 or ac2 % 8:
        return GatherWFMaxPlan("first", 0, 0, 0, 0, 0)
    units = ac2 // 8
    slices = -(-units // (32 * ROWS_MAX_SU))
    su = -(-units // (32 * slices))
    return GatherWFMaxPlan("tc", -(-h // 16), -(-ac // GATHER_WF_CHUNK), su, slices,
                           ROWS_LOAD_WORDS // (4 * su))


def gather_wf_max_form(h: int, dtype, ac: int, ac2: int) -> str:
    """Which hand-written K14 kernel takes a strided conv over ``h``
    neighbours of ``dtype`` features of ``ac`` channels with an
    ``ac2``-channel skip payload: "tc" (``gather_wf_max_tc_kernel``: bf16, H
    <= 64, AC and AC2 multiples of 8; the conv by K1's tensor-core routine,
    the skip max by K2's) or "first" (``gather_wf_max_kernel``, the first
    design: float32, and bf16 with H > 64 or AC not a multiple of 8).
    Chosen by shape alone, as the C entry point chooses; neither is a
    fallback of the other."""
    return gather_wf_max_plan(h, dtype, ac, ac2).form


def _gather_wf_max_forward(x, nbr, infl, x2, form: Optional[str] = None):
    """K14 on CUDA tensors, on the kernel :func:`gather_wf_max_form` names,
    or on ``form`` where the caller asks for one that takes the shape
    ("first" takes any the gate passes)."""
    b, nq, h = nbr.shape
    k, ac, ac2 = infl.shape[3], x.shape[2], x2.shape[2]
    form = form or gather_wf_max_form(h, x.dtype, ac, ac2)
    x, nbr, x2 = x.contiguous(), nbr.contiguous(), x2.contiguous()
    wf = torch.empty((b, nq, k * ac), dtype=x.dtype, device=x.device)
    pooled = torch.empty((b, nq, ac2), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if form == "tc":
        if x.data_ptr() % 16 or x2.data_ptr() % 16:
            raise ValueError("K14's tc form reads 16-byte units: x and x2 must start "
                             "16-byte aligned")
        # the influence as it lies: its first h of hs columns, cast only
        # when its dtype differs
        infl = (infl if infl.dtype == x.dtype else infl.to(x.dtype)).contiguous()
        work = torch.empty(1, dtype=torch.int32, device=x.device)  # the skip items' counter
        fn = _build.function("gather_wf_max", "se3et_gather_wf_max_tc_bf16", 7, 8)
        status = fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), wf.data_ptr(),
                    x2.data_ptr(), pooled.data_ptr(), work.data_ptr(), b, x.shape[1], nq, h,
                    infl.shape[2], k, ac, ac2, stream)
    else:
        infl = infl[:, :, :h].to(x.dtype).contiguous()
        fn = _build.function("gather_wf_max", f"se3et_gather_wf_max_{_DTYPES[x.dtype]}", 6, 7)
        status = fn(x.data_ptr(), nbr.data_ptr(), infl.data_ptr(), wf.data_ptr(),
                    x2.data_ptr(), pooled.data_ptr(), b, x.shape[1], nq, h, k, ac, ac2, stream)
    _build.check(status, f"gather_wf_max launch ({form})")
    gather_wf_max.launches += 1
    return wf, pooled


def gather_wf_max(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor,
                  x2: torch.Tensor):
    """K14 (``csrc/gather_wf_max.cu``, replaces the TPU
    ``windowed_gather_wf_max``): see :func:`gather_wf_max_plain`; returns
    (wf (B, Nq, K*AC), pooled (B, Nq, AC2)), both in x's dtype, pooled equal
    to K2's bit for bit.  The kernel is the one :func:`gather_wf_max_form`
    names: in bf16 with H <= 64 the tc form (wf equal to K1's tensor-core
    form bit for bit; x and x2 16-byte aligned, else ``ValueError``),
    otherwise the first design (wf equal to K1's first design bit for bit).
    ``infl`` (B, Nq, H' >= H, K) is read in place by the tc form.  Forward
    only; raises on widths :func:`gather_wf_max_fits` refuses.  Bound by
    device memory; the source notes the design."""
    _check_fused("gather_wf_max", x, nbr, infl, x2=x2)
    if not gather_wf_max_fits(x2.shape[2], infl.shape[3]):
        raise ValueError(f"gather_wf_max does not take AC2={x2.shape[2]}, K={infl.shape[3]}")
    if x.device.type == "cpu":
        return gather_wf_max_plain(x, nbr, infl, x2)
    return _gather_wf_max_forward(x, nbr, infl, x2)


gather_wf_max.launches = 0


INFLUENCE_MODES = {"linear": 0, "constant": 1, "gaussian": 2}


def influence_plain(q_points: torch.Tensor, s_points: torch.Tensor,
                    neighbor_indices: torch.Tensor, kernel_points: torch.Tensor, *,
                    sigma: float, mode: str = "linear", out_dtype=torch.float32):
    """Plain version of K15: ``infl[b, p, h, k] = f_sigma(|s[nbr(p, h)] - q[p]
    - kp_k|)``, 0 for sentinel neighbours (``index == Ns``), with the squared
    distance expanded as ``|rel|^2 - 2 rel.kp + |kp|^2`` and clamped at 0 (the
    port's host influence); ``f`` is linear ``max(1 - d / sigma, 0)``,
    constant 1 or gaussian ``exp(-d^2 / (2 (0.3 sigma)^2))``.

    q_points (B, Nq, 3), s_points (B, Ns, 3) float32; neighbor_indices
    (B, Nq, H); kernel_points (K, 3).  Returns (infl (B, Nq, H, K) in
    ``out_dtype``, inf_sum (B, Nq, K) float32 = the sum over h of the
    float32 weights)."""
    if mode not in INFLUENCE_MODES:
        raise ValueError(f"unknown influence mode {mode!r}")
    rel = batched_gather_rows(s_points.float(), neighbor_indices) \
        - q_points.float()[:, :, None, :]  # (B, Nq, H, 3)
    kp = kernel_points.float()
    sq = ((rel * rel).sum(dim=-1, keepdim=True) - 2.0 * (rel @ kp.T)
          + (kp * kp).sum(dim=-1)).clamp_min(0.0)
    if mode == "linear":
        w = (1.0 - torch.sqrt(sq) / sigma).clamp_min(0.0)
    elif mode == "constant":
        w = torch.ones_like(sq)
    else:
        w = torch.exp(-sq / (2.0 * (sigma * 0.3) ** 2))
    w = w * (neighbor_indices < s_points.shape[1])[..., None]
    return w.to(out_dtype), w.sum(dim=2)


def influence(q_points: torch.Tensor, s_points: torch.Tensor, neighbor_indices: torch.Tensor,
              kernel_points: torch.Tensor, *, sigma: float, mode: str = "linear",
              out_dtype=torch.float32):
    """K15 (``csrc/influence.cu``, replaces the TPU
    ``influence_windowed_pallas``): see :func:`influence_plain`; ``out_dtype``
    bf16 or float32.  Geometry: no gradient.  Bound by device memory (the
    (B, Nq, H, K) output); the source notes the design."""
    if mode not in INFLUENCE_MODES:
        raise ValueError(f"unknown influence mode {mode!r}")
    if q_points.device.type == "cpu":
        return influence_plain(q_points, s_points, neighbor_indices, kernel_points,
                               sigma=sigma, mode=mode, out_dtype=out_dtype)
    if q_points.device.type != "cuda":
        raise ValueError(f"unsupported device {q_points.device}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"unsupported influence dtype {out_dtype}")
    b, nq, h = neighbor_indices.shape
    k = kernel_points.shape[0]
    if (q_points.shape != (b, nq, 3) or s_points.ndim != 3 or s_points.shape[0] != b
            or s_points.shape[2] != 3 or kernel_points.shape != (k, 3)):
        raise ValueError("bad influence input shapes")
    if any(t.device != q_points.device for t in (s_points, neighbor_indices, kernel_points)):
        raise ValueError("influence inputs on different devices")
    q = q_points.float().contiguous()
    sp = s_points.float().contiguous()
    nbr = neighbor_indices.to(torch.int32).contiguous()
    kp = kernel_points.float().contiguous()
    infl = torch.empty((b, nq, h, k), dtype=out_dtype, device=q.device)
    inf_sum = torch.empty((b, nq, k), dtype=torch.float32, device=q.device)
    fn = _build.function("influence", f"se3et_influence_{_DTYPES[out_dtype]}", 6, 6, 1)
    _build.check(fn(q.data_ptr(), sp.data_ptr(), nbr.data_ptr(), kp.data_ptr(),
                    infl.data_ptr(), inf_sum.data_ptr(), b, nq, sp.shape[1], h, k,
                    INFLUENCE_MODES[mode], float(sigma),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "influence launch")
    influence.launches += 1
    return infl, inf_sum


influence.launches = 0
