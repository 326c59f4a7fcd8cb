r"""Flash RPE self-attention kernel (K5).

Counterpart of ``se3et_tpu/ops/pallas/rpe_attention.py``
(``rpe_self_attention`` -> ``_rpe_fwd``).  One softmax attention over the
coarse stage with the geometric embedding's positional term and,
optionally, the degree-1 spherical-harmonics term of the equivariant
layers, without materialising the (B, AH, N, M) scores:

    s[b, ah, n, m] = scale * (q[b,ah,n] . k[b,ah,m]
                              + qp[b,n,ah] . emb[b,n,m]
                              + rinv(n, m) * qw[b,:,ah,n] . (p_n - p_m)_yzx)
    out[b, ah, n]  = sum_m softmax_m(s) v[b, ah, m]

Every projection is folded into the query outside (``qp = q @ Wp^T``; the
anchors' Wigner-D blocks into ``qw``, :func:`fold_equivariant_query`), and
row-constant terms (projection biases, the degree-0 SH term) are left out:
a per-query constant is a softmax no-op.  ``rinv = sqrt(3/4pi) / (r +
1e-12)`` with ``r = |p_n - p_m|``, set to 0 where ``n == m`` by index.
Keys with ``k_masks`` False are masked before the exp, and the softmax
weights are cast to ``v``'s dtype before the value product, as the TPU
kernel does.  The kernel (``csrc/rpe_attention.cu``) reads each embedding
row once for all anchor-heads; its source notes the design, and
:func:`rpe_attention_form` names the kernel a shape takes.

Training differentiates through it (:func:`rpe_self_attention` under
autograd): the forward also returns the row log-sum-exp, and the backward
is kernel K11 (:func:`rpe_attention_bwd`, ``csrc/rpe_attention_bwd.cu``,
replaces the TPU ``_rpe_bwd``), which recomputes the softmax P and forms
``dS = P * (dO . v^T - rowsum(dO * out))``.  Its bf16 form ("tc",
``csrc/rpe_attention_bwd_tc.cuh``, :func:`rpe_attention_bwd_form`) also
forms dqp, d_emb and dqw on the tensor cores, reading the embedding once,
and leaves dq, dk and dv to matrix products over its bf16 P and dS; the
first design ("cuda": float32, other widths) leaves every contraction to
matmuls over float32 P and dS, as the JAX package runs them as XLA
einsums.  Gradients flow to q, k, v, qp, emb and qw, in their own dtypes.

:func:`rpe_self_attention_femb` (K16, ``csrc/rpe_attention_femb.cu``,
replaces the TPU ``rpe_self_attention_femb``; serving only) is the same
attention with the embedding rows recomputed inside the kernel from the
coordinates (K3's function without its biases, which are softmax no-ops),
so the (B, N, N, C) embedding is never written; its bf16 serving form
("ws", ``csrc/rpe_attention_femb_ws.cuh``) builds each 32-key tile of a
row's embedding on the tensor cores and contracts it at once, beside K5's
flash warps.
"""

from __future__ import annotations

import math

import torch

from se3et_tpu_torch.ops.geometry import pairwise_distance
from se3et_tpu_torch.ops.kernels import _build, embedding

_NEG = -1e9
SH1_C = math.sqrt(3.0 / (4.0 * math.pi))  # real_sh degree-1 coefficient
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
KERNEL_AH = (4, 24)  # anchor-heads per launch the kernel is built for
# head widths of the forward kernels K5 and K16 (32: the wide-head family
# se3ete2 / se3eti2, on the CUDA-core form) and of the backward K11
KERNEL_HEAD_DIMS = (16, 32, 64)
BWD_HEAD_DIMS = (16, 64)
SMEM_LIMIT = 232448  # dynamic shared memory one block can have on Hopper, bytes
# the ws form's plan (csrc/rpe_attention_ws.cuh): query rows per block, keys
# per tile, flash warps
WS_ROWS, WS_KEYS, WS_FLASH_WARPS = 16, 32, 8


def ws_slots(ah: int) -> int:
    """Embedding slabs in the ws form's ring, one per positional warp."""
    return 3 if ah >= WS_FLASH_WARPS else 5


def ws_smem_bytes(ah: int, hc: int, cc: int) -> int:
    """Shared memory of K5's ws form at (AH, head width, C), in bytes, as
    ``rpe_ws::Layout<AH, HC>::bytes`` lays it out: the ring of
    :func:`ws_slots` slots (an embedding slab of 32 keys and the row's
    folded queries), two float32 score buffers (rows padded to AH * 32 + 8 floats),
    a v tile per flash warp (rows of hc + 8 bf16), the block's SH queries
    and 2 * slots + 4 mbarriers."""
    split = 1 if ah >= WS_FLASH_WARPS else WS_FLASH_WARPS // ah  # flash warps per head
    slots = ws_slots(ah)
    ring = slots * (WS_KEYS + ah) * cc * 2  # a slot: 32 embedding rows and qp[b, n]
    scores = 2 * WS_ROWS * (ah * WS_KEYS + 8) * 4
    vtiles = WS_FLASH_WARPS * (WS_KEYS // split) * (hc + 8) * 2
    qw = WS_ROWS * 3 * ah * 4
    return ring + scores + vtiles + qw + (2 * slots + 4) * 8


def femb_ws_groups(ah: int) -> int:
    """(Key tile, query row) items K16's ws form keeps in flight, a group of
    positional warps each: 4 pairs of warps (a 16-key m-tile each) at AH =
    24 beside K5's 8 flash warps, 12 single warps at AH = 4 beside 4 flash
    warps, one a head."""
    return 4 if ah >= WS_FLASH_WARPS else 12


def femb_ws_smem_bytes(ah: int, hc: int, cc: int) -> int:
    """Shared memory of K16's ws form at (AH, head width, C), in bytes, as
    ``femb_ws::Layout<AH, HC>::bytes`` lays it out: G resident (C rows of
    72 bf16); per group (:func:`femb_ws_groups`) 32 basis rows of 104 bf16
    and a ring of 4 chunks of qp (AH x 32 bf16); then K5's two
    float32 score buffers (:func:`ws_smem_bytes`), a v tile of 32 keys per
    flash warp (8 at AH = 24, 4 at AH = 4), the block's SH queries, 16 rows'
    geometry (16 floats each) and 4 mbarriers."""
    flash = WS_FLASH_WARPS if ah >= WS_FLASH_WARPS else 4  # one or more heads a warp
    g = cc * 72 * 2
    basis = femb_ws_groups(ah) * WS_KEYS * 104 * 2
    qp = femb_ws_groups(ah) * 4 * ah * 32 * 2
    scores = 2 * WS_ROWS * (ah * WS_KEYS + 8) * 4
    vtiles = flash * WS_KEYS * (hc + 8) * 2
    qw = WS_ROWS * 3 * ah * 4
    rowgeo = WS_ROWS * 16 * 4
    return g + basis + qp + scores + vtiles + qw + rowgeo + 4 * 8


def cuda_smem_bytes(ah: int, cc: int) -> int:
    """Shared memory of the CUDA-core form (``rpe::launch``): 8 query rows'
    AH folded queries as float32 and their 32 softmax weights."""
    return 8 * ah * (cc + 32) * 4


def rpe_attention_form(ah: int, hc: int, cc: int, dtype, *, femb: bool = False) -> str:
    """Which hand-written kernel takes a flash RPE self-attention of AH
    anchor-heads, head width ``hc`` and embedding width ``cc`` in ``dtype``:

    * "ws": in bf16 with head width 64 and C % 32 == 0, where the plan fits
      a block, the warp-specialised serving form: K5's
      (``csrc/rpe_attention_ws.cuh``, :func:`ws_smem_bytes`) or, with
      ``femb``, K16's (``csrc/rpe_attention_femb_ws.cuh``,
      :func:`femb_ws_smem_bytes`);
    * "cuda": the CUDA-core kernel (float32, and head widths 16 and 32 in
      either type).

    Chosen by shape alone, as the C entry points choose; none is a
    fallback of another.  Raises ``ValueError`` where no form takes the
    shape."""
    if dtype not in _DTYPES or ah not in KERNEL_AH or hc not in KERNEL_HEAD_DIMS or cc % 16:
        raise ValueError(f"no flash RPE kernel for AH={ah}, head width {hc}, C={cc}, {dtype}: "
                         f"built for AH in {KERNEL_AH}, head width in {KERNEL_HEAD_DIMS}, "
                         f"C % 16 == 0, bf16 or float32")
    if dtype == torch.bfloat16 and hc == 64 and cc % 32 == 0:
        plan = femb_ws_smem_bytes if femb else ws_smem_bytes
        if plan(ah, hc, cc) <= SMEM_LIMIT:
            return "ws"
    if femb or cuda_smem_bytes(ah, cc) <= SMEM_LIMIT:
        return "cuda"
    raise ValueError(f"no flash RPE kernel fits AH={ah}, C={cc} in {dtype}: the CUDA-core "
                     f"form needs {cuda_smem_bytes(ah, cc)} bytes of shared memory")


# K11's tc form (csrc/rpe_attention_bwd_tc.cuh): query rows per block, keys
# per tile, and the one head width and embedding width it is built for
BWD_TC_ROWS, BWD_TC_KEYS, BWD_TC_HC, BWD_TC_C = 4, 32, 64, 256


def bwd_tc_smem_bytes(ah: int, hc: int, cc: int) -> int:
    """Shared memory of K11's tc form at (AH, head width, C), in bytes, as
    ``rpe_bwd_tc::Layout<AH>::bytes`` lays it out, 0 where it is not built
    (head width 64 and C = 256 only, AH 4 or 24): two buffers of the
    block's 4 rows' 32-key embedding slabs, the rows' folded queries qp (AH
    padded to a multiple of 8), their q and dO (bf16), the positional
    scores (float32, [AH][4 x 36 + 4]), dS' (bf16, [4][AH padded][40]), the
    SH geometry (4 x 32 float4), the SH queries and the row statistics lse
    and D."""
    if hc != BWD_TC_HC or cc != BWD_TC_C or ah not in KERNEL_AH:
        return 0
    ahp = -(-ah // 8) * 8
    rows, keys = BWD_TC_ROWS, BWD_TC_KEYS
    return (2 * rows * keys * cc * 2 + rows * ahp * cc * 2 + 2 * ah * rows * hc * 2
            + ah * (rows * 36 + 4) * 4 + rows * ahp * 40 * 2 + rows * keys * 16
            + rows * 3 * ah * 4 + 2 * ah * rows * 4)


def bwd_cuda_smem_bytes(ah: int, cc: int) -> int:
    """Shared memory of K11's first design: 8 query rows' AH folded queries
    as float32."""
    return 8 * ah * cc * 4


def rpe_attention_bwd_form(ah: int, hc: int, cc: int, dtype) -> str:
    """Which hand-written kernel takes K11 at AH anchor-heads, head width
    ``hc`` and embedding width ``cc`` in ``dtype``:

    * "tc": in bf16 where :func:`bwd_tc_smem_bytes` names a plan that fits
      a block (head width 64, C = 256: the training shapes), the
      tensor-core form (``csrc/rpe_attention_bwd_tc.cuh``);
    * "cuda": the first design (float32, and bf16 at the other widths).

    Chosen by shape alone, as the C entry points choose; neither is a
    fallback of the other.  Raises ``ValueError`` where no form takes the
    shape: K11 is built for head widths :data:`BWD_HEAD_DIMS` (not 32,
    whose forward K5 takes)."""
    if dtype not in _DTYPES or ah not in KERNEL_AH or hc not in BWD_HEAD_DIMS or cc % 16:
        raise ValueError(f"no K11 kernel for AH={ah}, head width {hc}, C={cc}, {dtype}: "
                         f"built for AH in {KERNEL_AH}, head width in {BWD_HEAD_DIMS}, "
                         f"C % 16 == 0, bf16 or float32")
    if dtype == torch.bfloat16 and 0 < bwd_tc_smem_bytes(ah, hc, cc) <= SMEM_LIMIT:
        return "tc"
    if bwd_cuda_smem_bytes(ah, cc) <= SMEM_LIMIT:
        return "cuda"
    raise ValueError(f"no K11 kernel fits AH={ah}, C={cc} in {dtype}: the first design "
                     f"needs {bwd_cuda_smem_bytes(ah, cc)} bytes of shared memory")


def fold_equivariant_query(qe: torch.Tensor, wigner_d1: torch.Tensor) -> torch.Tensor:
    """Fold the anchors' Wigner-D degree-1 blocks into the SH query.

    qe: (B, A, H, N, 4) -- ``q @ We^T`` for n_level_equiv=2 (column 0, the
    degree-0 coefficient, is dropped as row-constant); wigner_d1 (A, 3, 3).
    Returns (B, 3, A*H, N) float32, component rows in the (y, z, x) order of
    the degree-1 ``real_sh`` layout."""
    b, a, h, n, _ = qe.shape
    qw = torch.einsum("acd,bahnc->bdahn", wigner_d1.float(), qe[..., 1:4].float())
    return qw.reshape(b, 3, a * h, n)


def point_rows(points: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points -> the (B, 3, N) float32 coordinate rows (x, y, z)
    the kernel reads."""
    return points.float().transpose(1, 2).contiguous()


def _sh_geometry(points, n0, n1):
    """(rinv (B, R, N) with the diagonal zeroed by index, (p_n - p_m) in the
    (y, z, x) order (B, 3, R, N)) for query rows n0:n1."""
    p = points[:, :3].float()  # (B, 3, N) rows x, y, z
    d = p[:, :, n0:n1, None] - p[:, :, None, :]  # (B, 3, R, N): p_n - p_m
    r = torch.sqrt((d * d).sum(dim=1))  # (B, R, N)
    rinv = SH1_C / (r + 1e-12)
    idx = torch.arange(n0, n1, device=p.device)
    rinv[:, idx - n0, idx] = 0.0
    return rinv, d[:, (1, 2, 0)]


def sh_term(qw, points, n0, n1):
    """rinv(n, m) * qw . (p_n - p_m)_yzx for query rows n0:n1: (B, AH, R, N)."""
    rinv, dyzx = _sh_geometry(points, n0, n1)
    pre = torch.einsum("bdan,bdnm->banm", qw[..., n0:n1].float(), dyzx)
    return rinv[:, None] * pre


def _scores(q, k, qp, emb_rows, k_masks, qw, points, n0, n1, scale):
    """Scaled, masked float32 scores of query rows n0:n1 (B, AH, R, N);
    emb_rows (B, R, N, C) are the embedding rows n0:n1."""
    s = torch.einsum("banc,bamc->banm", q[:, :, n0:n1].float(), k.float())
    s = s + torch.einsum("bnad,bnmd->banm", qp[:, n0:n1].float(), emb_rows.float())
    if qw is not None:
        s = s + sh_term(qw, points, n0, n1)
    return torch.where(k_masks[:, None, None, :], s * scale, _NEG)


def rpe_self_attention_plain(q, k, v, qp, emb, k_masks, qw=None, points=None, *,
                             scale, row_block=128, with_lse=False):
    """Plain version of K5, in float32 from the given inputs.

    q, k, v: (B, AH, N, c); qp: (B, N, AH, C); emb: (B, N, N, C);
    k_masks: (B, N) bool (True = valid key); qw: (B, 3, AH, N) or None;
    points: (B, 3|4, N) coordinate rows, needed with ``qw``.
    Returns (B, AH, N, c) float32 and, with ``with_lse``, the row
    log-sum-exp (B, AH, N) of the scaled, masked scores.  Query rows are
    taken ``row_block`` at a time to bound the float32 copies of the
    embedding.
    """
    return _attend_rows(q, k, v, qp, lambda n0, n1: emb[:, n0:n1], k_masks, qw, points,
                        scale, row_block, with_lse)


def _attend_rows(q, k, v, qp, emb_rows, k_masks, qw, points, scale, row_block, with_lse):
    """K5's plain attention with the embedding rows n0:n1 from ``emb_rows(n0, n1)``."""
    b, ah, n, c = q.shape
    vf = v.float()
    km = k_masks[:, None, None, :]
    out = torch.empty((b, ah, n, c), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, ah, n), dtype=torch.float32, device=q.device)
    for n0 in range(0, n, row_block):
        n1 = min(n, n0 + row_block)
        s = _scores(q, k, qp, emb_rows(n0, n1), k_masks, qw, points, n0, n1, scale)
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mx) * km
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        pv = torch.einsum("banm,bamc->banc", p.to(v.dtype).float(), vf)
        out[:, :, n0:n1] = pv / denom
        lse[:, :, n0:n1] = (mx + torch.log(denom))[..., 0]
    return (out, lse) if with_lse else out


def _grads_from_p_ds(p, ds, q, k, qp, emb, qw, points, dout, scale, row_block=128):
    """dq, dk, dv, dqp, d_emb, dqw from the recomputed softmax P and dS
    (B, AH, N, N) float32: the contractions of the JAX ``_rpe_bwd``, in
    float32, query rows ``row_block`` at a time for the embedding-sized
    ones.  Each gradient is returned in its input's dtype (dqw float32)."""
    b, ah, n, _ = q.shape
    do32 = dout.float()
    dv = torch.einsum("banm,banc->bamc", p, do32)
    dk = scale * torch.einsum("banm,banc->bamc", ds, q.float())
    dq = scale * torch.einsum("banm,bamc->banc", ds, k.float())
    dqp = torch.empty(qp.shape, dtype=torch.float32, device=q.device)
    demb = torch.empty_like(emb)
    dqw = None if qw is None else torch.empty(qw.shape, dtype=torch.float32, device=q.device)
    for n0 in range(0, n, row_block):
        n1 = min(n, n0 + row_block)
        ds_r = ds[:, :, n0:n1]
        dqp[:, n0:n1] = scale * torch.einsum("banm,bnmd->bnad", ds_r, emb[:, n0:n1].float())
        demb[:, n0:n1] = (scale * torch.einsum("banm,bnad->bnmd", ds_r,
                                               qp[:, n0:n1].float())).to(emb.dtype)
        if qw is not None:
            rinv, dyzx = _sh_geometry(points, n0, n1)
            dqw[..., n0:n1] = scale * torch.einsum("banm,bdnm->bdan", ds_r * rinv[:, None],
                                                   dyzx)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(q.dtype), dqp.to(qp.dtype), demb, dqw)


def rpe_attention_bwd_plain(q, k, v, qp, emb, k_masks, qw, points, dout, out, lse, *,
                            scale, row_block=128):
    """Plain version of K11 and the contractions after it: the gradients
    (dq, dk, dv, dqp, d_emb, dqw) of :func:`rpe_self_attention_plain` for
    the cotangent ``dout``, from the saved float32 ``out`` and row
    log-sum-exp ``lse``; ``dqw`` is None without the SH term."""
    b, ah, n, _ = q.shape
    km = k_masks[:, None, None, :]
    dd = (dout.float() * out).sum(dim=-1)  # (B, AH, N)
    p = torch.empty((b, ah, n, n), dtype=torch.float32, device=q.device)
    ds = torch.empty_like(p)
    for n0 in range(0, n, row_block):
        n1 = min(n, n0 + row_block)
        s = _scores(q, k, qp, emb[:, n0:n1], k_masks, qw, points, n0, n1, scale)
        pr = torch.exp(s - lse[:, :, n0:n1, None]) * km
        dpv = torch.einsum("banc,bamc->banm", dout[:, :, n0:n1].float(), v.float())
        p[:, :, n0:n1] = pr
        ds[:, :, n0:n1] = pr * (dpv - dd[:, :, n0:n1, None])
    return _grads_from_p_ds(p, ds, q, k, qp, emb, qw, points, dout, scale)


def _check_inputs(q, k, v, qp, emb, k_masks, qw, points, cc=None):
    """Checks of K5, K11 and K16 (``emb`` None and its width ``cc`` for K16;
    K11's head widths by :func:`rpe_attention_bwd_form`)."""
    b, ah, n, c = q.shape
    cc = emb.shape[-1] if emb is not None else cc
    dtype = q.dtype
    if dtype not in _DTYPES or any(t is not None and t.dtype != dtype for t in (k, v, qp, emb)):
        raise TypeError("q, k, v, qp and emb must share one dtype, bf16 or float32")
    if (k.shape != q.shape or v.shape != q.shape or qp.shape != (b, n, ah, cc)
            or (emb is not None and emb.shape != (b, n, n, cc)) or k_masks.shape != (b, n)):
        raise ValueError("bad rpe_self_attention input shapes")
    if ah not in KERNEL_AH or c not in KERNEL_HEAD_DIMS or cc % 16:
        raise ValueError(f"K5/K16 are built for AH in {KERNEL_AH}, head width in "
                         f"{KERNEL_HEAD_DIMS} and C % 16 == 0, got {ah}, {c}, {cc}")
    if qw is not None:
        if qw.shape != (b, 3, ah, n) or points is None or points.shape[:1] != (b,) \
                or points.shape[1] not in (3, 4) or points.shape[2] != n:
            raise ValueError("qw must be (B, 3, AH, N) with points (B, 3|4, N)")


def _rpe_forward(q, k, v, qp, emb, k_masks, qw, points, scale, with_lse):
    if q.device.type == "cpu":
        return rpe_self_attention_plain(q, k, v, qp, emb, k_masks, qw, points, scale=scale,
                                        with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_inputs(q, k, v, qp, emb, k_masks, qw, points)
    b, ah, n, c = q.shape
    # raises where no form takes the shape; the C entry point launches the
    # same form
    rpe_attention_form(ah, c, emb.shape[-1], q.dtype)
    with_sh = qw is not None
    if with_sh:
        qw = qw.float().contiguous()
        points = points.float().contiguous()
    q, k, v, qp, emb = (t.contiguous() for t in (q, k, v, qp, emb))
    km = k_masks.to(torch.uint8).contiguous()
    out = torch.empty((b, ah, n, c), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, ah, n), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.function("rpe_attention", f"se3et_rpe_attention_{_DTYPES[q.dtype]}", 10, 6, 1)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), emb.data_ptr(),
                    km.data_ptr(), qw.data_ptr() if with_sh else None,
                    points.data_ptr() if with_sh else None, out.data_ptr(),
                    lse.data_ptr() if with_lse else None,
                    b, ah, n, c, emb.shape[-1], points.shape[1] if with_sh else 0,
                    float(scale), torch.cuda.current_stream(q.device).cuda_stream),
                 "rpe_self_attention launch")
    rpe_self_attention.launches += 1
    return (out, lse) if with_lse else out


class _RPESelfAttention(torch.autograd.Function):
    """K5 forward (with row log-sum-exp), K11 backward."""

    @staticmethod
    def forward(ctx, q, k, v, qp, emb, k_masks, qw, points, scale):
        out, lse = _rpe_forward(q, k, v, qp, emb, k_masks, qw, points, scale, True)
        ctx.save_for_backward(q, k, v, qp, emb, k_masks, qw, points, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qp, emb, k_masks, qw, points, out, lse = ctx.saved_tensors
        dq, dk, dv, dqp, demb, dqw = rpe_attention_bwd(
            q, k, v, qp, emb, k_masks, qw, points, dout, out, lse, scale=ctx.scale)
        return dq, dk, dv, dqp, demb, None, dqw, None, None


def rpe_self_attention(q, k, v, qp, emb, k_masks, qw=None, points=None, *, scale):
    """K5 (``csrc/rpe_attention.cu``, replaces the TPU ``rpe_self_attention``):
    see :func:`rpe_self_attention_plain`.  The kernel is the one
    :func:`rpe_attention_form` names (serving in bf16: "ws"); a shape no
    form takes raises ``ValueError``.  Bound by the embedding's bytes; the
    source notes the design.  Differentiable in q, k, v, qp, emb and qw
    (backward K11, :func:`rpe_attention_bwd`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, qp, emb, qw)):
        return _RPESelfAttention.apply(q, k, v, qp, emb, k_masks, qw, points, scale)
    return _rpe_forward(q, k, v, qp, emb, k_masks, qw, points, scale, False)


rpe_self_attention.launches = 0


def rpe_self_attention_with_lse(q, k, v, qp, emb, k_masks, qw=None, points=None, *, scale):
    """K5's forward with its row log-sum-exp output, (out, lse) (no autograd)."""
    return _rpe_forward(q, k, v, qp, emb, k_masks, qw, points, scale, True)


def rpe_attention_bwd(q, k, v, qp, emb, k_masks, qw, points, dout, out, lse, *, scale):
    """K11 (``csrc/rpe_attention_bwd.cu``, replaces the TPU ``_rpe_bwd``):
    the gradients of :func:`rpe_attention_bwd_plain`, on the form
    :func:`rpe_attention_bwd_form` names.  In bf16 ("tc") the kernel
    recomputes P and dS, forms dqp, d_emb and dqw, and writes P and scale *
    dS in bf16, from which dq, dk and dv are three matrix products (P, dS
    and dO rounded to bf16 before each product, float32 sums); the first
    design writes P and dS in float32 and runs every contraction as a
    matmul.  Bound by the embedding's bytes, read once, and d_emb's; the
    sources note the designs."""
    return _rpe_attention_bwd(q, k, v, qp, emb, k_masks, qw, points, dout, out, lse, scale)


def _rpe_attention_bwd(q, k, v, qp, emb, k_masks, qw, points, dout, out, lse, scale,
                       form=None):
    """K11 on the form :func:`rpe_attention_bwd_form` names, or on ``form``
    where the caller asks for one that takes the shape ("cuda" takes every
    shape the check below lets through)."""
    if q.device.type == "cpu":
        return rpe_attention_bwd_plain(q, k, v, qp, emb, k_masks, qw, points, dout, out,
                                       lse, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_inputs(q, k, v, qp, emb, k_masks, qw, points)
    b, ah, n, c = q.shape
    # raises before any launch where K11 is not built for the shape (head
    # width 32 among them), whichever form the caller names
    named = rpe_attention_bwd_form(ah, c, emb.shape[-1], q.dtype)
    if dout.shape != q.shape or out.shape != q.shape or lse.shape != (b, ah, n):
        raise ValueError("bad rpe_attention_bwd gradient shapes")
    if out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError("rpe_attention_bwd takes K5's float32 output and row log-sum-exp")
    form = form or named
    with_sh = qw is not None
    qwc = qw.float().contiguous() if with_sh else None
    ptsc = points.float().contiguous() if with_sh else None
    qc, kc, vc, qpc, embc = (t.contiguous() for t in (q, k, v, qp, emb))
    km = k_masks.to(torch.uint8).contiguous()
    do32 = dout.float().contiguous()
    dd = (do32 * out).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if form == "tc":
        do_b = dout.to(torch.bfloat16).contiguous()
        p = torch.empty((b, ah, n, n), dtype=torch.bfloat16, device=q.device)
        ds = torch.empty_like(p)
        dqp, demb = torch.empty_like(qpc), torch.empty_like(embc)
        dqw = torch.zeros(qw.shape, dtype=torch.float32, device=q.device) if with_sh else None
        fn = _build.function("rpe_attention_bwd", "se3et_rpe_attention_bwd_tc_bf16", 16, 6, 1)
        _build.check(fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), qpc.data_ptr(),
                        embc.data_ptr(), km.data_ptr(), qwc.data_ptr() if with_sh else None,
                        ptsc.data_ptr() if with_sh else None, do_b.data_ptr(), lse.data_ptr(),
                        dd.data_ptr(), p.data_ptr(), ds.data_ptr(), dqp.data_ptr(),
                        demb.data_ptr(), dqw.data_ptr() if with_sh else None, b, ah, n, c,
                        emb.shape[-1], ptsc.shape[1] if with_sh else 0, float(scale), stream),
                     "rpe_attention_bwd launch (tc)")
        rpe_attention_bwd.launches += 1
        # ds holds scale * dS
        dq = torch.matmul(ds, kc)
        dk = torch.matmul(ds.transpose(-1, -2), qc)
        dv = torch.matmul(p.transpose(-1, -2), do_b)
        return dq, dk, dv, dqp, demb, dqw
    p = torch.empty((b, ah, n, n), dtype=torch.float32, device=q.device)
    ds = torch.empty_like(p)
    fn = _build.function("rpe_attention_bwd",
                         f"se3et_rpe_attention_bwd_{_DTYPES[q.dtype]}", 13, 6, 1)
    _build.check(fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), qpc.data_ptr(),
                    embc.data_ptr(), km.data_ptr(), qwc.data_ptr() if with_sh else None,
                    ptsc.data_ptr() if with_sh else None, do32.data_ptr(), lse.data_ptr(),
                    dd.data_ptr(), p.data_ptr(), ds.data_ptr(), b, ah, n, c, emb.shape[-1], ptsc.shape[1] if with_sh else 0, float(scale), stream),
                 "rpe_attention_bwd launch")
    rpe_attention_bwd.launches += 1
    return _grads_from_p_ds(p, ds, q, k, qp, emb, qw, points, dout, scale)


rpe_attention_bwd.launches = 0


def _femb_rows(pts3, knn_points, gd, ga, n0, n1, inv_d, dtype):
    """Embedding rows n0:n1 (B, R, N, C) as K16 builds them, float32 holding
    ``dtype`` values: K3's distance and triplet angles (0 on the diagonal,
    by index), their Chebyshev bases and G rounded to ``dtype``, products
    summed in float32, the angle max rounded to ``dtype``, then the row."""
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    dist = torch.sqrt(pairwise_distance(pts3[:, n0:n1], pts3))  # (B, R, N)
    ang = embedding._pair_geometry(pts3, knn_points, n0, n1)  # (B, R, N, k)
    idx = torch.arange(n0, n1, device=pts3.device)
    dist[:, idx - n0, idx] = 0.0
    ang[:, idx - n0, idx] = 0.0
    d = rnd(embedding._cheb_basis(dist, inv_d, gd.shape[0])) @ rnd(gd)
    a = (rnd(embedding._cheb_basis(ang, 2.0 / math.pi, ga.shape[0])) @ rnd(ga)).amax(dim=3)
    return rnd(d + rnd(a))


def rpe_self_attention_femb_plain(q, k, v, qp, k_masks, qw, points, knn_points, wd, wa, *,
                                  scale, sigma_d, sigma_a, row_block=128):
    """Plain version of K16: :func:`rpe_self_attention_plain` over the
    embedding ``T_d(dist) @ Gd + max_k T_a(angle_k) @ Ga`` (K3's without its
    biases), built ``row_block`` query rows at a time (the (B, N, N, C)
    tensor is never held), in q's dtype as K16 rounds it (bf16: bases, G,
    the angle max and each row; float32: nothing rounded).

    Arguments as K5's minus ``emb``; ``points`` (B, 3|4, N) coordinate rows
    are required, ``knn_points`` (B, N, angle_k, 3) float32, ``wd``/``wa``
    (C, C) the unfolded projections.  Returns (B, AH, N, c) float32."""
    _, _, gd, ga = embedding._folded_projections(wd, wa, sigma_a)
    pts3 = points[:, :3].float().transpose(1, 2)
    knn = knn_points.float()
    inv_d = 2.0 / (embedding.D_INDEX_MAX * sigma_d)
    return _attend_rows(
        q, k, v, qp, lambda n0, n1: _femb_rows(pts3, knn, gd, ga, n0, n1, inv_d, q.dtype),
        k_masks, qw, points, scale, row_block, False)


def _femb_tables(wd, wa, sigma_a, dtype):
    """(deg_d, deg_a, g (64, C) float32 rows [Gd | 0 | Ga] rounded to
    ``dtype``, its (C, 64) bf16 transpose for the ws form or None): the
    distance basis padded to 48 rows, three k-steps of 16."""
    deg_d, deg_a, gd, ga = embedding._folded_projections(wd, wa, sigma_a)
    if (deg_d, deg_a) != (40, 16):
        raise ValueError(f"K16 is built for 40 distance and 16 angle basis terms, got "
                         f"{deg_d} and {deg_a}")
    g = torch.zeros((64, gd.shape[1]), dtype=torch.float32, device=gd.device)
    g[:40] = gd
    g[48:] = ga
    g = g.to(dtype).float()
    gt = embedding.tc_table(gd, ga) if dtype == torch.bfloat16 else None
    return deg_d, deg_a, g, gt


def rpe_self_attention_femb(q, k, v, qp, k_masks, qw, points, knn_points, wd, wa, *,
                            scale, sigma_d, sigma_a):
    """K16 (``csrc/rpe_attention_femb.cu``, replaces the TPU
    ``rpe_self_attention_femb``): see :func:`rpe_self_attention_femb_plain`.
    Serving only: inputs that require grad raise, as the TPU kernel has no
    VJP.  The kernel is the one :func:`rpe_attention_form` names with
    ``femb`` (serving in bf16: "ws").  Bound by the tensor-core operations
    of the in-kernel projections; the source notes the design."""
    if any(t is not None and t.requires_grad for t in (q, k, v, qp, qw, wd, wa)) \
            and torch.is_grad_enabled():
        raise ValueError("rpe_self_attention_femb has no backward (serving only)")
    if q.device.type == "cpu":
        return rpe_self_attention_femb_plain(q, k, v, qp, k_masks, qw, points, knn_points,
                                             wd, wa, scale=scale, sigma_d=sigma_d,
                                             sigma_a=sigma_a)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, ah, n, c = q.shape
    cc = wd.shape[1]
    ka = knn_points.shape[2]
    if points is None or points.shape[:1] != (b,) or points.shape[1] not in (3, 4) \
            or points.shape[2] != n or knn_points.shape != (b, n, ka, 3):
        raise ValueError("rpe_self_attention_femb takes points (B, 3|4, N) and knn_points "
                         "(B, N, k, 3)")
    _check_inputs(q, k, v, qp, None, k_masks, qw, points, cc=cc)
    rpe_attention_form(ah, c, cc, q.dtype, femb=True)  # raises where no form takes it
    deg_d, deg_a, g, gt = _femb_tables(wd, wa, sigma_a, q.dtype)
    with_sh = qw is not None
    qwc = qw.float().contiguous() if with_sh else None
    pts = points.float().contiguous()
    pts3 = points[:, :3].float().transpose(1, 2).contiguous()
    knn = knn_points.float().contiguous()
    q, k, v, qp = (t.contiguous() for t in (q, k, v, qp))
    km = k_masks.to(torch.uint8).contiguous()
    out = torch.empty((b, ah, n, c), dtype=torch.float32, device=q.device)
    fn = _build.function("rpe_attention_femb", f"se3et_rpe_attention_femb_{_DTYPES[q.dtype]}",
                         12, 9, 3)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), km.data_ptr(),
                    qwc.data_ptr() if with_sh else None, pts.data_ptr(), pts3.data_ptr(),
                    knn.data_ptr(), g.data_ptr(), gt.data_ptr() if gt is not None else None,
                    out.data_ptr(), b, ah, n, c, cc, pts.shape[1], deg_d, deg_a, ka,
                    float(scale), 2.0 / (embedding.D_INDEX_MAX * sigma_d), 2.0 / math.pi,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "rpe_self_attention_femb launch")
    rpe_self_attention_femb.launches += 1
    return out


rpe_self_attention_femb.launches = 0
