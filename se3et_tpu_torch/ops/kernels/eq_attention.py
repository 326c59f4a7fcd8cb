r"""Flash equivariant cross-attention kernels (K6 stats, K7 apply).

Counterparts of ``se3et_tpu/ops/pallas/eq_attention.py``
(``eq_attention_stats``, ``eq_attention_apply``).  The EQ cross attention
scores every (query anchor a, key anchor e) pair, ``s_ae = scale q_a . k_e``
of shape (A, E, H, N, M); these two passes never materialise it:

* **stats** (K6): per (a, e, h, n) the softmax row max and sum-exp of the
  key-masked scores, the masked mean over valid (n, m) of
  ``_positive(head-mean s)`` -> ``attn_ae (A, E)``, and optionally the
  masked max of the head-mean of ``s * sup_q[a,h] * sup_k[e,h]`` (the
  rotation-supervision matrix);
* the tiny (A, E) weight math stays in plain torch (``nn/attention.py``);
* **apply** (K7): ``hidden[a] = sum_e w[a,e] softmax_m(s_ae) @ v_e`` with
  the stats of K6, the scores recomputed.

Both kernels live in ``csrc/eq_attention.cu``; its source notes the design.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from se3et_tpu_torch.ops.kernels import _build

_NEG = -1e9
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
POSITIVE_MODES = (None, "sq", "abs", "relu", "sigmoid", "leakyrelu", "softplus", "minus")
KERNEL_HEADS = (4,)
KERNEL_HEAD_DIMS = (16, 32, 64)  # 32: the wide-head family se3ete2, on the CUDA cores
SMEM_LIMIT = 232448  # dynamic shared memory one block can have on Hopper, bytes
# K6's forms (csrc/eq_attention.cu): query rows behind one pooled partial
# slot, and the tc form's plan: keys per staged tile, ring slots, consumer
# warps, query rows per consumer warp (q staged in shared memory)
TC_ROWS, CUDA_ROWS = 16, 8
TC_KEYS, TC_STAGES, TC_CONSUMERS, TC_UNIT_ROWS = 32, 8, 9, 16
# K7's tc form (csrc/eq_attention.cu, eq_tc::kApply*): keys per staged k /
# v tile and ring slots (each a k and a v tile)
APPLY_KEYS, APPLY_STAGES = 64, 4


def _form(kernel: str, h: int, c: int, dtype) -> str:
    if dtype not in _DTYPES or h not in KERNEL_HEADS or c not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no {kernel} kernel for H={h}, head width {c}, {dtype}: built for H in "
                         f"{KERNEL_HEADS}, head width in {KERNEL_HEAD_DIMS}, bf16 or float32")
    return "tc" if dtype == torch.bfloat16 and c == 64 else "cuda"


def eq_attention_stats_form(h: int, c: int, dtype) -> str:
    """Which hand-written K6 kernel takes H heads of width ``c`` in ``dtype``:

    * "tc": bf16, H = 4, head width 64 (the serving form,
      ``eq_tc::eq_stats_tc_kernel``: TMA key tiles, mma.sync, base-2
      softmax);
    * "cuda": the CUDA-core kernel (float32, and head widths 16 and 32 in
      either type).

    Chosen by shape alone, as the C entry point chooses; neither is a
    fallback of the other.  Raises ``ValueError`` where no form takes the
    shape."""
    return _form("K6", h, c, dtype)


def eq_attention_apply_form(h: int, c: int, dtype) -> str:
    """Which hand-written K7 kernel takes H heads of width ``c`` in ``dtype``:

    * "tc": bf16, H = 4, head width 64 (the serving form,
      ``eq_tc::eq_apply_tc_kernel``: TMA key and value tiles of one head,
      wgmma for q k^T and p v, base-2 exps);
    * "cuda": the CUDA-core kernel (float32, and head widths 16 and 32 in
      either type).

    Chosen by shape alone, as the C entry point chooses; neither is a
    fallback of the other.  Raises ``ValueError`` where no form takes the
    shape."""
    return _form("K7", h, c, dtype)


def eq_attention_stats_parts(h: int, n: int, c: int, dtype) -> int:
    """Pooled partial slots per (a, e) that K6 writes for N query rows: one
    per 16-row warp unit in the tc form, one per 8-row block in the CUDA-core
    form (``se3et_eq_attention_stats_parts`` in the C source)."""
    rows = TC_ROWS if eq_attention_stats_form(h, c, dtype) == "tc" else CUDA_ROWS
    return -(-n // rows)


def eq_stats_smem_bytes(m: int) -> int:
    """Shared memory of K6's tc form at M keys, in bytes, as
    ``eq_tc::smem_bytes`` lays it out: 1024 bytes of alignment slack, the
    ring of TC_STAGES key tiles (4 heads x TC_KEYS keys x 64 bf16), each
    consumer warp's q tile (4 heads x TC_UNIT_ROWS rows x 64 bf16), the key
    mask as bits (a whole number of tiles, padded to 8 bytes), 2 x TC_STAGES
    mbarriers and two counts."""
    tiles = -(-m // TC_KEYS)
    mask = (tiles * TC_KEYS // 8 + 7) // 8 * 8
    ring = TC_STAGES * 4 * TC_KEYS * 64 * 2
    q = TC_CONSUMERS * 4 * TC_UNIT_ROWS * 64 * 2
    return 1024 + ring + q + mask + 2 * TC_STAGES * 8 + 8


def eq_apply_smem_bytes(m: int) -> int:
    """Shared memory of K7's tc form at M keys, in bytes, as
    ``eq_tc::apply_smem_bytes`` lays it out: 1024 bytes of alignment slack,
    the ring of APPLY_STAGES slots (a k and a v tile of APPLY_KEYS keys x 64
    bf16 each), the key mask as bits (a whole number of tiles, padded to 8
    bytes) and 2 x APPLY_STAGES mbarriers."""
    tiles = -(-m // APPLY_KEYS)
    mask = (tiles * APPLY_KEYS // 8 + 7) // 8 * 8
    return 1024 + APPLY_STAGES * 2 * APPLY_KEYS * 64 * 2 + mask + 2 * APPLY_STAGES * 8


def _positive(x, mode: Optional[str]):
    """Non-negativity transforms of the global anchor/rotation attention."""
    if mode is None:
        return x
    if mode == "sq":
        return x * x
    if mode == "abs":
        return x.abs()
    if mode == "relu":
        return F.relu(x)
    if mode == "sigmoid":
        return torch.sigmoid(x)
    if mode == "leakyrelu":
        return F.leaky_relu(x, 0.1)
    if mode == "softplus":
        return F.softplus(x)
    if mode == "minus":
        return (x + 1.0) / 2.0
    raise ValueError(mode)


def _scores(q, k):
    """scale * q_a . k_e in float32: (A, E, H, N, M)."""
    return torch.einsum("ahnc,ehmc->aehnm", q.float(), k.float()) / math.sqrt(q.shape[-1])


def eq_attention_stats_plain(q, k, q_masks, k_masks, sup_q=None, sup_k=None, *,
                             positive="sq"):
    """Plain version of K6.

    q: (A, H, N, c); k: (E, H, M, c); masks (N,), (M,) bool (True = valid);
    sup_q (A, H), sup_k (E, H) float32 or None.  Returns (rowmax (A,E,H,N),
    rowsum (A,E,H,N), attn_ae (A,E)[, sup (A,E)]), all float32.
    """
    s = _scores(q, k)
    km = k_masks[None, None, None, None, :]
    sm = s.masked_fill(~km, _NEG)
    rowmax = sm.amax(dim=-1)
    rowsum = (torch.exp(sm - rowmax[..., None]) * km).sum(dim=-1)
    h = q.shape[1]
    pair = (q_masks[:, None] & k_masks[None, :])  # (N, M)
    g = _positive(s.sum(dim=2) * (1.0 / h), positive) * pair
    counts = q_masks.sum().float() * k_masks.sum().float()
    attn_ae = g.sum(dim=(-2, -1)) / (counts + 1e-9)
    if sup_q is None:
        return rowmax, rowsum, attn_ae
    w = sup_q.float().reshape(sup_q.shape[0], 1, h, 1, 1) * sup_k.float().reshape(
        1, sup_k.shape[0], h, 1, 1)
    sup = ((s * w).sum(dim=2) * (1.0 / h)).masked_fill(~pair, _NEG)
    return rowmax, rowsum, attn_ae, sup.amax(dim=(-2, -1))


def eq_attention_apply_plain(q, k, v, w_ae, rowmax, rowsum, k_masks):
    """Plain version of K7: ``hidden[a] = sum_e w_ae[a,e] softmax_m(s_ae) @
    v[e]`` with the row statistics of :func:`eq_attention_stats_plain`.
    q: (A, H, N, c); k, v: (E, H, M, c); w_ae (A, E).  Returns (A, H, N, c)
    float32."""
    km = k_masks[None, None, None, None, :]
    s = _scores(q, k).masked_fill(~km, _NEG)
    p = (torch.exp(s - rowmax[..., None]) * km).to(v.dtype).float()
    o = torch.einsum("aehnm,ehmc->aehnc", p, v.float())
    wi = w_ae.float()[:, :, None, None] / rowsum.clamp_min(1e-30)  # (A, E, H, N)
    return torch.einsum("aehn,aehnc->ahnc", wi, o)


def _check_qk(q, k):
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError("q and k must share one dtype, bf16 or float32")
    if q.ndim != 4 or k.ndim != 4 or k.shape[1] != q.shape[1] or k.shape[3] != q.shape[3]:
        raise ValueError(f"bad q/k shapes {tuple(q.shape)}, {tuple(k.shape)}")


def _check_stats(q, k, q_masks, k_masks, sup_q, sup_k, positive):
    """K6's argument checks, on every device."""
    _check_qk(q, k)
    if positive not in POSITIVE_MODES:
        raise ValueError(f"unknown positive mode {positive!r}")
    if q_masks.shape != (q.shape[2],) or k_masks.shape != (k.shape[2],):
        raise ValueError(f"masks must be (N,), (M,): got {tuple(q_masks.shape)}, "
                         f"{tuple(k_masks.shape)}")
    if (sup_q is None) != (sup_k is None):
        raise ValueError("sup_q and sup_k go together")
    if sup_q is not None and (sup_q.numel() != q.shape[0] * q.shape[1]
                              or sup_k.numel() != k.shape[0] * k.shape[1]):
        raise ValueError("sup_q must hold (A, H) values and sup_k (E, H)")


def _check_apply(q, k, v, w_ae, rowmax, rowsum, k_masks):
    """K7's argument checks, on every device."""
    _check_qk(q, k)
    a, h, n, _ = q.shape
    e, _, m, _ = k.shape
    if v.shape != k.shape or v.dtype != q.dtype:
        raise ValueError("v must match k in shape and q in dtype")
    if w_ae.shape != (a, e) or rowmax.shape != (a, e, h, n) or rowsum.shape != (a, e, h, n):
        raise ValueError(f"w_ae must be (A, E) = {(a, e)} and rowmax/rowsum (A, E, H, N) = "
                         f"{(a, e, h, n)}: got {tuple(w_ae.shape)}, {tuple(rowmax.shape)}, "
                         f"{tuple(rowsum.shape)}")
    if k_masks.shape != (m,):
        raise ValueError(f"k_masks must be (M,) = ({m},): got {tuple(k_masks.shape)}")


def _mask_bytes(masks):
    """A mask as one byte per entry, viewed in place where it is bool."""
    m = masks.view(torch.uint8) if masks.dtype == torch.bool else masks.to(torch.uint8)
    return m.contiguous()


def eq_attention_stats(q, k, q_masks, k_masks, sup_q=None, sup_k=None, *,
                       positive="sq"):
    """K6 (``csrc/eq_attention.cu``, replaces the TPU ``eq_attention_stats``):
    see :func:`eq_attention_stats_plain`.  The kernel is the one
    :func:`eq_attention_stats_form` names (serving in bf16: "tc"); a shape
    no form takes raises ``ValueError``.  The kernel writes every pooled
    partial slot (:func:`eq_attention_stats_parts`); they are reduced here,
    in a fixed order (no atomics).  Bound by its exponentials."""
    _check_stats(q, k, q_masks, k_masks, sup_q, sup_k, positive)
    if q.device.type == "cpu":
        return eq_attention_stats_plain(q, k, q_masks, k_masks, sup_q, sup_k,
                                        positive=positive)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    a, h, n, c = q.shape
    e, _, m, _ = k.shape
    form = eq_attention_stats_form(h, c, q.dtype)
    if form == "tc" and eq_stats_smem_bytes(m) > SMEM_LIMIT:
        raise ValueError(f"K6's tc form does not fit M={m} keys in a block")
    with_sup = sup_q is not None
    if with_sup:
        sup_q = sup_q.float().reshape(a, h).contiguous()
        sup_k = sup_k.float().reshape(e, h).contiguous()
    q, k = q.contiguous(), k.contiguous()
    if k.data_ptr() % 16:  # the tc form's tensor copies need 16-byte aligned rows
        k = k.clone()
    qm, km = _mask_bytes(q_masks), _mask_bytes(k_masks)
    dev = q.device
    rowmax = torch.empty((a, e, h, n), dtype=torch.float32, device=dev)
    rowsum = torch.empty_like(rowmax)
    gpart = torch.empty((a, e, eq_attention_stats_parts(h, n, c, q.dtype)),
                        dtype=torch.float32, device=dev)
    spart = torch.empty_like(gpart)
    fn = _build.function("eq_attention", f"se3et_eq_attention_stats_{_DTYPES[q.dtype]}",
                         10, 7)
    _build.check(fn(q.data_ptr(), k.data_ptr(), qm.data_ptr(), km.data_ptr(),
                    sup_q.data_ptr() if with_sup else None,
                    sup_k.data_ptr() if with_sup else None, rowmax.data_ptr(),
                    rowsum.data_ptr(), gpart.data_ptr(), spart.data_ptr(),
                    a, e, h, n, m, c, POSITIVE_MODES.index(positive),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "eq_attention_stats launch")
    eq_attention_stats.launches += 1
    if form == "tc":  # the partials come divided by the valid (n, m) count
        attn_ae = gpart.sum(dim=-1)
    else:
        counts = q_masks.sum().float() * k_masks.sum().float()
        attn_ae = gpart.sum(dim=-1) / (counts + 1e-9)
    if with_sup:
        return rowmax, rowsum, attn_ae, spart.amax(dim=-1)
    return rowmax, rowsum, attn_ae


def eq_attention_apply(q, k, v, w_ae, rowmax, rowsum, k_masks):
    """K7 (``csrc/eq_attention.cu``, replaces the TPU ``eq_attention_apply``):
    see :func:`eq_attention_apply_plain`.  The kernel is the one
    :func:`eq_attention_apply_form` names (serving in bf16: "tc"); a shape
    no form takes raises ``ValueError``.  Bound by its products."""
    _check_apply(q, k, v, w_ae, rowmax, rowsum, k_masks)
    if q.device.type == "cpu":
        return eq_attention_apply_plain(q, k, v, w_ae, rowmax, rowsum, k_masks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    a, h, n, c = q.shape
    e, _, m, _ = k.shape
    form = eq_attention_apply_form(h, c, q.dtype)
    if form == "tc" and eq_apply_smem_bytes(m) > SMEM_LIMIT:
        raise ValueError(f"K7's tc form does not fit M={m} keys in a block")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if form == "tc":  # tensor copies need 16-byte aligned rows
        k = k.clone() if k.data_ptr() % 16 else k
        v = v.clone() if v.data_ptr() % 16 else v
    w = w_ae.float().contiguous()
    rowmax, rowsum = rowmax.float().contiguous(), rowsum.float().contiguous()
    km = _mask_bytes(k_masks)
    out = torch.empty((a, h, n, c), dtype=torch.float32, device=q.device)
    fn = _build.function("eq_attention", f"se3et_eq_attention_apply_{_DTYPES[q.dtype]}",
                         8, 6)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    rowmax.data_ptr(), rowsum.data_ptr(), km.data_ptr(), out.data_ptr(),
                    a, e, h, n, m, c, torch.cuda.current_stream(q.device).cuda_stream),
                 "eq_attention_apply launch")
    eq_attention_apply.launches += 1
    return out


eq_attention_stats.launches = 0
eq_attention_apply.launches = 0
