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

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (building it on first use) or raises.
"""

from __future__ import annotations

import torch

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


def _check_common(x, nbr):
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported feature dtype {x.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"neighbour indices must be int32, got {nbr.dtype}")
    if x.ndim != 3 or nbr.ndim != 3 or nbr.shape[0] != x.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} nbr {tuple(nbr.shape)}")
    if nbr.device != x.device:
        raise ValueError("x and nbr must be on the same device")


def gather_wf(x: torch.Tensor, nbr: torch.Tensor, infl: torch.Tensor) -> torch.Tensor:
    """K1 (``csrc/gather_wf.cu``, replaces the TPU ``windowed_gather_wf``):
    see :func:`gather_wf_plain`; ``infl`` is cast to x's dtype.  Bound by
    device memory; the source notes the design."""
    _check_common(x, nbr)
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


gather_wf.launches = 0


def neighbor_max(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """K2 (``csrc/neighbor_max.cu``, replaces the TPU ``windowed_max_pool``):
    see :func:`neighbor_max_plain`; bit-identical to it.  Bound by device
    memory; the source notes the design."""
    _check_common(x, nbr)
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


neighbor_max.launches = 0
