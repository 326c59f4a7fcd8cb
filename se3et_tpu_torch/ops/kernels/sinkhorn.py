r"""Fused log-domain Sinkhorn iterations (K4).

Counterpart of ``se3et_tpu/ops/pallas/sinkhorn.py`` (``sinkhorn_pallas``):
the same exp-domain iteration with *fixed* max-shifts — ``logsumexp(s + v)
= m_row + log(sum_j exp(s - m_row) exp(v))`` with ``m_row`` computed once,
since ``exp(s - m_row) <= 1`` and ``u``, ``v`` are clipped to +-80 — so each
of the serial iterations is two multiply-reduce passes over precomputed
``exp`` matrices.  The kernel (``csrc/sinkhorn.cu``) has two forms, chosen
by :func:`sinkhorn_plan`: "rows", where the lanes that own a row (and a
column) hold their slices of both ``exp`` matrices in registers and each
patch synchronises its own warps once per half-step, and "smem", the first
design (one block per patch, both matrices in shared memory), for the
shapes the rows form cannot hold in registers.

Training differentiates through it: the backward re-runs the log-domain
scan form (:func:`sinkhorn_scan`, the JAX package's ``_sinkhorn_scan``)
and returns its vector-Jacobian product, as ``_sinkhorn_fused_bwd`` does;
the TPU package has no Sinkhorn backward kernel, and neither has the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from se3et_tpu_torch.ops.kernels import _build

_NEG_CAP = -1e30
SMEM_LIMIT = 232448  # dynamic shared memory one block can have on Hopper, bytes
# the rows form's plan (csrc/sinkhorn.cu kMaxChunk, kPatchesPerBlock,
# kChunks, max_block_threads): the most entries of a row or column one lane
# holds in registers, patches sharing a block, the register slice widths
# built, and threads per block by slice width (the instances' launch bounds)
MAX_CHUNK = 36
PATCHES_PER_BLOCK = 1
CHUNKS = (4, 8, 12, 16, 20, 24, 28, 32, 36)
FORM_CODES = {"rows": 1, "smem": 2}  # the C entry point's form codes
SMEM_THREADS = 256  # the smem form's block


def _max_block_threads(chunk: int) -> int:
    """Threads a rows-form block may have at a slice width (csrc
    ``max_block_threads``): every width is built for 256, widths 20-36 also
    for 576."""
    return 576 if 20 <= chunk <= 36 else 256


class SinkhornPlan(NamedTuple):
    """How K4 runs on (m, n) patches: the form, lanes per row, register
    slice width, warps per patch, patches per block and shared bytes per
    block (the rows form's lanes and chunk are 0 in the smem form)."""
    form: str
    lanes: int
    chunk: int
    warps: int
    patches: int
    smem_bytes: int


def _smem_form_fits(m: int, n: int) -> bool:
    """The smem form's 2mn + 3(m + n) floats fit one block."""
    return (2 * m * n + 3 * (m + n)) * 4 <= SMEM_LIMIT


def _rows_patch_floats(m: int, n: int, lanes: int, chunk: int) -> int:
    """Floats of one patch's shared region in the rows form: exp(u) and
    exp(v) (lanes x chunk each), the score tile (m rows of odd stride), u
    and v; a multiple of 4."""
    f = 2 * lanes * chunk + m * (n | 1) + m + n
    return (f + 3) // 4 * 4


def sinkhorn_plan(m: int, n: int) -> SinkhornPlan:
    """K4's plan for (m, n) patch matrices, as ``se3et_sinkhorn_plan`` in
    ``csrc/sinkhorn.cu`` makes it: the rows form with the fewest lanes per
    row (a power of two up to 32) whose slices hold at most ``MAX_CHUNK``
    entries and whose patch fits a block's threads and shared memory; else
    the smem form where ``2mn + 3(m + n)`` floats fit a block (every shape
    the first design took).  Raises ``ValueError`` where neither does."""
    if m >= 1 and n >= 1:
        maxdim = max(m, n)
        for lanes in (1, 2, 4, 8, 16, 32):
            per = -(-maxdim // lanes)
            if per > MAX_CHUNK:
                continue
            warps = -(-maxdim * lanes // 32)
            chunk = next((c for c in CHUNKS if c >= per), 0)
            if chunk == 0 or warps * 32 > _max_block_threads(chunk):
                continue
            nbytes = 4 * _rows_patch_floats(m, n, lanes, chunk)
            if nbytes > SMEM_LIMIT:
                continue
            patches = PATCHES_PER_BLOCK
            while patches > 1 and (patches * warps * 32 > _max_block_threads(chunk)
                                   or patches * nbytes > SMEM_LIMIT):
                patches -= 1
            return SinkhornPlan("rows", lanes, chunk, warps, patches, patches * nbytes)
        if _smem_form_fits(m, n):
            return SinkhornPlan("smem", 0, 0, SMEM_THREADS // 32, 1, (2 * m * n + 3 * (m + n)) * 4)
    raise ValueError(f"no K4 form takes ({m}, {n}) patch matrices: the smem form's "
                     f"2mn + 3(m + n) floats exceed one block's shared memory")


def sinkhorn_form(m: int, n: int) -> str:
    """Which hand-written K4 kernel takes (m, n) patches: "rows"
    (``sinkhorn_rows_kernel``; the serving shape 65 x 65 and every shape
    up to 144 on a side) or "smem" (``sinkhorn_smem_kernel``, the first
    design; larger and lopsided shapes).  Chosen by shape alone, as the C
    entry point chooses; neither is a fallback of the other.  Raises
    ``ValueError`` where no form takes the shape."""
    return sinkhorn_plan(m, n).form


def sinkhorn_plain(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                   num_iterations: int) -> torch.Tensor:
    """scores: (B, M, N) f32 padded scores; log_mu (B, M); log_nu (B, N).
    Returns ``scores + u[:, :, None] + v[:, None, :]``."""
    m_row = torch.clamp_min(scores.amax(dim=2), _NEG_CAP)
    m_col = torch.clamp_min(scores.amax(dim=1), _NEG_CAP)
    e_row = torch.exp(scores - m_row[:, :, None])
    e_col = torch.exp(scores - m_col[:, None, :])
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        s = torch.sum(e_row * torch.exp(v)[:, None, :], dim=2)
        u = torch.clamp(log_mu - m_row - torch.log(s + 1e-30), -80.0, 80.0)
        t = torch.sum(e_col * torch.exp(u)[:, :, None], dim=1)
        v = torch.clamp(log_nu - m_col - torch.log(t + 1e-30), -80.0, 80.0)
    return scores + u[:, :, None] + v[:, None, :]


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp with the shift held constant, ``log(sum(exp(x - m))) + m``
    (``jax.nn.logsumexp``'s form): its gradient is the softmax
    ``exp(x - m) / sum``, which stays normalised for rows of masked (-1e12)
    entries, where ``torch.logsumexp``'s ``exp(x - result)`` loses the
    log-sum to rounding."""
    m = x.amax(dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True)) + m).squeeze(dim)


def sinkhorn_scan(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                  num_iterations: int) -> torch.Tensor:
    """Log-domain Sinkhorn by alternating logsumexp updates (the
    differentiable form): returns ``scores + u[:, :, None] + v[:, None, :]``."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - _logsumexp(scores + v[:, None, :], dim=2)
        v = log_nu - _logsumexp(scores + u[:, :, None], dim=1)
    return scores + u[:, :, None] + v[:, None, :]


class _Sinkhorn(torch.autograd.Function):
    """K4 forward; the backward is the VJP of :func:`sinkhorn_scan`."""

    @staticmethod
    def forward(ctx, scores, log_mu, log_nu, num_iterations):
        ctx.save_for_backward(scores, log_mu, log_nu)
        ctx.num_iterations = num_iterations
        return _sinkhorn_forward(scores, log_mu, log_nu, num_iterations)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = sinkhorn_scan(*inputs, ctx.num_iterations)
        grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def sinkhorn(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
             num_iterations: int) -> torch.Tensor:
    """K4 (``csrc/sinkhorn.cu``, replaces the TPU ``sinkhorn_pallas``): see
    :func:`sinkhorn_plain`.  The kernel is the one :func:`sinkhorn_form`
    names (serving: "rows"); a shape no form takes raises ``ValueError``.
    Bound by its chain of serial half-steps; the source notes the design.
    Differentiable: the backward replays :func:`sinkhorn_scan`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (scores, log_mu, log_nu)):
        return _Sinkhorn.apply(scores, log_mu, log_nu, num_iterations)
    return _sinkhorn_forward(scores, log_mu, log_nu, num_iterations)


def _check_shapes(scores, log_mu, log_nu):
    """K4's shape checks, on every device."""
    if scores.ndim != 3:
        raise ValueError(f"scores must be (B, M, N): got {tuple(scores.shape)}")
    b, m, n = scores.shape
    if tuple(log_mu.shape) != (b, m) or tuple(log_nu.shape) != (b, n):
        raise ValueError(f"bad marginal shapes: log_mu {tuple(log_mu.shape)}, log_nu "
                         f"{tuple(log_nu.shape)} for scores {tuple(scores.shape)}")


def _sinkhorn_forward(scores, log_mu, log_nu, num_iterations, form: Optional[str] = None):
    """The forward on the kernel :func:`sinkhorn_form` names, or on ``form``
    ("rows" or "smem") where the caller asks for one that takes the shape."""
    _check_shapes(scores, log_mu, log_nu)
    if scores.device.type == "cpu":
        return sinkhorn_plain(scores, log_mu, log_nu, num_iterations)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if any(t.dtype != torch.float32 for t in (scores, log_mu, log_nu)):
        raise TypeError("sinkhorn takes float32 scores and marginals")
    b, m, n = scores.shape
    plan = sinkhorn_plan(m, n)
    form = form or plan.form
    if form != plan.form and not (form == "smem" and _smem_form_fits(m, n)):
        raise ValueError(f"K4's {form} form does not take ({m}, {n}) patches")
    scores = scores.contiguous()
    log_mu = log_mu.contiguous()
    log_nu = log_nu.contiguous()
    out = torch.empty_like(scores)
    fn = _build.function("sinkhorn", "se3et_sinkhorn_f32", 4, 5)
    _build.check(fn(scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(),
                    out.data_ptr(), b, m, n, num_iterations, FORM_CODES[form],
                    torch.cuda.current_stream(scores.device).cuda_stream),
                 "sinkhorn launch")
    sinkhorn.launches += 1
    return out


sinkhorn.launches = 0
