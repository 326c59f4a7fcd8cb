r"""Fused log-domain Sinkhorn iterations (K4).

Counterpart of ``se3et_tpu/ops/pallas/sinkhorn.py`` (``sinkhorn_pallas``):
the same exp-domain iteration with *fixed* max-shifts — ``logsumexp(s + v)
= m_row + log(sum_j exp(s - m_row) exp(v))`` with ``m_row`` computed once,
since ``exp(s - m_row) <= 1`` and ``u``, ``v`` are clipped to +-80 — so each
of the serial iterations is two multiply-reduce passes over precomputed
``exp`` matrices.  The kernel (``csrc/sinkhorn.cu``) runs one block per
patch matrix with both ``exp`` matrices resident in shared memory for all
iterations.

Training differentiates through it: the backward re-runs the log-domain
scan form (:func:`sinkhorn_scan`, the JAX package's ``_sinkhorn_scan``)
and returns its vector-Jacobian product, as ``_sinkhorn_fused_bwd`` does;
the TPU package has no Sinkhorn backward kernel, and neither has the port.
"""

from __future__ import annotations

import torch

from se3et_tpu_torch.ops.kernels import _build

_NEG_CAP = -1e30


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
    :func:`sinkhorn_plain`.  Latency-bound (serial iterations); the source
    notes the design.  Differentiable: the backward replays
    :func:`sinkhorn_scan`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (scores, log_mu, log_nu)):
        return _Sinkhorn.apply(scores, log_mu, log_nu, num_iterations)
    return _sinkhorn_forward(scores, log_mu, log_nu, num_iterations)


def _sinkhorn_forward(scores, log_mu, log_nu, num_iterations):
    if scores.device.type == "cpu":
        return sinkhorn_plain(scores, log_mu, log_nu, num_iterations)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if any(t.dtype != torch.float32 for t in (scores, log_mu, log_nu)):
        raise TypeError("sinkhorn takes float32 scores and marginals")
    b, m, n = scores.shape
    if log_mu.shape != (b, m) or log_nu.shape != (b, n):
        raise ValueError("bad marginal shapes")
    if (2 * m * n + 3 * (m + n)) * 4 > 227 * 1024:
        raise ValueError(f"({m}, {n}) patch matrices exceed one block's shared memory")
    scores = scores.contiguous()
    log_mu = log_mu.contiguous()
    log_nu = log_nu.contiguous()
    out = torch.empty_like(scores)
    fn = _build.function("sinkhorn", "se3et_sinkhorn_f32", 4, 4)
    _build.check(fn(scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(),
                    out.data_ptr(), b, m, n, num_iterations,
                    torch.cuda.current_stream(scores.device).cuda_stream),
                 "sinkhorn launch")
    sinkhorn.launches += 1
    return out


sinkhorn.launches = 0
