r"""Common layers (port of :mod:`se3et_tpu.nn.layers`).

Parameter layout and names follow the JAX package's flax tree so that
:mod:`se3et_tpu_torch.convert` maps it path for path: submodules are
registered under flax's auto-names (``TorchLinear_0``, ``MaskedGroupNorm_0``,
...), and a norm's ``scale`` is its ``weight`` here.  Initialisation
reproduces the PyTorch defaults the JAX package also copies
(``U(+-1/sqrt(fan_in))`` for linear weights and biases), drawn from an
explicit :class:`torch.Generator` by :func:`init_parameters`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from se3et_tpu_torch import precision as prec


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` from ``generator`` in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters_with", None)
        if reset is not None:
            reset(generator)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class TorchLinear(nn.Module):
    """Linear layer; ``weight`` is (out, in), the transpose of flax's kernel."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters_with(self, generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x):
        x = prec.cast_feature(x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def build_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return leaky_relu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(f"unknown activation {name}")


class MaskedGroupNorm(nn.Module):
    """GroupNorm over (optional anchors, valid points, group channels), with
    per-cloud statistics (leading batch axis) and padded points excluded.

    x: (B, N, C) or (B, N, A, C); mask: (B, N) True = valid.
    """

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters_with(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, mask=None):
        c = x.shape[-1]
        g = min(self.num_groups, c)
        if c % g:
            raise ValueError(f"channels {c} not divisible by groups {g}")
        in_dtype = x.dtype
        x = x.float()
        orig_shape = x.shape
        xg = x.reshape(orig_shape[:-1] + (g, c // g))
        red = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        if mask is None:
            s1 = xg.sum(dim=red, keepdim=True)
            s2 = (xg * xg).sum(dim=red, keepdim=True)
            denom = float(math.prod(xg.shape[a] for a in red))
        else:
            m = mask.reshape(mask.shape + (1,) * (xg.ndim - mask.ndim)).float()
            xm = xg * m
            s1 = xm.sum(dim=red, keepdim=True)
            s2 = (xm * xg).sum(dim=red, keepdim=True)
            per_point = math.prod(xg.shape[a] for a in red if a >= mask.ndim)
            counts = mask.float().sum(dim=1)
            denom = (counts.reshape((counts.shape[0],) + (1,) * (xg.ndim - 1))
                     * per_point + 1e-9)
        mean = s1 / denom
        var = torch.clamp_min(s2 / denom - mean * mean, 0.0)
        out = (xg - mean) * torch.rsqrt(var + self.epsilon)
        out = out.reshape(orig_shape) * self.weight + self.bias
        return out.to(in_dtype)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the channel axis, statistics in float32."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters_with(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        in_dtype = x.dtype
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(in_dtype)


class UnaryBlock(nn.Module):
    """Linear -> GroupNorm -> LeakyReLU(0.1), on (B, N, C) or (B, N, A, C)."""

    def __init__(self, in_dim: int, out_dim: int, group_norm: int,
                 no_relu: bool = False):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(in_dim, out_dim)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(group_norm, out_dim)
        self.no_relu = no_relu

    def forward(self, x, mask=None):
        x = self.MaskedGroupNorm_0(self.TorchLinear_0(x), mask)
        return x if self.no_relu else leaky_relu(x)


class LastUnaryBlock(nn.Module):
    """Plain Linear output head."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(in_dim, out_dim)

    def forward(self, x, mask=None):
        return self.TorchLinear_0(x)
