"""Linear layers and MLPs in the JAX package's parameter layout.

Counterpart of socialways_tpu/ops/nn.py:24-96.  A linear layer keeps
``w [in, out]`` and ``b [out]`` (so a JAX checkpoint loads without
transposes) and computes ``x @ w + b``.  Initialization is torch's
``nn.Linear`` reset rule, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights
and biases, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w [in_dim, out_dim]``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = nn.Parameter(torch.empty(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self, x)


class MLP(nn.ModuleList):
    """Chain of :class:`Linear` layers, ReLU between them (not after the
    last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def linear_apply(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.w) + p.b


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def spectral_normalize(w: torch.Tensor, n_iters: int = 30,
                       eps: float = 1e-12) -> torch.Tensor:
    """``w / sigma_max(w)`` with the top singular value estimated by
    ``n_iters`` power iterations from the fixed start ``1/sqrt(rows)``
    (SN-GAN; socialways_tpu/ops/nn.py:50-74).  ``u`` and ``v`` are
    constants of the gradient, which flows through ``w`` in the numerator
    and in ``sigma = u w v``.  Stateless, so not torch's
    ``spectral_norm`` (a persistent ``u``) nor an SVD: each gives another
    function."""
    with torch.no_grad():
        u = torch.full((w.shape[0],), 1.0 / (w.shape[0] ** 0.5),
                       dtype=w.dtype, device=w.device)
        for _ in range(n_iters):
            v = w.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ w @ v
    return w / torch.clamp(sigma, min=eps)


def mlp_apply(layers: Sequence[Linear], x: torch.Tensor,
              activation: Callable = torch.relu,
              final_activation: Optional[Callable] = None) -> torch.Tensor:
    n = len(layers)
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def linear_init(in_dim: int, out_dim: int,
                generator: Optional[torch.Generator] = None) -> Linear:
    """A CPU :class:`Linear` drawn U(-1/sqrt(in_dim), 1/sqrt(in_dim))."""
    lin = Linear(in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        lin.w.uniform_(-bound, bound, generator=generator)
        lin.b.uniform_(-bound, bound, generator=generator)
    return lin


def mlp_init(dims: Sequence[int],
             generator: Optional[torch.Generator] = None) -> MLP:
    """Layers ``dims[0] -> dims[1] -> ...``, e.g. ``[3, 32, 64, 64]``."""
    return MLP([linear_init(dims[i], dims[i + 1], generator)
                for i in range(len(dims) - 1)])
