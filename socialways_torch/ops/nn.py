"""Linear layers and MLPs in the JAX package's parameter layout.

Counterpart of socialways_tpu/ops/nn.py:24-96.  A linear layer keeps
``w [in, out]`` and ``b [out]`` (so a JAX checkpoint loads without
transposes) and computes ``x @ w + b``.  Initialization is torch's
``nn.Linear`` reset rule, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights
and biases, drawn from an explicit ``torch.Generator``.

Mixed precision (``compute_dtype="bfloat16"``): ``cast_params`` gives a
view of a model whose weights are bf16 casts of the float32 masters, and
``linear_apply`` takes bf16 operands with float32 accumulation, as JAX's
``preferred_element_type`` product.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional, Sequence

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


class LinearView(NamedTuple):
    """A linear layer's ``w`` and ``b`` as ``linear_apply`` reads them, for
    weights that are not a module's own (a normalized or detached copy)."""
    w: torch.Tensor
    b: torch.Tensor


class MLP(nn.ModuleList):
    """Chain of :class:`Linear` layers, ReLU between them (not after the
    last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype sums over ``dtype`` operands run in: float32 for bf16 and
    float32, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def linear_apply(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the activation dtype (socialways_tpu/ops/nn.py:
    35-43).  The product accumulates in float32 and the bias is added in
    float32; the result is cast to ``x``'s dtype once.  The products of
    bf16 values are exact in float32, so with bf16 operands this is JAX's
    result up to the order of the float32 sum.  Float32 (or float64) ``x``
    and weights of its dtype take ``torch.matmul(x, w) + b`` with no cast
    (a no-op cast still costs host time on every call of a launch-bound
    step)."""
    if x.dtype == p.w.dtype != torch.bfloat16:
        return torch.matmul(x, p.w) + p.b
    acc = wide(x.dtype)
    return (torch.matmul(x.to(acc), p.w.to(acc)) + p.b.to(acc)).to(x.dtype)


def cast_params(tree, dtype: torch.dtype):
    """A view of a model (``nn.Module``, list of layers, namespace or
    ``NamedTuple`` of tensors) whose tensors are cast to ``dtype``: JAX's
    ``cast`` (socialways_tpu/engine/train_step.py:200-207).  A cast is
    differentiable, so gradients taken through the view reach the float32
    masters.  Modules become namespaces of their parameters and children,
    which the model functions read as they read the modules."""
    leaves: List[torch.Tensor] = []
    rebuild = flatten_tree(tree, leaves)
    return rebuild(iter([t.to(dtype) for t in leaves]))


def flatten_tree(tree, leaves: List[torch.Tensor]) -> Callable:
    """Append the tensors of ``tree`` (a tensor, or a model: modules,
    lists of layers, namespaces, ``NamedTuple`` views, tuples) to
    ``leaves``; returns ``rebuild(it)``, which takes the next tensors of
    the iterator ``it`` in the same order and gives ``tree``'s structure
    back (a module as a namespace of its parameters and children).
    Anything else is a constant kept as it is."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return next
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        parts = [flatten_tree(t, leaves) for t in tree]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return lambda it: type(tree)(*(f(it) for f in parts))
        kind = tuple if isinstance(tree, tuple) else list
        return lambda it: kind(f(it) for f in parts)
    if isinstance(tree, (nn.Module, SimpleNamespace)):
        items = ({**dict(tree.named_parameters(recurse=False)),
                  **dict(tree.named_children())}
                 if isinstance(tree, nn.Module) else vars(tree))
        parts = {k: flatten_tree(v, leaves) for k, v in items.items()}
        return lambda it: SimpleNamespace(**{k: f(it)
                                             for k, f in parts.items()})
    return lambda it: tree


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """For bf16 ``x`` the slope is rounded to bf16 first, as JAX's weakly
    typed scalar is (0.2 becomes 0.2002)."""
    if wide(x.dtype) != x.dtype:
        negative_slope = _rounded(negative_slope, x.dtype)
    return F.leaky_relu(x, negative_slope)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (once: no tensor read a step)."""
    return float(torch.tensor(value, dtype=dtype))


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
