"""Fused LSTM cell and sequence loop.

Counterpart of socialways_tpu/ops/lstm.py:25-85: torch-convention gate math
(order i, f, g, o; ``c' = σ(f)c + σ(i)tanh(g)``, ``h' = σ(o)tanh(c')``)
with the input and hidden projections fused into ONE ``[x ‖ h] @ W``
GEMM per step, ``W [in+h, 4h]`` and one fused bias.  The GEMM
accumulates in float32 and the gate math runs in float32 whatever the
carry dtype; with bf16 carries the new (h, c) are cast back to bf16
(socialways_tpu/ops/lstm.py:39-56).  Sequences here are 8 observed steps,
so the time loop is a plain Python loop; under ``remat`` each step is
recomputed in the backward, as ``jax.checkpoint`` of the scan step
(``remat_call``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from socialways_torch.ops.nn import flatten_tree, wide

LSTMState = Tuple[torch.Tensor, torch.Tensor]     # (h, c), each [..., hidden]


class LSTMCell(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim + hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, x: torch.Tensor, state: LSTMState) -> LSTMState:
        return lstm_cell(self, x, state)


def lstm_init(in_dim: int, hidden: int,
              generator: Optional[torch.Generator] = None) -> LSTMCell:
    """torch's U(-1/sqrt(h), 1/sqrt(h)) rule.  torch keeps two bias vectors
    (b_ih + b_hh); the fused bias is drawn as the sum of two uniforms."""
    cell = LSTMCell(in_dim, hidden)
    bound = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        cell.w.uniform_(-bound, bound, generator=generator)
        b1 = torch.empty(4 * hidden).uniform_(-bound, bound,
                                              generator=generator)
        b2 = torch.empty(4 * hidden).uniform_(-bound, bound,
                                              generator=generator)
        cell.b.copy_(b1 + b2)
    return cell


def lstm_cell(p: LSTMCell, x: torch.Tensor, state: LSTMState) -> LSTMState:
    """One step.  The GEMM and the gate math run in ``wide(h.dtype)`` and
    the new (h, c) are cast back to the carry dtypes; float32 (or float64)
    operands of one dtype take no cast (a no-op cast still costs host
    time)."""
    h, c = state
    xh, w, b = torch.cat([x, h], dim=-1), p.w, p.b
    cast = not x.dtype == h.dtype == w.dtype != torch.bfloat16
    if cast:
        acc = wide(h.dtype)
        xh, w, b, c = xh.to(acc), w.to(acc), b.to(acc), c.to(acc)
    gates = torch.matmul(xh, w) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    if cast:
        return h_new.to(h.dtype), c_new.to(state[1].dtype)
    return h_new, c_new


class _Remat(torch.autograd.Function):
    """``fn(*leaves)`` (a tuple of tensors) with no intermediate kept: the
    forward runs it without a graph and saves only its inputs, the
    backward runs it again under grad and pulls the cotangents through.
    Under ``torch.func.vmap`` over ensemble members the ``vmap`` rule
    applies this Function, outside ``vmap``, to ``vmap(fn)`` of the
    stacked inputs, so the recomputation is one mapped call over every
    member.  (``torch.utils.checkpoint`` runs under ``vmap`` but its
    recomputation cannot: the backward meets tensors of a ``vmap`` level
    that has ended.)"""

    @staticmethod
    def forward(fn, *leaves):
        return fn(*leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.fn(*xs)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            got = [None] * len(wrt)
            if pairs and wrt:
                got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                          [g for _, g in pairs],
                                          allow_unused=True)
        got = iter(got)
        return (None,) + tuple(next(got) if n else None for n in need)

    @staticmethod
    def vmap(info, in_dims, fn, *leaves):
        outs = _Remat.apply(torch.func.vmap(fn, in_dims=in_dims[1:]),
                            *leaves)
        return outs, (0,) * len(outs)


def remat_call(remat: bool, fn: Callable, *args):
    """``fn(*args)``, rematerialized when ``remat`` and a graph is being
    recorded: its intermediates are dropped and recomputed in the
    backward (``_Remat``, for one model and for members alike).  ``args``
    are tensors or models (modules, namespaces, lists of layers), and
    ``fn`` must read no tensor but theirs and draw no random number."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    leaves: list = []
    rebuild = flatten_tree(args, leaves)
    single = []

    def flat(*ts):
        out = fn(*rebuild(iter(ts)))
        if not single:
            single.append(isinstance(out, torch.Tensor))
        return (out,) if isinstance(out, torch.Tensor) else tuple(out)
    outs = _Remat.apply(flat, *leaves)
    return outs[0] if single[0] else outs


def _cell(p: LSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
          ) -> LSTMState:
    return lstm_cell(p, x, (h, c))


def lstm_seq(p: LSTMCell, xs: torch.Tensor, state: LSTMState,
             remat: bool = False) -> Tuple[torch.Tensor, LSTMState]:
    """xs [B, T, in_dim] -> (ys [B, T, hidden], final state)."""
    ys = []
    for t in range(xs.shape[-2]):
        state = remat_call(remat, _cell, p, xs[..., t, :], *state)
        ys.append(state[0])
    return torch.stack(ys, dim=-2), state


def zero_state(batch: int, hidden: int, device=None,
               dtype=torch.float32) -> LSTMState:
    z = torch.zeros(batch, hidden, device=device, dtype=dtype)
    return z, z.clone()
