"""Fused LSTM cell and sequence loop.

Counterpart of socialways_tpu/ops/lstm.py:25-85: torch-convention gate math
(order i, f, g, o; ``c' = σ(f)c + σ(i)tanh(g)``, ``h' = σ(o)tanh(c')``)
with the input and hidden projections fused into ONE ``[x ‖ h] @ W``
GEMM per step, ``W [in+h, 4h]`` and one fused bias.  The GEMM
accumulates in float32 and the gate math runs in float32 whatever the
carry dtype; with bf16 carries the new (h, c) are cast back to bf16
(socialways_tpu/ops/lstm.py:39-56).  Sequences here are 8 observed steps,
so the time loop is a plain Python loop; under ``remat`` each step is a
``torch.utils.checkpoint`` (recomputed in the backward, as
``jax.checkpoint`` of the scan step).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from socialways_torch.ops.nn import wide

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


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed when ``remat`` and a graph is being
    recorded: its intermediates are dropped and recomputed in the
    backward."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def lstm_seq(p: LSTMCell, xs: torch.Tensor, state: LSTMState,
             remat: bool = False) -> Tuple[torch.Tensor, LSTMState]:
    """xs [B, T, in_dim] -> (ys [B, T, hidden], final state)."""
    ys = []
    for t in range(xs.shape[-2]):
        state = remat_call(remat, lambda x, h, c: lstm_cell(p, x, (h, c)),
                           xs[..., t, :], *state)
        ys.append(state[0])
    return torch.stack(ys, dim=-2), state


def zero_state(batch: int, hidden: int, device=None,
               dtype=torch.float32) -> LSTMState:
    z = torch.zeros(batch, hidden, device=device, dtype=dtype)
    return z, z.clone()
