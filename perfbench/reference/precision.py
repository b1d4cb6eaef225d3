"""Where the reference rounds, and to what.

``store`` rounds a value to what a tensor of the activation dtype holds;
``mm`` is a product whose operands (and, under autograd, those of its
backward products) are rounded as a TF32 GEMM rounds them.  Rounding is
emulated on float32 tensors, so one code path serves every precision:
bfloat16 is exact (an elementwise bf16 operation is the float32 operation
rounded once), TF32 keeps 10 mantissa bits (round to nearest even),
float8 is e4m3 with saturation at 448 (its largest finite value; a cast
past it gives NaN).
"""

from __future__ import annotations

from typing import Callable

import torch


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


class Precision:
    """``name``: float32, tf32, bfloat16 or float8."""

    _STORE = {"float32": _identity, "tf32": _identity,
              "bfloat16": round_bf16, "float8": round_fp8}
    # operands held in the activation dtype are rounded by ``store`` where
    # the model keeps them; ``mm`` adds TF32's rounding of every GEMM operand
    _MM = {"float32": _identity, "tf32": round_tf32,
           "bfloat16": _identity, "float8": _identity}

    def __init__(self, name: str):
        if name not in self._STORE:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.store: Callable[[torch.Tensor], torch.Tensor] = self._STORE[name]
        self.mm_round: Callable[[torch.Tensor], torch.Tensor] = self._MM[name]

    @property
    def exact_mm(self) -> bool:
        return self.mm_round is _identity

    def scalar(self, value: float) -> float:
        """A Python scalar as the activation dtype holds it."""
        return float(self.store(torch.tensor([value]))[0])

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product's operand (TF32: rounded, with the gradient
        passing through unrounded)."""
        if self.exact_mm:
            return x
        return x + (self.mm_round(x) - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with float32 sums over rounded operands."""
        if self.exact_mm:
            return a @ b
        return _RoundedMatmul.apply(a, b, self.mm_round)


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` whose operands, and those of its backward products, are
    rounded by ``rnd`` (a reduced-precision GEMM's forward and backward)."""

    @staticmethod
    def forward(a, b, rnd):
        return rnd(a) @ rnd(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, rnd = inputs
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = rnd(g) @ rnd(b).transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            a2 = rnd(a).reshape(-1, a.shape[-1])
            gb = a2.transpose(0, 1) @ rnd(g).reshape(-1, g.shape[-1])
            gb = gb.reshape(b.shape)
        return ga, gb, None
