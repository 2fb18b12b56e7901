"""JAX's bf16 numerics as torch ops, shared by the kernels' bf16 modes.

The numerics modes of kernels A-D: ``'f32'`` (the JAX package's parity
default), ``'bf16'`` (the TPU kernels' own numerics: f32 kernels on
operands rounded to bf16) and ``'bf16_scan'`` (JAX's bf16 ``lax.scan``:
every op rounded to bf16).  The plain versions of the bf16 scan modes
(``ops/gcnii.py:_scan_plain``, ``ops/bigru.py:_scan_plain``) run on bf16
tensors, where each torch op rounds its result as JAX's bf16 op does; the
autograd Functions below give the backward JAX's transpose where torch's
own rounds or sums elsewhere.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

F32, BF16, SCAN = "f32", "bf16", "bf16_scan"
MODES = (F32, BF16, SCAN)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")


def to_bf16(x: Tensor) -> Tensor:
    """``x`` rounded to bf16 (to nearest even) and held in its own type."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm(a: Tensor, b: Tensor) -> Tensor:
    """A product of bf16 tensors as JAX's bf16 dot computes it: the exact
    products summed in f32, the output rounded to bf16 once."""
    return (a.float() @ b.float()).to(torch.bfloat16)


class Sigmoid(torch.autograd.Function):
    """JAX's bf16 ``sigmoid`` (``lax.logistic``): ``1 / (1 + exp(-x))``,
    each op rounded, and its JVP's transpose ``d (y (1 - y))``, each op
    rounded (``jax/_src/lax/lax.py``, ``logistic_p``); torch's own
    sigmoid rounds once each way."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return 1 / (1 + torch.exp(-x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, d):
        y, = ctx.saved_tensors
        return d * (y * (1 - y))


class Tanh(torch.autograd.Function):
    """``tanh(x)``, called as ``Tanh.apply(x, x)``, with JAX's JVP
    transposed, each op rounded: ``a = d (1 - y)`` to the first ``x`` and
    ``a y`` to the second (``tanh_p``), so that autograd adds them to x's
    gradient one after the other, as JAX's transpose adds them to the
    cotangent it carries (the cell state's: ``(d_lc + a) + a y``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, _):
        return torch.tanh(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, d):
        y, = ctx.saved_tensors
        a = d * (1 - y)
        return a, a * y


def row_sum(d: Tensor) -> Tensor:
    """The rows of ``d`` (..., B, C) summed one after another, each add
    rounded to ``d``'s type: XLA's bf16 ``reduce_sum`` over a few rows on
    the CPU (torch's own sums in f32 and rounds once)."""
    rows = d.unbind(-2)
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    return s


class RowBias(torch.autograd.Function):
    """``x + b`` for x (..., B, C) and b (..., C) or (..., 1, C), whose
    backward gives b the rows of the gradient summed by :func:`row_sum`:
    JAX's transpose of the broadcast add in one step of a bf16 scan (the
    GRU's ``h @ W_hh + b_hh``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, b):
        return x + b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.b_shape = inputs[1].shape

    @staticmethod
    def backward(ctx, d):
        return d, row_sum(d).reshape(ctx.b_shape)


class Carry(torch.autograd.Function):
    """A scan's new carry, which is also the step's output: two copies, the
    carry for the next step and the output, whose cotangents the backward
    adds (rounded) once the next step's have all reached the carry, as
    JAX's transposed scan adds a step's output cotangent to the carried
    one (autograd would add the output's first, a rounding apart)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h):
        return h.clone(), h.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, d_carry, d_out):
        return d_carry + d_out
