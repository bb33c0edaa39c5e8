"""The bf16 operand mode of the whole-model kernels, as plain PyTorch (port
of ``scann_tpu/kernels/dots.py``).

``model.dtype: "bfloat16"`` turns on one casting policy for every product of
the whole-model kernels: both operands are rounded to bfloat16 (to nearest,
ties to even) and the products are summed in f32. Params, inputs,
LayerNorm, softmax and swish stay f32. Here the policy is written as f32
arithmetic on rounded values: ``round_bf16`` rounds, and the contraction
shapes below multiply rounded f32 tensors, which gives every product of two
bfloat16 values exactly and sums in f32 as the TPU's matrix unit does. The
plain versions of the kernels take the policy from here, so it cannot drift
between them; the CUDA kernels apply the same rounding in
``csrc/scann_mma.cuh`` (``kBf16``).

Rounding applies to activations and one-hot or RBF operands alike: a
Gaussian value is not exact in bfloat16. ``mm_hi`` and ``mm_tA_hi`` are the
f32-exact products the molecule kernel pools packed segments with, in
either mode.

The TPU backward kernels (``scann_backward.py:_kernel``,
``scann_loop.py:_bwd_kernel``) form every gradient product in the same
mode, the transposed ones included, so the cotangent is rounded too: for
``y = r(a) @ r(w)`` they compute ``da = r(dy) @ r(w)^T`` and ``dw = r(a)^T
@ r(dy)``, the weight's own rounding being straight-through. ``product``
is that pair as a ``torch.autograd.Function``; ``one_hot`` the same for the
operands the port forms without a product (the neighbour gather, the
embedding lookup, the energies' head sum and the attention's lane
expansion): ``y = P(r(x))`` for a 0/1 map P, whose backward is ``P^T(r(dy))``
(the cotangent rounded before the sum, never after it). Bias gradients stay
f32 sums of the unrounded cotangent, as autograd forms them.
"""

from __future__ import annotations

from typing import Callable

import torch


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back to its dtype (f32; f64 where a
    caller runs the arithmetic between the roundings in f64)."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm(a, b):  # [..., R, X] @ [X, C]
    return a @ b


def mm_tA(a, b):  # a^T @ b : [R, X], [R, C] -> [X, C]
    return a.transpose(-2, -1) @ b


def mm_tB(a, b):  # a @ b^T : [R, X], [C, X] -> [R, C]
    return a @ b.transpose(-2, -1)


def dot3(x, w):  # [M, N, X] @ [X, C]
    return x @ w


def dot3_tB(x, w):  # [M, N, X] @ w^T with w [C, X]
    return x @ w.transpose(-2, -1)


def mm3_tA(x, dy):  # sum_{m,n} x[m,n,:]^T dy[m,n,:] -> [X, C]
    return mm_tA(x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1]))


mm_hi = mm        # f32 products: exact to f32 here in either mode
mm_tA_hi = mm_tA


def dot_fns(bf16: bool):
    """(mm, mm_tA, mm_tB, dot3, dot3_tB, mm3_tA); with ``bf16`` each rounds
    both operands to bfloat16 first."""
    fns = (mm, mm_tA, mm_tB, dot3, dot3_tB, mm3_tA)
    if not bf16:
        return fns
    return tuple((lambda f: lambda a, b: f(round_bf16(a), round_bf16(b)))(f) for f in fns)


class _Product(torch.autograd.Function):
    """a [..., X] @ w [X, C] in the bf16 operand mode, with the TPU backward
    kernels' transposed products as its gradient."""

    @staticmethod
    def forward(ctx, a, w):
        ra, rw = round_bf16(a), round_bf16(w)
        ctx.save_for_backward(ra, rw)
        return ra @ rw

    @staticmethod
    def backward(ctx, g):
        ra, rw = ctx.saved_tensors
        rg = round_bf16(g)
        da = rg @ rw.transpose(0, 1) if ctx.needs_input_grad[0] else None
        dw = mm3_tA(ra, rg) if ctx.needs_input_grad[1] else None
        return da, dw


def product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``round_bf16(a) @ round_bf16(w)`` (w [X, C]); its gradients are
    ``r(dy) @ r(w)^T`` and ``r(a)^T @ r(dy)``, summed over a's leading axes."""
    return _Product.apply(a, w)


class _OneHot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(round_bf16(x))

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(round_bf16(g)), None, None


def one_hot(x: torch.Tensor, fwd: Callable, bwd: Callable) -> torch.Tensor:
    """``fwd(round_bf16(x))`` for a 0/1 map ``fwd`` that the TPU kernels form
    as a product with a one-hot matrix; its gradient is ``bwd(round_bf16(dy))``,
    ``bwd`` the transpose of that map."""
    return _OneHot.apply(x, fwd, bwd)
