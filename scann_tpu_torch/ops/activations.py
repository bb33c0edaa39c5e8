"""Activation functions (port of ``scann_tpu/ops/activations.py``).

``mrelu`` is the reference's straight-through ReLU: forward ``max(x, 0)``,
backward the identity. The reference uses it only for the band-gap head
(``target == "e_b"``).
"""

import torch
import torch.nn.functional as F

swish = F.silu  # Keras "swish" == silu == x * sigmoid(x)


class _MRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.clamp(x, min=0)

    @staticmethod
    def backward(ctx, g):
        return g  # straight-through: identity gradient


def mrelu(x: torch.Tensor) -> torch.Tensor:
    return _MRelu.apply(x)
