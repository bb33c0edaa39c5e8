"""Gaussian radial basis expansion (port of ``scann_tpu/ops/rbf.py``).

    rbf_k(x) = exp(-(x - c_k)^2 / width)   with width = 0.5**2 = 0.25

Centers are ``linspace(0, gaussian_d, 20)`` for distances and
``linspace(0, 2*pi, 20)`` for Voronoi solid angles (SCANN+).
"""

import numpy as np
import torch


def make_centers(stop: float, num: int = 20) -> np.ndarray:
    return np.linspace(0.0, stop, num, dtype=np.float32)


def gaussian_expansion(x: torch.Tensor, centers: torch.Tensor,
                       width: float = 0.25) -> torch.Tensor:
    """Expand ``x [...]`` to ``[..., K]`` Gaussian basis values.

    ``width`` is already the squared width (0.5**2), as in the reference.
    """
    diff = x[..., None] - centers
    return torch.exp(-(diff * diff) / width)
