"""Covariance (Kronecker factor) numerics (counterpart of
``kfac_tpu/ops/cov.py``, dense layers only; conv and routed factors come
in a later slice).
"""

from __future__ import annotations

import torch

from kfac_tpu_torch.ops import sym_cov as sym_cov_lib


def append_bias_ones(x: torch.Tensor) -> torch.Tensor:
    """Append a column of ones to the last dimension of ``x``."""
    ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)


def get_cov(
    a: torch.Tensor,
    b: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Empirical second moment of a 2D tensor: ``a^T @ (b or a) / scale``.

    A self-covariance of a CUDA tensor always goes through the triangular
    kernel (exactly symmetric by construction); on the CPU it is the plain
    ``(C + C^T)/2`` form of the JAX package.
    """
    if a.ndim != 2:
        raise ValueError(f'expected 2D tensor, got shape {tuple(a.shape)}')
    if b is not None and a.shape != b.shape:
        raise ValueError(f'shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}')
    if scale is None:
        scale = a.shape[0]
    if b is None:
        if a.device.type == 'cuda':
            return sym_cov_lib.sym_cov(a.contiguous(), scale)
        cov = a.T @ (a / scale)
        return (cov + cov.T) / 2.0
    return a.T @ (b / scale)


def linear_a_factor(a: torch.Tensor, has_bias: bool) -> torch.Tensor:
    """A factor of a dense layer from its input: rows are the flattened
    leading dims, with a bias column of ones."""
    a = a.reshape(-1, a.shape[-1])
    if has_bias:
        a = append_bias_ones(a)
    return get_cov(a)


def linear_g_factor(g: torch.Tensor) -> torch.Tensor:
    """G factor of a dense layer from the loss gradient w.r.t. its output."""
    g = g.reshape(-1, g.shape[-1])
    return get_cov(g)
