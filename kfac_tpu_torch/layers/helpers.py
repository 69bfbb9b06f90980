"""Layer helpers: factor shapes, factor computation, grad matricization
(counterpart of ``kfac_tpu/layers/helpers.py``; dense layers only in this
slice).

A helper converts between a layer's gradients, keyed by parameter name
(``weight``, ``bias``), and the (d_out, d_in[+1]) matrix the Kronecker
preconditioner works on: ``nn.Linear.weight`` with the bias column
appended, the same matrix as the JAX helper's ``kernel.T``.
"""

from __future__ import annotations

import dataclasses

import torch

from kfac_tpu_torch.ops import cov


@dataclasses.dataclass(frozen=True)
class DenseHelper:
    """Helper for ``nn.Linear``: A is (d_in+bias)^2, G is d_out^2; leading
    batch and sequence dims collapse into covariance rows. ``name`` is the
    registry name (module path joined with '/')."""

    name: str
    has_bias: bool
    in_features: int
    out_features: int

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        n = self.in_features + int(self.has_bias)
        return (n, n)

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        return (self.out_features, self.out_features)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        """Per-batch A factor from the layer input."""
        return cov.linear_a_factor(a, self.has_bias)

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        """Per-batch G factor from dL/d(layer output)."""
        return cov.linear_g_factor(g)

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Pack the layer's grads into (d_out, d_in[+1])."""
        mat = grads['weight']
        if self.has_bias:
            mat = torch.cat([mat, grads['bias'][:, None]], dim=1)
        return mat

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Unpack a preconditioned matrix into the layer's grads."""
        if self.has_bias:
            return {'weight': mat[:, :-1], 'bias': mat[:, -1]}
        return {'weight': mat}
