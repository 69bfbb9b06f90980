"""Layer helpers: factor shapes, factor computation, grad matricization
(counterpart of ``kfac_tpu/layers/helpers.py``; dense and 2-D conv layers).

A helper converts between a layer's gradients, keyed by parameter name
(``weight``, ``bias``), and the (d_out, d_in[+1]) matrix the Kronecker
preconditioner works on, with the bias column appended: for
``nn.Linear`` its ``weight``, the JAX helper's ``kernel.T``; for a conv
its (C_out, C_in, kh, kw) ``weight`` as (C_out, C_in * kh * kw), the JAX
helper's ``transpose(kernel, (3, 2, 0, 1)).reshape(d_out, -1)``.
"""

from __future__ import annotations

import dataclasses

import torch

from kfac_tpu_torch.ops import cov


@dataclasses.dataclass(frozen=True)
class LayerHelper:
    """What every helper gives the engines. ``name`` is the registry name
    (module path joined with '/'); ``has_bias`` whether a bias column is
    folded into the A factor and the grad matrix."""

    name: str
    has_bias: bool

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        raise NotImplementedError

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        """Per-batch A factor from the layer input."""
        raise NotImplementedError

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        """Per-batch G factor from dL/d(layer output)."""
        raise NotImplementedError

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Pack the layer's grads into (d_out, d_in[+1])."""
        raise NotImplementedError

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Unpack a preconditioned matrix into the layer's grads."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseHelper(LayerHelper):
    """Helper for ``nn.Linear``: A is (d_in+bias)^2, G is d_out^2; leading
    batch and sequence dims collapse into covariance rows."""

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
        return cov.linear_a_factor(a, self.has_bias)

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.linear_g_factor(g)

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        mat = grads['weight']
        if self.has_bias:
            mat = torch.cat([mat, grads['bias'][:, None]], dim=1)
        return mat

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        if self.has_bias:
            return {'weight': mat[:, :-1], 'bias': mat[:, -1]}
        return {'weight': mat}


@dataclasses.dataclass(frozen=True)
class Conv2dHelper(LayerHelper):
    """Helper for a 2-D convolution over NCHW input: A is (C_in * kh * kw
    + bias)^2 over the patch rows, G is C_out^2 over the output positions.

    ``padding`` is what the layer pads its input with: 'SAME' (flax's rule,
    resolved on each input's size by ``cov.same_padding``, as the port's
    ``SameConv2d`` pads), 'VALID', or ((top, bottom), (left, right)). The
    A hook sees the input before that padding, and the patches apply it.
    """

    in_channels: int
    out_channels: int
    kernel_size: tuple[int, int]
    strides: tuple[int, int]
    padding: cov.Padding

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        n = self.in_channels * self.kernel_size[0] * self.kernel_size[1] + int(self.has_bias)
        return (n, n)

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        return (self.out_channels, self.out_channels)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.conv2d_a_factor(
            a, self.kernel_size, self.strides, self.padding, self.has_bias
        )

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.conv2d_g_factor(g)

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        mat = grads['weight'].reshape(self.out_channels, -1)
        if self.has_bias:
            mat = torch.cat([mat, grads['bias'][:, None]], dim=1)
        return mat

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        shape = (self.out_channels, self.in_channels, *self.kernel_size)
        if self.has_bias:
            return {'weight': mat[:, :-1].reshape(shape), 'bias': mat[:, -1]}
        return {'weight': mat.reshape(shape)}
