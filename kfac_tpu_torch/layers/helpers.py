"""Layer helpers: factor shapes, factor computation, grad matricization
(counterpart of ``kfac_tpu/layers/helpers.py``: dense layers, routed or
not, 2-D convs and LoRA units).

A helper converts between a layer's gradients, keyed by parameter name
(``weight``, ``bias``), and the (d_out, d_in[+1]) matrix the Kronecker
preconditioner works on, with the bias column appended: for
``nn.Linear`` its ``weight``, the JAX helper's ``kernel.T``; for a conv
its (C_out, C_in, kh, kw) ``weight`` as (C_out, C_in * kh * kw), the JAX
helper's ``transpose(kernel, (3, 2, 0, 1)).reshape(d_out, -1)``. A LoRA
unit's grads are its adapters', ``down.weight`` and ``up.weight``, packed
block-diagonally.
"""

from __future__ import annotations

import dataclasses

import torch

from kfac_tpu_torch.ops import cov


@dataclasses.dataclass(frozen=True)
class LayerHelper:
    """What every helper gives the engines. ``name`` is the registry name
    (module path joined with '/'); ``has_bias`` whether a bias column is
    folded into the A factor and the grad matrix; ``factor_dtype`` the
    dtype the layer's inputs and cotangents are cast to before their
    covariances, which come out in it (the JAX helpers' field)."""

    name: str
    has_bias: bool
    factor_dtype: torch.dtype = dataclasses.field(default=torch.float32, kw_only=True)

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

    @property
    def weighted(self) -> bool:
        """Whether the layer's captures carry an evidence weight: then
        :meth:`capture_weight` and :meth:`g_capture_weight` give it, the
        capture sums weighted factors and ``CapturedStats.w`` holds it."""
        return False

    def capture_weight(self, a: torch.Tensor) -> torch.Tensor | None:
        """The A-side evidence weight of one call, from the layer input
        (None: weight 1)."""
        return None

    def g_factor_for_sum(self, g: torch.Tensor) -> torch.Tensor:
        """One call's G contribution to the capture's sum: the G factor,
        or for a weighted helper the factor times its own G weight, so the
        sum over calls divided by the summed G weights is their
        traffic-weighted mean."""
        return self.get_g_factor(g)

    def g_capture_weight(self, g: torch.Tensor) -> torch.Tensor | None:
        """The G-side evidence weight of one call, from the cotangent's
        live rows (None: weight 1). The A-side weight is no G divisor: a
        call with an all-zero input can still get a cotangent."""
        return None

    def param_names(self, module: torch.nn.Module) -> list[str]:
        """The names, local to the registered module, of the parameters
        the layer preconditions."""
        return [n for n, _ in module.named_parameters()]

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Pack the layer's grads into (d_out, d_in[+1])."""
        raise NotImplementedError

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Unpack a preconditioned matrix into the layer's grads."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseHelper(LayerHelper):
    """Helper for ``nn.Linear``: A is (d_in+bias)^2, G is d_out^2; leading
    batch and sequence dims collapse into covariance rows.

    ``routed``: a row-masked layer (an MoE expert, whose unrouted rows are
    zero): its factors count live rows only (``cov.routed_linear_*``) and
    its captures are weighted by their live-row fraction."""

    in_features: int
    out_features: int
    routed: bool = False

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        n = self.in_features + int(self.has_bias)
        return (n, n)

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        return (self.out_features, self.out_features)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        if self.routed:
            return cov.routed_linear_a_factor(a, self.has_bias, self.factor_dtype)
        return cov.linear_a_factor(a, self.has_bias, self.factor_dtype)

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        if self.routed:
            return cov.routed_linear_g_factor(g, self.factor_dtype)
        return cov.linear_g_factor(g, self.factor_dtype)

    @property
    def weighted(self) -> bool:
        return self.routed

    def capture_weight(self, a: torch.Tensor) -> torch.Tensor | None:
        return cov.routed_live_fraction(a) if self.routed else None

    def g_factor_for_sum(self, g: torch.Tensor) -> torch.Tensor:
        # the routed G times its live fraction is the plain total-rows
        # normalization: g^T g / n * (n / rows) = g^T g / rows
        if self.routed:
            return cov.linear_g_factor(g, self.factor_dtype)
        return self.get_g_factor(g)

    def g_capture_weight(self, g: torch.Tensor) -> torch.Tensor | None:
        return cov.routed_live_fraction(g).to(self.factor_dtype) if self.routed else None

    @property
    def sums_fused(self) -> bool:
        """Whether :meth:`add_a` and :meth:`add_g` add a call's factor into
        a running sum in one fused launch (an unrouted f32 layer)."""
        return not self.routed and self.factor_dtype == torch.float32

    def add_a(self, acc: torch.Tensor | None, a: torch.Tensor) -> torch.Tensor:
        """``acc`` plus this call's A factor (``cov.add_cov``)."""
        return cov.add_cov(acc, cov.linear_a_rows(a, self.has_bias, self.factor_dtype))

    def add_g(self, acc: torch.Tensor | None, g: torch.Tensor) -> torch.Tensor:
        """``acc`` plus this call's G factor (``cov.add_cov``)."""
        return cov.add_cov(acc, cov._cast(g, self.factor_dtype).reshape(-1, g.shape[-1]))

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
            a, self.kernel_size, self.strides, self.padding, self.has_bias,
            self.factor_dtype,
        )

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.conv2d_g_factor(g, self.factor_dtype)

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


@dataclasses.dataclass(frozen=True)
class LoRAHelper(LayerHelper):
    """One registered unit for a LoRA adapter pair
    (:class:`kfac_tpu_torch.models.lora.LoRADense`), with block-diagonal
    factors::

        A = [[A_down, 0], [0, A_up]]   ((d_in + rank)^2, from x and h)
        G = [[G_down, 0], [0, G_up]]   ((rank + d_out)^2, from dh and dy)

    The packed gradient is block-diagonal too, so preconditioning the unit
    is exactly two-layer K-FAC over the adapters (the cross blocks are the
    zeroed approximation). The unit's ``down`` and ``up`` children carry
    the capture hooks (``Registry.taps``); each role's block comes
    pre-scaled by the role count, so the capture's call count (one a role
    a forward) averages them back to weight 1. G blocks take the routed
    normalization: with ``up`` at zero every cotangent of ``down`` is
    zero, and that block stays zero instead of 0/N. No bias: the adapters
    have none, and the frozen base is outside the unit.
    """

    in_features: int = 0
    rank: int = 0
    out_features: int = 0

    ROLES = ('down', 'up')

    def __post_init__(self) -> None:
        if self.has_bias:
            raise ValueError(
                'LoRAHelper has no bias column: adapter projections are '
                'bias-free and the frozen base bias is not preconditioned'
            )

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        n = self.in_features + self.rank
        return (n, n)

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        n = self.rank + self.out_features
        return (n, n)

    def _embed(self, block: torch.Tensor, dim: int, lo: int) -> torch.Tensor:
        out = torch.zeros((dim, dim), dtype=block.dtype, device=block.device)
        k = block.shape[0]
        out[lo:lo + k, lo:lo + k] = block * len(self.ROLES)
        return out

    def role_a_factor(self, role: str, a: torch.Tensor) -> torch.Tensor:
        """The role's A block, embedded (``down``: the unit's input;
        ``up``: ``down``'s output)."""
        fac = cov.linear_a_factor(a, has_bias=False, dtype=self.factor_dtype)
        return self._embed(fac, self.a_factor_shape[0], 0 if role == 'down' else self.in_features)

    def role_g_factor(self, role: str, g: torch.Tensor) -> torch.Tensor:
        """The role's routed G block, embedded."""
        fac = cov.routed_linear_g_factor(g, self.factor_dtype)
        return self._embed(fac, self.g_factor_shape[0], 0 if role == 'down' else self.rank)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            'LoRA units capture through per-role hooks (Registry.taps), '
            'not a module-level A hook'
        )

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            'LoRA units capture through per-role hooks (Registry.taps), '
            'not a module-level G hook'
        )

    def param_names(self, module: torch.nn.Module) -> list[str]:
        return ['down.weight', 'up.weight']

    def grads_to_matrix(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        r, di, do = self.rank, self.in_features, self.out_features
        down = grads['down.weight']
        mat = torch.zeros((r + do, di + r), dtype=down.dtype, device=down.device)
        mat[:r, :di] = down
        mat[r:, di:] = grads['up.weight']
        return mat

    def matrix_to_grads(self, mat: torch.Tensor) -> dict[str, torch.Tensor]:
        r, di = self.rank, self.in_features
        return {'down.weight': mat[:r, :di], 'up.weight': mat[r:, di:]}
