"""Covariance (Kronecker factor) numerics (counterpart of
``kfac_tpu/ops/cov.py``: dense, routed dense and 2-D convolution
factors).

Convolutions are NCHW here, as PyTorch keeps them, where the JAX package
is NHWC. Their patches come out with the JAX package's feature order,
channel-major (c, kh, kw), and their rows in its (n, h, w) order, so the
A and G factors are the JAX package's element for element.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from kfac_tpu_torch.ops import cov_ema
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib


def pads_rows(x: torch.Tensor) -> bool:
    """Whether :func:`with_column` builds ``x``'s augmented rows in padded
    rows: those of a bf16 or f16 CUDA tensor, which the 16-bit covariance
    kernel's TMA loads read only where each row starts on 16 bytes (a
    513- or 2049-value row does not)."""
    return x.device.type == 'cuda' and x.dtype in sym_cov_lib.HALF


def with_column(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``torch.cat([x, col], dim=-1)`` of a 2-D ``x`` and an (n, 1)
    ``col``; where :func:`pads_rows`, written into the (n, d + 1) view of
    rows rounded up to ``sym_cov.ROW_PAD16`` values (the same values),
    which ``sym_cov`` then reads without a copy."""
    if not pads_rows(x):
        return torch.cat([x, col], dim=-1)
    n, d = x.shape
    out = sym_cov_lib.kernel_rows(n, d + 1, x.dtype, x.device, padded=True)
    return torch.cat([x, col], dim=-1, out=out)


def append_bias_ones(x: torch.Tensor) -> torch.Tensor:
    """Append a column of ones to the last dimension of ``x`` (a matrix's
    by :func:`with_column`)."""
    ones = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
    if x.ndim == 2:
        return with_column(x, ones)
    return torch.cat([x, ones], dim=-1)


def get_cov(
    a: torch.Tensor,
    b: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Empirical second moment of a 2D tensor: ``a^T @ (b or a) / scale``.

    A self-covariance of a CUDA tensor always goes through the triangular
    kernel (exactly symmetric by construction; a bf16 or f16 ``a`` in the
    layout it has, which the kernel copies only where TMA cannot read its
    rows); on the CPU it is the plain ``(C + C^T)/2`` form of the JAX
    package.
    """
    if a.ndim != 2:
        raise ValueError(f'expected 2D tensor, got shape {tuple(a.shape)}')
    if b is not None and a.shape != b.shape:
        raise ValueError(f'shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}')
    if scale is None:
        scale = a.shape[0]
    if b is None:
        if a.device.type == 'cuda':
            return sym_cov_lib.sym_cov(a if a.dtype in sym_cov_lib.HALF else a.contiguous(), scale)
        cov = a.T @ (a / scale)
        return (cov + cov.T) / 2.0
    return a.T @ (b / scale)


def _cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def linear_a_rows(a: torch.Tensor, has_bias: bool, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A dense layer's A rows: its input's flattened leading dims (cast to
    ``dtype`` first, when given), with a bias column of ones."""
    a = _cast(a, dtype).reshape(-1, a.shape[-1])
    return append_bias_ones(a) if has_bias else a


def linear_a_factor(
    a: torch.Tensor, has_bias: bool, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """A factor of a dense layer from its input: rows are the flattened
    leading dims, with a bias column of ones. With ``dtype`` the input is
    cast to it first, so the covariance is computed and returned in it (the
    helpers' ``factor_dtype``), as in the JAX package."""
    return get_cov(linear_a_rows(a, has_bias, dtype))


def linear_g_factor(g: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """G factor of a dense layer from the loss gradient w.r.t. its output
    (cast to ``dtype`` first, when given)."""
    g = _cast(g, dtype).reshape(-1, g.shape[-1])
    return get_cov(g)


def add_cov(acc: torch.Tensor | None, rows: torch.Tensor) -> torch.Tensor:
    """``acc + rows^T rows / n`` for a running sum of covariances (None:
    the first, ``get_cov(rows)``): on the card the later ones go through
    the fused kernel ``sym_cov_ema`` with beta 1 (one launch, no separate
    add), f32 only; else the covariance and an add."""
    if acc is None:
        return get_cov(rows)
    if rows.dtype == torch.float32 and acc.dtype == torch.float32:
        return cov_ema.sym_cov_ema(acc, rows.contiguous(), 1.0, 1.0 / rows.shape[0])
    return acc + get_cov(rows)


def live_rows(x: torch.Tensor) -> torch.Tensor:
    """1.0 for each row of the 2-D ``x`` with a nonzero entry, else 0.0, in
    ``x``'s dtype: the rows a routed layer's expert actually received
    (unrouted rows are exactly zero)."""
    return (torch.amax(torch.abs(x), dim=-1) > 0).to(x.dtype)


def routed_linear_a_factor(
    a: torch.Tensor, has_bias: bool, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """A factor of a row-masked (MoE-routed) dense layer over its live rows
    only: the bias one goes on live rows alone and the covariance is
    normalized by the live count (floored at 1), so the factor is the one
    the routed tokens alone give. An all-zero input gives zeros. The count
    and the rescale stay on the device; the covariance is :func:`get_cov`.

    A routed row whose input is exactly zero counts as unrouted, as in the
    JAX package (its caveat for dead activations). ``dtype``: as
    :func:`linear_a_factor`'s."""
    a = _cast(a, dtype).reshape(-1, a.shape[-1])
    nz = live_rows(a)
    n = torch.clamp(torch.sum(nz), min=1.0)
    if has_bias:
        a = with_column(a, nz[:, None])
    return get_cov(a) * (a.shape[0] / n)


def routed_live_fraction(a: torch.Tensor) -> torch.Tensor:
    """The fraction of rows with a nonzero entry, a 0-d f32 tensor: a
    routed capture's evidence weight (0 for an expert that got no token),
    counted by the same row test as the routed factors."""
    a = a.reshape(-1, a.shape[-1])
    return torch.mean((torch.amax(torch.abs(a), dim=-1) > 0).float())


def routed_linear_g_factor(g: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """G factor normalized by the count of rows with a nonzero cotangent
    (floored at 1): the routed tokens' rows (cast to ``dtype`` first, when
    given)."""
    g = _cast(g, dtype).reshape(-1, g.shape[-1])
    n = torch.clamp(torch.sum(live_rows(g)), min=1.0)
    return get_cov(g) * (g.shape[0] / n)


# ((top, bottom), (left, right)) zero padding of an image's two spatial dims
Pads = tuple[tuple[int, int], tuple[int, int]]
# 'SAME', 'VALID' or explicit pairs, as flax's ``nn.Conv`` takes them
Padding = Union[str, Sequence[Sequence[int]]]


def same_padding(
    in_hw: Sequence[int], kernel_size: Sequence[int], strides: Sequence[int]
) -> Pads:
    """Flax's (XLA's) SAME padding of an undilated conv: the output keeps
    ``ceil(in / stride)`` positions, and of the ``total`` pad a dim needs
    ``total // 2`` goes before and the rest after. Under stride 2 an even
    input is padded (0, 1) by a 3x3 kernel, not (1, 1)."""
    pads = []
    for size, k, s in zip(in_hw, kernel_size, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_padding(
    padding: Padding,
    in_hw: Sequence[int],
    kernel_size: Sequence[int],
    strides: Sequence[int],
) -> Pads:
    """Explicit pairs for ``padding`` on an input of spatial size
    ``in_hw``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == 'SAME':
            return same_padding(in_hw, kernel_size, strides)
        if mode == 'VALID':
            return ((0, 0), (0, 0))
        raise ValueError(f'padding {padding!r} is not SAME, VALID or pairs')
    (t, b), (l, r) = padding
    return ((int(t), int(b)), (int(l), int(r)))


def extract_patches(
    x: torch.Tensor,
    kernel_size: Sequence[int],
    strides: Sequence[int],
    padding: Padding,
) -> torch.Tensor:
    """im2col of an NCHW image -> (batch, out_h, out_w, c * kh * kw), the
    layout of ``kfac_tpu.ops.cov.extract_patches_nhwc``: features
    channel-major (c, kh, kw), as ``lax.conv_general_dilated_patches``
    gives them. The windows are a strided view of the padded image, copied
    once into that layout (``F.unfold`` on a CUDA tensor launches one
    im2col kernel an image: 256 a layer at the bench's ResNet batch)."""
    (t, b), (l, r) = resolve_padding(padding, x.shape[-2:], kernel_size, strides)
    (kh, kw), (sh, sw) = kernel_size, strides
    windows = F.pad(x, (l, r, t, b)).unfold(2, kh, sh).unfold(3, kw, sw)  # (n, c, oh, ow, kh, kw)
    n, c, oh, ow = windows.shape[:4]
    return windows.permute(0, 2, 3, 1, 4, 5).reshape(n, oh, ow, c * kh * kw)


def conv2d_a_factor(
    a: torch.Tensor,
    kernel_size: Sequence[int],
    strides: Sequence[int],
    padding: Padding,
    has_bias: bool,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """A factor of a 2-D conv from its NCHW input (before any padding):
    patch rows, with a bias column of ones, divided by the spatial output
    size before the covariance, as the JAX package divides them (the
    factor then carries 1 / spatial^2). ``dtype``: as
    :func:`linear_a_factor`'s."""
    patches = extract_patches(_cast(a, dtype), kernel_size, strides, padding)
    spatial_size = patches.shape[1] * patches.shape[2]
    rows = patches.reshape(-1, patches.shape[-1])
    if has_bias:
        rows = append_bias_ones(rows)
    rows = rows / spatial_size
    return get_cov(rows)


def conv2d_g_factor(g: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """G factor of a 2-D conv from the loss gradient w.r.t. its NCHW
    output: rows in (n, h, w) order, divided by h * w (cast to ``dtype``
    first, when given)."""
    g = _cast(g, dtype)
    spatial_size = g.shape[2] * g.shape[3]
    rows = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
    rows = rows / spatial_size
    return get_cov(rows)
