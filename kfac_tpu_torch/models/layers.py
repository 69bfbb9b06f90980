"""Flax's convolution padding and BatchNorm, and its compute ``dtype`` of
dense and conv layers, in PyTorch (the building blocks of
``models/resnet.py``, of the accuracy gate's CNN and of the reduced-precision
models).

- :class:`CastLinear` is ``nn.Linear`` computing in ``dtype``, as flax's
  ``nn.Dense(dtype=...)`` with f32 parameters: the parameters stay the f32
  masters, the input and the parameters are cast to ``dtype``, the product
  is rounded to it and the bias added in it.
- :class:`SameConv2d` pads by flax's SAME rule (``ops.cov.same_padding``),
  which is asymmetric under stride 2: a 3x3 stride-2 conv on 32 px pads
  (0, 1), where ``nn.Conv2d(padding=1)`` pads (1, 1).
- :class:`BatchNorm` is flax's ``nn.BatchNorm`` (momentum 0.9, epsilon
  1e-5): the running variance takes the biased batch variance, and the
  running statistics live outside the module, in a ``model_state`` dict
  keyed by the flax ``batch_stats`` path ('stage0_block0/bn1'), so the
  Trainer carries them as the JAX Trainer carries ``batch_stats``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.ops import cov


class CastLinear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax's ``nn.Dense(dtype=...)``
    with f32 parameters): ``x @ W.T`` of the input and weight cast to
    ``dtype``, rounded to it, then the bias in ``dtype`` added. The
    registry takes it as any ``nn.Linear``; the capture sees its input as
    the caller gave it and the cotangent of its ``dtype`` output, as the
    JAX capture does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = x.to(dt) @ self.weight.to(dt).T
        return y if self.bias is None else y + self.bias.to(dt)


def dense_layer(dtype: torch.dtype):
    """The dense layer class of a model computing in ``dtype``: plain
    ``nn.Linear`` in f32, else :class:`CastLinear` in ``dtype``."""
    if dtype == torch.float32:
        return nn.Linear
    return lambda *args, **kwargs: CastLinear(*args, **kwargs, dtype=dtype)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's SAME zero padding, resolved on each
    input's spatial size; the registry pairs it with a ``Conv2dHelper``
    whose patches pad the same way. With ``dtype`` it computes in it, as
    flax's ``nn.Conv(dtype=...)``: input, kernel and bias cast, f32
    parameters kept."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | tuple[int, int],
        stride: int | tuple[int, int] = 1,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=0, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = cov.same_padding(x.shape[-2:], self.kernel_size, self.stride)
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._conv_forward(F.pad(x, (l, r, t, b)), self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(F.pad(x.to(dt), (l, r, t, b)), self.weight.to(dt), bias)


class BatchStats:
    """One forward's batch-statistics context: ``state`` the running
    statistics read (``{path: {'mean', 'var'}}``), ``new`` those written
    (with ``train``), ``train`` whether to normalise by the batch."""

    def __init__(self, state: dict[str, dict[str, torch.Tensor]], train: bool):
        self.state = state
        self.train = train
        self.new: dict[str, dict[str, torch.Tensor]] = {}


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channels of NCHW input:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` with ``var =
    max(E[x^2] - E[x]^2, 0)`` (flax's fast variance) over the batch when
    training, the running statistics otherwise; the running statistics
    move as ``momentum * old + (1 - momentum) * batch``.

    ``path`` is the key of its statistics in the model state (the model
    sets it). Under a data-parallel engine the Trainer calls
    :func:`sync_batch_norms` with its grid: the batch moments are then the mean over the
    ranks of each rank's (one autograd-aware ``all_reduce`` a layer), the
    global batch's moments, as pjit gives them to the JAX model.
    """

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5, scale_init: float = 1.0):
        super().__init__()
        self.features, self.momentum, self.eps = features, momentum, eps
        self.weight = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.path = ''
        self.group: Any = None
        self.synced = False

    def initial_stats(self, device: torch.device) -> dict[str, torch.Tensor]:
        return {
            'mean': torch.zeros(self.features, device=device),
            'var': torch.ones(self.features, device=device),
        }

    def forward(self, x: torch.Tensor, stats: BatchStats) -> torch.Tensor:
        old = stats.state[self.path]
        if stats.train:
            mean, mean2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
            if self.synced:
                from torch.distributed.nn import functional as dist_fn

                world = dist.get_world_size(self.group)
                moments = dist_fn.all_reduce(
                    torch.stack([mean, mean2]), group=self.group
                ) / world
                mean, mean2 = moments[0], moments[1]
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            stats.new[self.path] = {
                'mean': m * old['mean'] + (1 - m) * mean.detach(),
                'var': m * old['var'] + (1 - m) * var.detach(),
            }
        else:
            mean, var = old['mean'], old['var']
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def name_batch_norms(model: nn.Module) -> None:
    """Set each :class:`BatchNorm`'s ``path`` to its module path joined
    with '/', the flax ``batch_stats`` path."""
    for prefix, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.path = prefix.replace('.', '/')


def initial_model_state(model: nn.Module, device: str | torch.device) -> dict[str, dict[str, torch.Tensor]]:
    """The running statistics flax's ``init`` gives: zeros and ones."""
    return {
        mod.path: mod.initial_stats(torch.device(device))
        for mod in model.modules() if isinstance(mod, BatchNorm)
    }


def sync_batch_norms(model: nn.Module, mesh: Any) -> None:
    """Take every :class:`BatchNorm`'s batch moments over the ranks of
    ``mesh`` (a ``KaisaGrid``: its ``group``), or over this process's batch
    alone with ``mesh=None``."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = None if mesh is None else mesh.group
            mod.synced = mesh is not None
