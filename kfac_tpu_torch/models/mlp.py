"""Configurable MLP (counterpart of ``kfac_tpu/models/mlp.py``).

Modules carry flax's names (``dense0``, ``dense1``, ..., ``head``), so the
registry's layer names are the JAX package's and
``kfac_tpu_torch.convert.from_flax_params`` loads flax weights directly.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.models import layers as layers_lib


class MLP(nn.Module):
    """Dense stack with ReLU: (B, ...) -> flattened -> logits (B,
    ``num_classes``).

    ``in_features`` is the flattened input width (flax infers it at
    ``init``). Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` with flax's defaults
    (LeCun-normal kernels, zero biases), then moved to ``device``
    (``'cuda'`` unless the caller passes another). ``dtype`` is the dense
    layers' compute dtype (``models.layers.CastLinear`` off f32); the
    logits come out in it.
    """

    def __init__(
        self,
        in_features: int,
        features: Sequence[int] = (128, 128),
        num_classes: int = 10,
        seed: int = 0,
        device: str | torch.device = 'cuda',
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_hidden = len(features)
        linear = layers_lib.dense_layer(dtype)
        width = in_features
        for i, f in enumerate(features):
            self.add_module(f'dense{i}', linear(width, f))
            width = f
        self.head = linear(width, num_classes)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with flax's defaults:
        lecun_normal kernels (a normal truncated at +-2 std, variance
        1/fan_in) and zero biases."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(
                    mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator
                )
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f'dense{i}')(x))
        return self.head(x)
