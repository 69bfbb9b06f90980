"""LoRA adapter modules (counterpart of ``kfac_tpu/models/lora.py``).

A :class:`LoRADense` adds a trainable low-rank update to a (frozen) base
projection, ``base(x) + up(down(x)) * (alpha / rank)`` (Hu et al. 2021).
Its class attribute ``_kfac_lora_unit`` makes
:func:`kfac_tpu_torch.register_model` register the adapter pair as one
unit with block-diagonal factors
(:class:`kfac_tpu_torch.layers.helpers.LoRAHelper`); the base projection
is never registered (freeze it with the trainability ``mask``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class LoRADense(nn.Module):
    """Dense layer with a low-rank trainable adapter.

    ``base`` is ``nn.Linear(in_features, features, bias=use_bias)``,
    ``down`` ``nn.Linear(in_features, rank)`` and ``up`` ``nn.Linear(rank,
    features)``, both bias-free; the update is scaled by ``alpha / rank``.
    ``up`` starts at zero, so the module first computes exactly
    ``base(x)``; ``base`` and ``down`` start from flax's LeCun-normal
    kernels (drawn from ``generator`` when given) and a zero bias.
    """

    # read by the registry (duck-typed: it never imports model code)
    _kfac_lora_unit = True

    def __init__(
        self,
        in_features: int,
        features: int,
        rank: int = 8,
        alpha: float = 16.0,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.features = features
        self.rank = rank
        self.alpha = alpha
        self.base = nn.Linear(in_features, features, bias=use_bias)
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, features, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for mod in (self.base, self.down):
            std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if self.base.bias is not None:
            self.base.bias.zero_()
        self.up.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.base(x) + self.up(self.down(x)) * (self.alpha / self.rank)
