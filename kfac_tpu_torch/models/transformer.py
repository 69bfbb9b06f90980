"""Decoder-only Transformer LM (counterpart of
``kfac_tpu/models/transformer.py``, with its switch-MoE blocks; without
ring attention or remat).

Module and parameter names follow the flax module paths (``block0``,
``attn.q_proj``, ``mlp_up``, ...) so that layers pair one to one with the
JAX package's, and ``kfac_tpu_torch.convert.from_flax_params`` loads flax
weights directly. LayerNorm epsilon is flax's 1e-6 and the GELU is the tanh
approximation, as in ``flax.linen``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.models import attention as attention_lib
from kfac_tpu_torch.models import moe as moe_lib
from kfac_tpu_torch.ops import losses

LN_EPS = 1e-6


class CausalSelfAttention(nn.Module):
    """Causal multi-head attention; q/k/v/out are K-FAC dense layers."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        head_dim = d // self.num_heads

        def split(t):
            return t.view(*t.shape[:-1], self.num_heads, head_dim)

        q = split(self.q_proj(x))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        out = attention_lib.dense_causal_attention(q, k, v)
        return self.out_proj(out.reshape(*x.shape[:-1], d))


class Block(nn.Module):
    """Pre-norm transformer block with a dense GELU MLP, or with a switch
    MoE (``moe``, :class:`~kfac_tpu_torch.models.moe.MoEMLP`) when
    ``num_experts > 0``."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        mlp_ratio: int = 4,
        num_experts: int = 0,
        moe_capacity_factor: float | None = None,
    ):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        if num_experts > 0:
            self.moe = moe_lib.MoEMLP(d_model, num_experts, mlp_ratio, moe_capacity_factor)
        else:
            self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model)
            self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = self.ln2(x)
        if hasattr(self, 'moe'):
            return x + self.moe(y)
        h = F.gelu(self.mlp_up(y), approximate='tanh')
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """GPT-style causal LM over token ids (B, S) -> logits (B, S, V).

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` with flax's initializers (LeCun-normal dense kernels, zero
    biases, unit-normal embedding, normal(0.02) positions), then moved to
    ``device`` (``'cuda'`` unless the caller passes another).

    With ``num_experts > 0`` every ``moe_every``-th block (blocks
    ``moe_every - 1``, ``2 * moe_every - 1``, ...) has a switch MoE in
    place of its MLP, with ``moe_capacity_factor`` (None: the dense masked
    dispatch), as the JAX model's.
    """

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 512,
        num_heads: int = 8,
        num_layers: int = 6,
        mlp_ratio: int = 4,
        max_len: int = 2048,
        seed: int = 0,
        device: str | torch.device = 'cuda',
        num_experts: int = 0,
        moe_every: int = 2,
        moe_capacity_factor: float | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        for i in range(num_layers):
            # moe_every <= 0 means no MoE blocks, as num_experts = 0
            is_moe = num_experts > 0 and moe_every > 0 and (i + 1) % moe_every == 0
            self.add_module(f'block{i}', Block(
                d_model, num_heads, mlp_ratio, num_experts if is_moe else 0,
                moe_capacity_factor,
            ))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with flax's defaults."""
        self.embed.weight.normal_(0.0, 1.0, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # lecun_normal: truncated normal at +-2 std, variance 1/fan_in
                std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(
                    mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator
                )
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        seq = tokens.shape[-1]
        x = self.embed(tokens) + self.pos_embed[:seq]
        for i in range(self.num_layers):
            x = getattr(self, f'block{i}')(x)
        x = self.ln_f(x.float())
        return self.lm_head(x)


def moe_layers(model: nn.Module) -> list[moe_lib.MoEMLP]:
    """The model's MoE modules, in module order."""
    return [m for m in model.modules() if isinstance(m, moe_lib.MoEMLP)]


def lm_loss(model: TransformerLM, load_balance_weight: float = 0.0):
    """Next-token cross-entropy of ``model``: ``loss_fn((tokens, targets))``;
    with ``load_balance_weight``, plus that weight times the sum over the
    MoE blocks of :func:`~kfac_tpu_torch.models.moe.load_balance_loss` of
    the same forward's routing."""
    moes = moe_layers(model) if load_balance_weight else []

    def loss_fn(batch) -> torch.Tensor:
        tokens, targets = batch
        loss = torch.mean(losses.vocab_parallel_nll(model(tokens), targets))
        for m in moes:
            aux = moe_lib.load_balance_loss(m.router_probs, m.expert_index, m.num_experts)
            loss = loss + load_balance_weight * aux
        return loss

    return loss_fn
