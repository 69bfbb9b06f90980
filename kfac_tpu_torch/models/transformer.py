"""Decoder-only Transformer LM (counterpart of
``kfac_tpu/models/transformer.py``, with its switch-MoE blocks and ring
attention; without remat).

With ``ring_mesh`` (a :class:`~kfac_tpu_torch.parallel.mesh.TrainGrid`)
and ``ring_axis='seq'`` each rank runs its sequence shard: the positions
are its shard's (``TrainGrid.seq_positions``) and attention is the ring
(or, with ``zigzag``, the zigzag ring) over the grid's ``seq_group``.
Sharded by ``parallel.tensor_parallel.shard_params`` the attention runs
each model rank's heads, and ``lm_loss`` of a vocab-sharded ``lm_head``
is the vocab-parallel NLL over the model group.

Module and parameter names follow the flax module paths (``block0``,
``attn.q_proj``, ``mlp_up``, ...) so that layers pair one to one with the
JAX package's, and ``kfac_tpu_torch.convert.from_flax_params`` loads flax
weights directly. LayerNorm epsilon is flax's 1e-6 and the GELU is the tanh
approximation, as in ``flax.linen``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.models import attention as attention_lib
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import moe as moe_lib
from kfac_tpu_torch.ops import losses

LN_EPS = 1e-6


class CausalSelfAttention(nn.Module):
    """Causal multi-head attention; q/k/v/out are K-FAC dense layers. With
    ``ring_axis`` the ring (``zigzag``: the zigzag ring) over
    ``ring_mesh``'s sequence shards, else the dense path; column-parallel
    q/k/v give it this model rank's heads."""

    def __init__(
        self, d_model: int, num_heads: int, ring_mesh: Any = None,
        ring_axis: str | None = None, zigzag: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        linear = layers_lib.dense_layer(dtype)
        self.q_proj = linear(d_model, d_model)
        self.k_proj = linear(d_model, d_model)
        self.v_proj = linear(d_model, d_model)
        self.out_proj = linear(d_model, d_model)
        self.attend = attention_lib.dense_causal_attention
        if ring_axis is not None:
            self.attend = attention_lib.make_context_parallel_attention(
                ring_mesh, ring_axis, causal=True, zigzag=zigzag
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def split(t):
            if t.shape[-1] % self.head_dim:
                raise ValueError(
                    f'{t.shape[-1]} features of q/k/v on this rank are not whole heads of '
                    f'{self.head_dim}: shard the heads over model only where model divides '
                    f'num_heads ({self.num_heads})'
                )
            return t.view(*t.shape[:-1], t.shape[-1] // self.head_dim, self.head_dim)

        q = split(self.q_proj(x))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        out = self.attend(q, k, v)
        return self.out_proj(out.reshape(*x.shape[:-1], q.shape[-2] * self.head_dim))


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
        ring_mesh: Any = None,
        ring_axis: str | None = None,
        zigzag: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads, ring_mesh, ring_axis, zigzag, dtype)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        if num_experts > 0:
            self.moe = moe_lib.MoEMLP(d_model, num_experts, mlp_ratio, moe_capacity_factor)
        else:
            linear = layers_lib.dense_layer(dtype)
            self.mlp_up = linear(d_model, mlp_ratio * d_model)
            self.mlp_down = linear(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the LayerNorms compute in f32, as flax's LayerNorm(dtype=f32)
        x = x + self.attn(self.ln1(x.float()))
        y = self.ln2(x.float())
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

    ``ring_mesh`` and ``ring_axis`` (``'seq'``) run the ring attention of
    the grid's sequence shards (the module docstring); ``zigzag`` (None:
    the grid's layout) must match the grid's sequence layout.

    ``dtype`` (f32, bf16 or f16) is the compute dtype of the blocks (the
    module docstring); MoE blocks and the ring forms run in f32 only.
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
        ring_mesh: Any = None,
        ring_axis: str | None = None,
        zigzag: bool | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        if dtype != torch.float32 and (num_experts > 0 or ring_axis is not None):
            raise NotImplementedError(
                f'TransformerLM(dtype={dtype}) with MoE blocks or ring attention is not '
                'ported to kfac_tpu_torch yet'
            )
        self.dtype = dtype
        self.num_layers = num_layers
        if zigzag is None:
            zigzag = bool(getattr(ring_mesh, 'zigzag', False))
        self.ring_mesh = ring_mesh if ring_axis is not None else None
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        for i in range(num_layers):
            # moe_every <= 0 means no MoE blocks, as num_experts = 0
            is_moe = num_experts > 0 and moe_every > 0 and (i + 1) % moe_every == 0
            self.add_module(f'block{i}', Block(
                d_model, num_heads, mlp_ratio, num_experts if is_moe else 0,
                moe_capacity_factor, ring_mesh, ring_axis, zigzag, dtype,
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

    def position_embedding(self, seq: int) -> torch.Tensor:
        """The position embeddings of the ``seq`` tokens this rank holds:
        its sequence shard's under ring attention, else the first
        ``seq``."""
        mesh = self.ring_mesh
        if mesh is None or mesh.seq == 1 and not mesh.zigzag:
            return self.pos_embed[:seq]
        return mesh.take_seq(self.pos_embed[:seq * mesh.seq], dim=0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = (self.embed(tokens) + self.position_embedding(tokens.shape[-1])).to(self.dtype)
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
        head = model.lm_head
        if getattr(head, 'parallel', None) == 'column':  # vocab-sharded
            per = head.weight.shape[0]
            nll = losses.vocab_parallel_nll(model(tokens), targets, head.group, head.index * per)
        else:
            nll = losses.vocab_parallel_nll(model(tokens), targets)
        loss = torch.mean(nll)
        for m in moes:
            aux = moe_lib.load_balance_loss(m.router_probs, m.expert_index, m.num_experts)
            loss = loss + load_balance_weight * aux
        return loss

    return loss_fn
