"""Mixture-of-Experts MLP with per-expert K-FAC factors (counterpart of
``kfac_tpu/models/moe.py``).

Every expert's projections are ordinary ``nn.Linear`` children named as
flax names them (``router``, ``expert{e}_up``, ``expert{e}_down``), so
each registers as its own K-FAC layer; register the experts with
``routed_layers=[r'.*expert\\d+_(up|down)']`` for the exact per-expert
statistics (live rows only, traffic-weighted EMAs).

Dispatch is top-1 (switch): the router's softmax, its first maximum
(``torch.argmax`` and ``jnp.argmax`` both take the first), the gate the
chosen probability. Two paths share the parameters:

- ``capacity_factor=None``: dense masked dispatch, every expert sees every
  token row with the unrouted ones zeroed (E times the FFN FLOPs);
- ``capacity_factor=c``: each expert gets a static buffer of ``C =
  ceil(c * T / E)`` slots, filled in arrival order over the row-major
  flattened (B, S) tokens; a token past its expert's capacity is dropped
  (residual passthrough). The JAX package fills and drains the buffers by
  one-hot einsums; here each slot's token index gathers the rows into the
  buffer (``index_select``) and adds them back (``index_add``), which
  gives the same values exactly (one nonzero term a slot, no two slots on
  one token) with static shapes and no host read.

In both paths unrouted rows and empty slots are zeroed before the up
projection and again after its GELU (flax's tanh form), so the up bias
cannot leak into the down projection or its factor.

The router's probabilities and expert index of the last forward stay on
the module (``router_probs``, ``expert_index``; flax sows them), for
:func:`load_balance_loss`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class MoEMLP(nn.Module):
    """Top-1 (switch) routed MLP of ``num_experts`` FFNs over ``d_model``."""

    def __init__(
        self,
        d_model: int,
        num_experts: int,
        mlp_ratio: int = 4,
        capacity_factor: float | None = None,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(d_model, num_experts)
        for e in range(num_experts):
            self.add_module(f'expert{e}_up', nn.Linear(d_model, mlp_ratio * d_model))
            self.add_module(f'expert{e}_down', nn.Linear(mlp_ratio * d_model, d_model))
        self.router_probs: torch.Tensor | None = None
        self.expert_index: torch.Tensor | None = None

    def expert(self, e: int) -> tuple[nn.Linear, nn.Linear]:
        return getattr(self, f'expert{e}_up'), getattr(self, f'expert{e}_down')

    def capacity(self, tokens: int) -> int:
        """Slots an expert for ``tokens`` tokens: ``ceil(capacity_factor *
        tokens / num_experts)``, at least 1."""
        return max(1, math.ceil(self.capacity_factor * tokens / self.num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(self.router(x).float(), dim=-1)
        idx = torch.argmax(probs, dim=-1)  # (B, S)
        gate = torch.gather(probs, -1, idx[..., None]).to(x.dtype)
        self.router_probs, self.expert_index = probs, idx
        if self.capacity_factor is not None:
            return self._capacity_dispatch(x, idx) * gate
        out = torch.zeros_like(x)
        for e in range(self.num_experts):
            up, down = self.expert(e)
            mask = (idx == e).to(x.dtype)[..., None]
            h = F.gelu(up(x * mask), approximate='tanh') * mask
            out = out + down(h) * mask
        return out * gate

    def slots(self, idx: torch.Tensor, cap: int) -> torch.Tensor:
        """(T, E) slot of each flat token in each expert's buffer: its
        arrival rank among the expert's tokens, -1 where it is not routed
        there or arrived past ``cap``."""
        onehot = F.one_hot(idx.reshape(-1), self.num_experts)
        pos = torch.cumsum(onehot, dim=0) * onehot - 1
        return torch.where(pos < cap, pos, -1)

    def _capacity_dispatch(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        t = math.prod(x.shape[:-1])
        cap = self.capacity(t)
        pos = self.slots(idx, cap)
        # padded row t is zero: an empty slot gathers it, and writes its
        # output there, which is cut off
        xf = torch.cat([x.reshape(t, d), x.new_zeros((1, d))])
        tokens = torch.arange(t, device=x.device)
        out = torch.zeros((t + 1, d), dtype=x.dtype, device=x.device)
        for e in range(self.num_experts):
            up, down = self.expert(e)
            # each slot's token (t for an empty one): dropped and unrouted
            # tokens all write the extra slot ``cap``, which is cut off
            slot = torch.where(pos[:, e] >= 0, pos[:, e], cap)
            src = torch.full((cap + 1,), t, dtype=tokens.dtype, device=x.device)
            src = src.scatter(0, slot, tokens)[:cap]
            used = (src < t).to(x.dtype)[:, None]  # (C, 1)
            h = F.gelu(up(xf.index_select(0, src)), approximate='tanh') * used
            out = out.index_add(0, src, down(h))
        return out[:t].reshape(x.shape)


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The Switch Transformer's auxiliary loss ``E * sum_e f_e * P_e``
    (f_e the fraction of tokens routed to expert e, P_e its mean router
    probability); 1 at uniform load."""
    f = F.one_hot(idx.reshape(-1), num_experts).float().mean(0)
    p = probs.reshape(-1, num_experts).mean(0)
    return num_experts * torch.sum(f * p)


def expert_tp_overrides() -> list[tuple[str, str]]:
    """Tensor-parallel override rules sharding every expert Megatron-style
    (up column-parallel, down row-parallel), for any expert index."""
    return [
        (r'.*expert\d+_up', 'column'),
        (r'.*expert\d+_down', 'row'),
    ]
