"""Partition-friendly loss math (counterpart of ``kfac_tpu/ops/losses.py``).

The target logit is taken by a one-hot masked sum rather than a gather, so
a vocab-parallel ``lm_head`` keeps every vocab-axis operation a local
elementwise op plus a reduction: with a ``group`` the max, the sum of
exps and the target logit are each reduced over it (Megatron's
vocab-parallel cross-entropy), and the logits are never gathered.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F


def vocab_parallel_nll(
    logits: torch.Tensor,
    targets: torch.Tensor,
    group: Any = None,
    vocab_start: int = 0,
) -> torch.Tensor:
    """Per-token negative log-likelihood in f32: ``(..., V), (...) -> (...)``.

    Numerically the stable ``-log_softmax(logits)[targets]``; the max shift
    is detached (its gradient contributions cancel). With ``group`` the
    logits are this rank's vocab shard, entries ``[vocab_start,
    vocab_start + V)``: the max is all-reduced, and the sum of exps and the
    target logit are summed over the group (forward; the identity
    backward), so the loss and its gradients are the unsharded ones.
    """
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    shifted = logits - m
    if group is None:
        onehot = F.one_hot(targets, logits.shape[-1]).to(logits.dtype)
    else:  # the targets in this shard
        local = targets - vocab_start
        inside = (local >= 0) & (local < logits.shape[-1])
        onehot = F.one_hot(torch.where(inside, local, 0), logits.shape[-1]).to(logits.dtype)
        onehot = onehot * inside[..., None].to(logits.dtype)
    sum_exp = torch.exp(shifted).sum(dim=-1)
    target_shifted = (shifted * onehot).sum(dim=-1)
    if group is not None:
        from kfac_tpu_torch.parallel import collectives

        sum_exp = collectives.reduce_from_model(sum_exp, group)
        target_shifted = collectives.reduce_from_model(target_shifted, group)
    # both terms stay in shifted space (the m's cancel algebraically)
    return torch.log(sum_exp) - target_shifted
