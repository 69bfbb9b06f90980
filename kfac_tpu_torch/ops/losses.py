"""Partition-friendly loss math (counterpart of ``kfac_tpu/ops/losses.py``).

The target logit is taken by a one-hot masked sum rather than a gather, so
a later vocab-parallel ``lm_head`` keeps every vocab-axis operation a local
elementwise op plus a reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def vocab_parallel_nll(
    logits: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Per-token negative log-likelihood in f32: ``(..., V), (...) -> (...)``.

    Numerically the stable ``-log_softmax(logits)[targets]``; the max shift
    is detached (its gradient contributions cancel).
    """
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    onehot = F.one_hot(targets, logits.shape[-1]).to(logits.dtype)
    # both terms stay in shifted space (the m's cancel algebraically)
    lse_shifted = torch.log(torch.exp(shifted).sum(dim=-1))
    target_shifted = (shifted * onehot).sum(dim=-1)
    return lse_shifted - target_shifted
