"""Dense causal attention (counterpart of the dense path of
``kfac_tpu/models/attention.py``; ring and zigzag attention come in a later
slice).
"""

from __future__ import annotations

import torch

from kfac_tpu_torch.ops import flash_attention


def dense_causal_attention(q, k, v):
    """Single-device causal attention: (B, S, H, D) -> (B, S, H, D).

    Always the flash partials: on a CUDA tensor that is the kernel, on a
    CPU tensor the plain einsum partials.
    """
    out = _finish(flash_attention.flash_attention_partials(q, k, v, 0, 0, True))
    return out.to(q.dtype)


def _merge(carry, blk):
    """Log-sum-exp merge of two blockwise-softmax partials (flash form)."""
    acc, m, l = carry
    blk_acc, blk_m, blk_l = blk
    new_m = torch.maximum(m, blk_m)
    scale_old = torch.exp(m - new_m)
    scale_blk = torch.exp(blk_m - new_m)
    l = l * scale_old + blk_l * scale_blk
    acc = (
        acc * scale_old.transpose(1, 2)[..., None]
        + blk_acc * scale_blk.transpose(1, 2)[..., None]
    )
    return acc, new_m, l


def _finish(carry):
    """Normalize accumulated blockwise output (guarding fully-masked rows)."""
    acc, _, l = carry
    denom = torch.where(l == 0.0, 1.0, l)
    return acc / denom.transpose(1, 2)[..., None]
