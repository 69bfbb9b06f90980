"""Dynamic loss scaling for float16 K-FAC training (counterpart of
``kfac_tpu/amp.py``).

The scaler is two 0-d tensors on the device, carried through the loop:
scale the loss, unscale the grads (:func:`unscale`) and the captured
statistics (:meth:`kfac_tpu_torch.layers.capture.CapturedStats.scaled`:
G is quadratic in the cotangents, so it divides by ``scale**2``), apply
the step only where :func:`all_finite`, then :func:`update`.
``kfac_tpu_torch/examples/train_amp.py`` is the whole loop.

bfloat16 keeps float32's exponent range and needs no scaling; this module
serves float16 pipelines. The schedule is ``torch.cuda.amp.GradScaler``'s
by default: init 2**16, backoff 0.5 on an overflow, growth 2.0 after 2000
consecutive good steps. Nothing here reads a value on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from kfac_tpu_torch.device import resolve_device


@dataclasses.dataclass
class GradScaler:
    """Dynamic loss-scale state: ``scale``, the loss multiplier (0-d f32),
    and ``good_steps``, the overflow-free steps since the last change of
    scale (0-d int32), both on the device."""

    scale: torch.Tensor
    good_steps: torch.Tensor


def init(init_scale: float = 2.0**16, device: str | torch.device = 'cuda') -> GradScaler:
    """A fresh scaler at ``init_scale`` on ``device`` (``'cuda'`` unless
    the caller passes another)."""
    device = resolve_device(device)
    return GradScaler(
        scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
    )


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool on the device: every tensor leaf of ``tree`` is free of
    inf and NaN (True for a tree with no leaf)."""
    leaves = [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def unscale(tree: Any, scale: torch.Tensor) -> Any:
    """Every tensor leaf times ``1 / scale`` (the grads of a scaled loss)."""
    inv = 1.0 / scale
    return pytree.tree_map(lambda g: g * inv if isinstance(g, torch.Tensor) else g, tree)


def update(
    scaler: GradScaler,
    finite: torch.Tensor,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    growth_interval: int = 2000,
) -> GradScaler:
    """The scaler after a step: the scale halves (``backoff_factor``) on an
    overflow and doubles (``growth_factor``) after ``growth_interval``
    consecutive good steps, where the count starts again; torch
    ``GradScaler`` semantics, on the device."""
    good = scaler.good_steps + 1
    grow = good >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, scaler.scale * growth_factor, scaler.scale),
        scaler.scale * backoff_factor,
    )
    new_good = torch.where(finite & ~grow, good, torch.zeros_like(good))
    return GradScaler(scale=new_scale.float(), good_steps=new_good.to(torch.int32))
