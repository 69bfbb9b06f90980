"""Shadow slots and slice planning of the async refresh (counterpart of
``kfac_tpu/async_inverse/slots.py``).

Every decomposition field of the engine state (``qa``/``qg``/``da``/
``dg``/``dgda`` or ``a_inv``/``g_inv``) has a shadow twin of the same
shape. Slices write into the shadow; the boundary swap promotes a
complete, finite, non-quarantined shadow into the active slots, so a step
never applies a half-written decomposition.

The shadow is ephemeral: checkpoints persist only the step, the factors
and the health counters, and a restore rebuilds the active decompositions
(``rematerialize``) and an empty shadow. The first boundary after a
mid-window restore then finds ``progress`` below the slice count and skips
the swap.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

FIELDS = ('qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')


@dataclasses.dataclass
class ShadowSlots:
    """Shadow twins of the decomposition fields (layer-keyed dicts; unused
    fields empty), ``progress``: slices completed since the last boundary,
    a host int (the step counter is one, so the completeness gate reads
    nothing from the device), and ``damping``: the damping the shadow was
    built at."""

    qa: dict[str, torch.Tensor]
    qg: dict[str, torch.Tensor]
    da: dict[str, torch.Tensor]
    dg: dict[str, torch.Tensor]
    dgda: dict[str, torch.Tensor]
    a_inv: dict[str, torch.Tensor]
    g_inv: dict[str, torch.Tensor]
    progress: int = 0
    damping: float = 0.0


def empty_shadow(fields: dict[str, dict[str, torch.Tensor]]) -> ShadowSlots:
    """A zeroed shadow mirroring ``fields`` (field name -> layer-keyed
    tensors); fields not given are empty, ``progress`` is 0."""
    return ShadowSlots(**{
        f: {k: torch.zeros_like(v) for k, v in fields.get(f, {}).items()}
        for f in FIELDS
    })


def plan_slices(units: list[tuple[Any, float]], n_slices: int) -> list[list[Any]]:
    """Greedy longest-processing-time balance of ``[(key, cost)]`` refresh
    units into at most ``n_slices`` slices (never more than there are
    units; empty slices dropped). Ties break on the key's ``repr``, then
    on insertion order, as in the JAX package, so both plan alike."""
    if n_slices < 1:
        raise ValueError(f'n_slices must be >= 1, got {n_slices}')
    n_slices = min(n_slices, len(units)) or 1
    order = sorted(enumerate(units), key=lambda iu: (-iu[1][1], repr(iu[1][0]), iu[0]))
    loads = [0.0] * n_slices
    slices: list[list[Any]] = [[] for _ in range(n_slices)]
    for _, (key, cost) in order:
        tgt = min(range(n_slices), key=lambda i: (loads[i], i))
        slices[tgt].append(key)
        loads[tgt] += cost
    return [s for s in slices if s]
