"""Configuration of the asynchronous (double-buffered) inverse refresh
(counterpart of ``kfac_tpu/async_inverse/config.py``).

The engine already applies each decomposition for a whole
``inv_update_steps`` window. Async refresh keeps that staleness and moves
the refresh off the boundary step: the window's decompositions are built
into a *shadow* slot while the active ones are applied, and the shadow is
swapped in at the next boundary. The active decompositions are then one
window staler than the synchronous path's.

Two backends:

- ``'sliced'``: the window's decompositions are split into per-step slices
  balanced by their n^3 cost, run inside the engine's step with the same
  functions as the synchronous refresh, so a swapped shadow is bit for bit
  what the synchronous path computed one window earlier.
- ``'host'``: at each boundary the factors go to a host worker thread,
  which decomposes them with LAPACK while the card keeps stepping; the
  Trainer swaps the result in at the next boundary. The same maths, not
  the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

MODES = ('sliced', 'host')


@dataclasses.dataclass(frozen=True)
class AsyncInverseConfig:
    """Knobs of the async refresh.

    ``mode``: ``'sliced'`` or ``'host'``. ``max_slices``: a cap on the
    number of per-step slices in ``'sliced'`` mode (by default
    ``min(inv_update_steps, units)``); fewer slices finish the refresh
    earlier in the window at a higher per-step cost.
    """

    mode: str = 'sliced'
    max_slices: int | None = None

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f'unknown async_inverse mode {self.mode!r}; expected one '
                f'of {MODES}'
            )
        if self.max_slices is not None and self.max_slices < 1:
            raise ValueError(
                f'max_slices must be >= 1 (or None), got {self.max_slices}'
            )


def as_async_config(value: Any) -> AsyncInverseConfig | None:
    """Normalise ``async_inverse=``: None or False (off), a mode string,
    True (sliced defaults), or an :class:`AsyncInverseConfig`."""
    if value is None or value is False:
        return None
    if value is True:
        return AsyncInverseConfig()
    if isinstance(value, str):
        return AsyncInverseConfig(mode=value)
    if isinstance(value, AsyncInverseConfig):
        return value
    raise TypeError(
        'async_inverse must be an AsyncInverseConfig, a mode string '
        f'({MODES}), True, False, or None; got {value!r}'
    )
