"""Hyperparameter resolution for :class:`KFACPreconditioner`.

Every hyperparameter is a constant or a callable of the step counter. The
step counter is a host integer in this port, so a schedule is a plain
Python function of an ``int``.
"""

from __future__ import annotations

from typing import Callable

ScalarOrSchedule = float | Callable[[int], float]


def resolve(value: ScalarOrSchedule, step: int) -> float:
    """Callable-or-constant hyperparameter, resolved at ``step``."""
    if callable(value):
        return value(step)
    return value
