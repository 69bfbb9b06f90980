"""Hyperparameter resolution and schedules for :class:`KFACPreconditioner`
(counterpart of ``kfac_tpu/hyperparams.py``).

Every hyperparameter is a constant or a callable of the step counter. The
step counter is a host integer in this port, so a schedule is a plain
Python function of an ``int`` that returns a float, built once ahead of the
loop as in the JAX package (there is no mutable scheduler object).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

ScalarOrSchedule = float | Callable[[int], float]
Schedule = Callable[[int], float]


def resolve(value: ScalarOrSchedule, step: int) -> float:
    """Callable-or-constant hyperparameter, resolved at ``step``."""
    if callable(value):
        return value(step)
    return value


def exp_decay_factor_averaging(min_value: float = 0.95) -> Schedule:
    """Martens et al. (2015) running-average weight ``min(1 - 1/k,
    min_value)``, step 0 taken as 1 (for ``factor_decay``)."""
    if min_value <= 0:
        raise ValueError('min_value must be greater than 0')

    def schedule(step: int) -> float:
        return min(1.0 - 1.0 / max(float(step), 1.0), min_value)

    return schedule


def lambda_schedule(base: float, factor_lambda: Callable[[int], float]) -> Schedule:
    """``base * factor_lambda(step)``: the reference's
    ``LambdaParamScheduler`` as a function (for damping, factor_decay,
    kl_clip or lr)."""

    def schedule(step: int) -> float:
        return base * factor_lambda(step)

    return schedule


def piecewise_constant(boundaries: Sequence[int], values: Sequence[float]) -> Schedule:
    """``values[i]`` for steps in ``[boundaries[i-1], boundaries[i])``;
    ``len(values) == len(boundaries) + 1``."""
    if len(values) != len(boundaries) + 1:
        raise ValueError('need len(values) == len(boundaries) + 1')
    bounds, vals = list(boundaries), [float(v) for v in values]

    def schedule(step: int) -> float:
        return vals[sum(step >= b for b in bounds)]

    return schedule


def exponential_decay(
    base: float, decay_rate: float, decay_steps: int, staircase: bool = False
) -> Schedule:
    """``base * decay_rate ** (step / decay_steps)``, the exponent floored
    with ``staircase``."""

    def schedule(step: int) -> float:
        t = step / decay_steps
        if staircase:
            t = math.floor(t)
        return base * decay_rate**t

    return schedule


def linear_warmup(base: float, warmup_steps: int) -> Schedule:
    """A linear ramp from 0 to ``base`` over ``warmup_steps``, then
    ``base``."""

    def schedule(step: int) -> float:
        return base * min(step / max(1, warmup_steps), 1.0)

    return schedule
