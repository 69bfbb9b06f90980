"""Numerical-health sentinel: skip-step, factor quarantine, degradation
(counterpart of ``kfac_tpu/health.py``).

1. **Skip-step**: a finiteness check over the loss and the grads gates the
   whole update (params, optimizer state, factors, model state); on a
   poisoned batch only the step clock and ``skipped_steps`` advance. The
   JAX package gates on the device with ``lax.cond``; here the
   :class:`~kfac_tpu_torch.training.Trainer` reads the verdict once a step,
   as ``torch.amp.GradScaler`` does (a device-side skip would have to
   snapshot and restore every parameter and optimizer buffer).
2. **Factor quarantine**: a factor update that is non-finite, or whose
   Gershgorin condition bound at the layer's effective damping exceeds
   ``quarantine_threshold``, is rolled back; the layer's damping multiplier
   escalates, and decays back toward 1 on healthy updates.
3. **Graceful degradation**: after ``degrade_after`` consecutive
   quarantined inversions the layer's preconditioner is bypassed (its
   update is the raw gradient direction) until the counter recovers.

:class:`HealthState` holds device tensors only, and every transition is a
``torch.where`` on them: none reads a value back to the host. The
per-layer counters of the JAX package's dicts are packed here into one
(L,) vector each, in ``names`` order (the layout of its stacked engine), so
a transition over every layer is one launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch

from kfac_tpu_torch import warnings as kfac_warnings
from kfac_tpu_torch.ops import factors as factors_lib

PER_LAYER_FIELDS = ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the sentinel (the JAX package's, with its defaults and
    validation). Pass as ``KFACPreconditioner(health=...)``, or
    ``health=True`` for the defaults.

    ``skip_nonfinite``: skip the whole update on a non-finite loss or grad.
    ``quarantine_threshold``: Gershgorin condition bound above which a
    finite factor update is still quarantined (None: finiteness only).
    ``damping_escalation``: multiplier of a layer's damping per quarantine
    (> 1). ``damping_decay``: its decay per healthy update, in (0, 1),
    floored at 1. ``max_damping_mult``: its cap. ``degrade_after``:
    consecutive quarantined inversions before the layer is bypassed.
    ``warn``: the Trainer's eager paths call :func:`check_and_warn` after
    each step (one read of the counters).
    """

    skip_nonfinite: bool = True
    quarantine_threshold: float | None = 1e8
    damping_escalation: float = 10.0
    damping_decay: float = 0.5
    max_damping_mult: float = 1e6
    degrade_after: int = 3
    warn: bool = True

    def __post_init__(self) -> None:
        if self.damping_escalation <= 1.0:
            raise ValueError(
                f'damping_escalation must be > 1, got {self.damping_escalation}'
            )
        if not 0.0 < self.damping_decay < 1.0:
            raise ValueError(
                f'damping_decay must be in (0, 1), got {self.damping_decay}'
            )
        if self.max_damping_mult < self.damping_escalation:
            raise ValueError(
                'max_damping_mult must be >= damping_escalation, got '
                f'{self.max_damping_mult}'
            )
        if self.degrade_after < 1:
            raise ValueError(
                f'degrade_after must be >= 1, got {self.degrade_after}'
            )
        if (
            self.quarantine_threshold is not None
            and self.quarantine_threshold <= 1.0
        ):
            raise ValueError(
                'quarantine_threshold is a condition-number bound and must '
                f'be > 1 (or None to disable), got {self.quarantine_threshold}'
            )


@dataclasses.dataclass(frozen=True)
class HealthState:
    """Per-run and per-layer counters, device tensors.

    ``skipped_steps``: 0-d int32, updates dropped by the skip-step gate.
    Per layer, (L,) in ``names`` order: ``damping_mult`` f32 (>= 1);
    ``quarantined`` int32, consecutive quarantined factor updates;
    ``bad_inv`` int32, consecutive quarantined inversions (clamped at
    ``2 * degrade_after``); ``quarantine_events`` int32, cumulative.
    """

    names: tuple[str, ...]
    skipped_steps: torch.Tensor
    damping_mult: torch.Tensor
    quarantined: torch.Tensor
    bad_inv: torch.Tensor
    quarantine_events: torch.Tensor


def init_health(
    names: Iterable[str], device: str | torch.device = 'cuda'
) -> HealthState:
    """Healthy counters for the registered layer ``names``, on ``device``."""
    names = tuple(names)
    n = len(names)
    i32 = torch.int32
    return HealthState(
        names=names,
        skipped_steps=torch.zeros((), dtype=i32, device=device),
        damping_mult=torch.ones((n,), dtype=torch.float32, device=device),
        quarantined=torch.zeros((n,), dtype=i32, device=device),
        bad_inv=torch.zeros((n,), dtype=i32, device=device),
        quarantine_events=torch.zeros((n,), dtype=i32, device=device),
    )


def health_metric_keys(names: Iterable[str]) -> list[str]:
    """The ``health/*`` key schema of
    :func:`kfac_tpu_torch.tracing.health_counters`."""
    keys = ['health/skipped_steps']
    for n in names:
        keys.extend(f'health/{n}/{field}' for field in PER_LAYER_FIELDS)
    return keys


# ----------------------------------------------------------------- predicates


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def all_finite(*trees: Any) -> torch.Tensor:
    """0-d bool tensor: every floating tensor in ``trees`` (nested dicts,
    tuples and lists) is free of inf and NaN. No host read."""
    flags = [
        torch.isfinite(x).all()
        for tree in trees for x in _leaves(tree) if x.dtype.is_floating_point
    ]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def factor_ok(
    candidate: torch.Tensor,
    damping: float | torch.Tensor,
    threshold: float | None,
) -> torch.Tensor:
    """Verdict of a ``(..., d, d)`` factor update, ``(...,)`` bool: finite
    and, with a ``threshold``, its Gershgorin condition bound at
    ``damping`` at or below it. A NaN factor fails both legs."""
    ok = torch.isfinite(candidate).flatten(-2).all(dim=-1)
    if threshold is not None:
        bound = factors_lib.gershgorin_condition_bound(candidate, damping)
        ok = ok & (bound <= threshold)
    return ok


def factors_ok(
    candidates: list[torch.Tensor],
    dampings: list[torch.Tensor],
    threshold: float | None,
) -> torch.Tensor:
    """:func:`factor_ok` of each candidate at its damping (0-d tensors),
    (len(candidates),) bool: the candidates of one shape stacked and judged
    together, a few launches a shape rather than a few a factor."""
    out = [None] * len(candidates)
    for idx, stack in factors_lib.stacked_by_shape(candidates):
        ok = factor_ok(stack, torch.stack([dampings[k] for k in idx]), threshold)
        for k, v in zip(idx, ok.unbind()):
            out[k] = v
    return torch.stack(out)


# ------------------------------------------------------------- stacked slots
# The distributed engine's stores hold layers along a slot axis, padded.


def slot_mults(mult: torch.Tensor, index: torch.Tensor, padded: int) -> torch.Tensor:
    """(padded,) per-slot damping multipliers of a store whose live slots
    hold the layers at ``index`` (positions in ``mult``'s registry order);
    the padding slots get 1."""
    return torch.cat([mult[index], mult.new_ones((padded - index.numel(),))])


def slot_mask(flags: torch.Tensor, index: torch.Tensor, padded: int) -> torch.Tensor:
    """(padded,) bool per slot from per-layer ``flags`` (registry order):
    the live slots' layers' flags, False for the padding slots."""
    return torch.cat([flags[index], flags.new_zeros((padded - index.numel(),))])


def positions(touched: list[int], count: int, device: torch.device) -> torch.Tensor | None:
    """Index vector of the ``touched`` layers on ``device``, or None when
    every layer of ``count`` is touched (the common case, which copies
    nothing)."""
    if len(touched) == count:
        return None
    return torch.tensor(touched, device=device)


# ---------------------------------------------------------------- transitions
# Broadcast over a 0-d layer or an (L,) vector of layers alike.


def quarantine_update(
    cfg: HealthConfig,
    ok: torch.Tensor,
    mult: torch.Tensor,
    quarantined: torch.Tensor,
    events: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor-update transition: escalate on quarantine, decay on health.
    Returns ``(damping_mult, quarantined, quarantine_events)``."""
    bad = ~ok
    new_mult = torch.where(
        bad,
        torch.clamp(mult * cfg.damping_escalation, max=cfg.max_damping_mult),
        torch.clamp(mult * cfg.damping_decay, min=1.0),
    )
    new_quarantined = torch.where(bad, quarantined + 1, torch.zeros_like(quarantined))
    new_events = events + bad.to(events.dtype)
    return new_mult, new_quarantined, new_events


def inversion_update(
    cfg: HealthConfig,
    ok: torch.Tensor,
    quarantined: torch.Tensor,
    bad_inv: torch.Tensor,
) -> torch.Tensor:
    """Inversion transition of the degradation counter: up (to at most
    ``2 * degrade_after``) when the inversion ran from a quarantined factor
    or its output was non-finite, else down (to at least 0)."""
    bad = (~ok) | (quarantined > 0)
    cap = 2 * cfg.degrade_after
    return torch.where(
        bad, torch.clamp(bad_inv + 1, max=cap), torch.clamp(bad_inv - 1, min=0)
    )


def is_degraded(cfg: HealthConfig, bad_inv: torch.Tensor) -> torch.Tensor:
    """Bool, like ``bad_inv``: the layer's preconditioner is bypassed."""
    return bad_inv >= cfg.degrade_after


def mark_skipped(state: Any) -> Any:
    """Skip-step branch of an engine state: the step clock advances and
    ``skipped_steps`` counts the skip; nothing else changes."""
    h = state.health
    return dataclasses.replace(
        state,
        step=state.step + 1,
        health=dataclasses.replace(h, skipped_steps=h.skipped_steps + 1),
    )


# ------------------------------------------------------------- host utilities


def host_values(health: HealthState) -> dict[str, Any]:
    """Every counter on the host, in one copy from the device."""
    n = len(health.names)
    packed = torch.cat([
        health.skipped_steps.reshape(1).double(),
        health.damping_mult.double(),
        health.quarantined.double(),
        health.bad_inv.double(),
        health.quarantine_events.double(),
    ]).cpu().tolist()
    out: dict[str, Any] = {'skipped_steps': int(packed[0])}
    for k, field in enumerate(PER_LAYER_FIELDS):
        values = packed[1 + k * n:1 + (k + 1) * n]
        cast = float if field == 'damping_mult' else int
        out[field] = {name: cast(v) for name, v in zip(health.names, values)}
    return out


def summary(cfg: HealthConfig, health: HealthState) -> dict[str, Any]:
    """Host snapshot: the counters and each layer's status, ``'ok'``,
    ``'quarantined'`` (living on a rolled-back factor) or ``'degraded'``
    (preconditioner bypassed). One read from the device."""
    vals = host_values(health)
    layers = {}
    for n in health.names:
        bad_inv = vals['bad_inv'][n]
        if bad_inv >= cfg.degrade_after:
            status = 'degraded'
        elif vals['quarantined'][n] > 0:
            status = 'quarantined'
        else:
            status = 'ok'
        layers[n] = {
            'status': status,
            'damping_mult': vals['damping_mult'][n],
            'quarantined': vals['quarantined'][n],
            'bad_inv': bad_inv,
            'quarantine_events': vals['quarantine_events'][n],
        }
    return {'skipped_steps': vals['skipped_steps'], 'layers': layers}


def check_and_warn(
    cfg: HealthConfig, health: HealthState, step: int | None = None
) -> dict[str, Any]:
    """Emit the first-occurrence :class:`NumericalHealthWarning` of each
    (layer, cause), quarantined or degraded, and return the
    :func:`summary` scanned (one read from the device)."""
    snap = summary(cfg, health)
    for name, info in snap['layers'].items():
        if info['quarantine_events'] > 0:
            kfac_warnings.warn_health_event(
                name, step, 'quarantined',
                detail=(
                    f"{info['quarantine_events']} quarantine event(s), "
                    f"damping_mult={info['damping_mult']:g}"
                ),
            )
        if info['status'] == 'degraded':
            kfac_warnings.warn_health_event(
                name, step, 'degraded',
                detail=(
                    f"{info['bad_inv']} consecutive quarantined "
                    f'inversions (>= degrade_after={cfg.degrade_after}); '
                    'preconditioner bypassed, raw gradient in use'
                ),
            )
    return snap
