"""Warning categories and rate-limited event channels (the port's own copy
of ``kfac_tpu/warnings.py``).

Each channel warns once per process per key, not once per step: a
persistent condition would otherwise repeat at training-step frequency
while saying nothing new. The dispatch-table channel is not carried over:
the port has no dispatch gates.
"""

from __future__ import annotations

import warnings as _warnings


class ExperimentalFeatureWarning(Warning):
    """Feature is experimental and may change or underperform."""


class TPUPerformanceWarning(Warning):
    """Configuration known to be pathologically slow on TPU backends."""


class NumericalHealthWarning(Warning):
    """A layer was quarantined or degraded by the health sentinel."""


class CheckpointResilienceWarning(Warning):
    """Checkpoint durability/restore anomaly that was handled gracefully
    but an operator should know about."""


class LayoutPlanWarning(Warning):
    """A tuned layout plan could not be applied and the engine fell back to
    its explicit/default configuration."""


class FleetWarning(Warning):
    """A self-driving fleet event an operator should know about."""


_health_events_emitted: set[tuple[str, str]] = set()
_layout_events_emitted: set[str] = set()
_fleet_events_emitted: set[str] = set()


def warn_health_event(
    layer: str, step: int | None, cause: str, detail: str = ''
) -> bool:
    """Emit a :class:`NumericalHealthWarning` once per ``(layer, cause)``.

    Returns True when a warning was emitted, False when rate-limited.
    """
    key = (layer, cause)
    if key in _health_events_emitted:
        return False
    _health_events_emitted.add(key)
    at = f' at step {step}' if step is not None else ''
    msg = f'kfac-tpu health: layer {layer!r} {cause}{at}'
    if detail:
        msg += f' ({detail})'
    _warnings.warn(msg, NumericalHealthWarning, stacklevel=2)
    return True


def reset_health_warnings() -> None:
    """Forget emitted health events."""
    _health_events_emitted.clear()


def warn_layout_event(cause: str, detail: str = '') -> bool:
    """Emit a :class:`LayoutPlanWarning` once per ``cause``."""
    if cause in _layout_events_emitted:
        return False
    _layout_events_emitted.add(cause)
    msg = f'kfac-tpu autotune: tuned plan not applied — {cause}'
    if detail:
        msg += f' ({detail})'
    msg += '; falling back to the explicit/default layout'
    _warnings.warn(msg, LayoutPlanWarning, stacklevel=2)
    return True


def reset_layout_warnings() -> None:
    """Forget emitted plan-fallback events."""
    _layout_events_emitted.clear()


def warn_fleet_event(cause: str, detail: str = '') -> bool:
    """Emit a :class:`FleetWarning` once per ``cause``."""
    if cause in _fleet_events_emitted:
        return False
    _fleet_events_emitted.add(cause)
    msg = f'kfac-tpu fleet: {cause}'
    if detail:
        msg += f' ({detail})'
    _warnings.warn(msg, FleetWarning, stacklevel=2)
    return True


def reset_fleet_warnings() -> None:
    """Forget emitted fleet events."""
    _fleet_events_emitted.clear()
