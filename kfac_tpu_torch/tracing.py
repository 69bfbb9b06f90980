"""Opt-in timing instrumentation (counterpart of ``kfac_tpu/tracing.py``).

CUDA launches return before the device finishes, so a wall time of a
call measures its enqueue cost unless the call is synchronised:
``sync=True`` (or :func:`force_sync`) waits with ``torch.cuda.synchronize``
on every CUDA device its output's tensors lie on. Every traced stage also
runs under ``torch.profiler.record_function``, so it is attributable in a
``torch.profiler`` trace.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Callable, TypeVar

import torch

F = TypeVar('F', bound=Callable[..., Any])

_func_traces: dict[str, list[float]] = {}
_force_sync: bool = False

logger = logging.getLogger(__name__)


def clear_trace() -> None:
    """Drop all recorded timings."""
    _func_traces.clear()


def force_sync(enabled: bool) -> None:
    """Promote every ``@trace`` call site to ``sync=True`` (honest
    execution times instead of enqueue times); turn it back off after the
    measurement."""
    global _force_sync
    _force_sync = bool(enabled)


def sync_forced() -> bool:
    """Whether :func:`force_sync` is currently engaged."""
    return _force_sync


def _tensors(out: Any):
    """Every tensor in ``out``: nested tuples, lists, dicts and dataclasses."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for field in dataclasses.fields(out):
            yield from _tensors(getattr(out, field.name))


def _block_all(out: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    for device in {t.device for t in _tensors(out) if t.device.type == 'cuda'}:
        torch.cuda.synchronize(device)


def trace(sync: bool = False, name: str | None = None) -> Callable[[F], F]:
    """Decorator recording the wall time of each call into a global table.

    Args:
        sync: wait for the devices of the output's tensors before stopping
            the clock. :func:`force_sync` promotes every call site.
        name: the recorded name (default: the function's name).
    """

    def decorator(func: F) -> F:
        key = name or func.__name__

        @functools.wraps(func)
        def wrapped(*args: Any, **kwargs: Any):
            start = time.perf_counter()
            with torch.profiler.record_function(key):
                out = func(*args, **kwargs)
            if sync or _force_sync:
                _block_all(out)
            _func_traces.setdefault(key, []).append(time.perf_counter() - start)
            return out

        wrapped.__kfac_scope__ = key  # type: ignore[attr-defined]
        return wrapped  # type: ignore[return-value]

    return decorator


def scope(name: str) -> Callable[[F], F]:
    """``record_function``-only decorator: profiler attribution without
    the timing table."""

    def decorator(func: F) -> F:
        @functools.wraps(func)
        def wrapped(*args: Any, **kwargs: Any):
            with torch.profiler.record_function(name):
                return func(*args, **kwargs)

        wrapped.__kfac_scope__ = name  # type: ignore[attr-defined]
        return wrapped  # type: ignore[return-value]

    return decorator


def get_trace(
    average: bool = True, max_history: int | None = None
) -> dict[str, float]:
    """Recorded seconds per name, averaged or summed over the last
    ``max_history`` calls (all calls by default)."""
    out: dict[str, float] = {}
    for key, times in _func_traces.items():
        window = times[-max_history:] if max_history is not None else times
        if not window:
            continue
        out[key] = sum(window) / len(window) if average else sum(window)
    return out


def log_trace(
    level: int = logging.INFO, label: str = 'timing:', **kwargs: Any
) -> None:
    """Log the trace table, one line per name."""
    for key, value in sorted(get_trace(**kwargs).items()):
        logger.log(level, f'{label} {key}: {value:.6f}s')


def health_counters(state: Any) -> dict[str, Any]:
    """Flat snapshot of an engine state's health counters (or of a bare
    ``HealthState``): ``{'health/skipped_steps': ...,
    'health/<layer>/damping_mult': ..., '.../quarantined': ...,
    '.../bad_inv': ..., '.../quarantine_events': ...}``, in the JAX
    package's key order; ``{}`` when the sentinel is off. One read from
    the device."""
    from kfac_tpu_torch import health as health_lib

    health = getattr(state, 'health', state)
    if not isinstance(health, health_lib.HealthState):
        return {}
    vals = health_lib.host_values(health)
    out: dict[str, Any] = {'health/skipped_steps': vals['skipped_steps']}
    for field in health_lib.PER_LAYER_FIELDS:
        for name, v in vals[field].items():
            out[f'health/{name}/{field}'] = v
    return out


def log_health(state: Any, level: int = logging.INFO) -> None:
    """Log the health counter snapshot (nothing when health is off)."""
    for key, value in sorted(health_counters(state).items()):
        logger.log(level, f'health: {key}: {value}')
