"""Preemption-signal handling: flag-setting handlers, no work in the
handler itself (the port's own copy of ``kfac_tpu/resilience/signals.py``).

Cluster schedulers deliver a SIGTERM with a short grace window before the
hard kill; operators poke long runs with SIGUSR1 to snapshot state without
stopping them. A signal handler that does real work (checkpoint I/O, CUDA
calls) from interrupt context is a deadlock machine, so the handlers here
only record *which* signal arrived;
:class:`kfac_tpu_torch.resilience.CheckpointManager` polls the flag at step
boundaries, a safe point, and performs the emergency blocking save there.
CPython runs handlers on the main thread only, so a checkpoint writer thread
never runs this logic.

The priority rules are the JAX package's: exit signals outrank continue
signals, and a re-delivery during the emergency save it triggered is
dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal as _signal
from typing import Iterable, Iterator


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """Semantics of one handled signal.

    ``exits``: after the emergency checkpoint is durable, does training
    stop (:class:`~kfac_tpu_torch.resilience.Preempted` is raised) or continue?
    """

    name: str
    exits: bool
    description: str


#: the signals :func:`install` handles by default, with their semantics
HANDLED_SIGNALS: dict[str, SignalSpec] = {
    'SIGTERM': SignalSpec(
        'SIGTERM', exits=True,
        description='preemption notice: flush an emergency blocking '
                    'checkpoint, then exit via Preempted',
    ),
    'SIGUSR1': SignalSpec(
        'SIGUSR1', exits=False,
        description='operator snapshot: flush an emergency blocking '
                    'checkpoint, training continues',
    ),
}

#: name of the most urgent signal seen and not yet consumed (exit signals
#: outrank continue signals; within a rank, latest delivery wins)
_pending: str | None = None

#: name of the signal whose emergency save is CURRENTLY in flight
#: (bracketed by :func:`save_in_flight` from
#: ``CheckpointManager.save_emergency``). Signal storms — schedulers
#: re-deliver SIGTERM every few seconds until the process dies — must
#: not re-arm the flag mid-save: the save is already running, and a
#: re-armed flag would re-enter ``save_emergency`` at the next boundary
#: (SIGUSR1) or leave a stale flag behind the Preempted unwind
#: (SIGTERM). Only an ESCALATION (an exit signal landing during a
#: continue-signal save) still latches.
_in_flight: str | None = None


def _handler_for(name: str):
    def _handler(signum, frame):  # noqa: ARG001 - signal handler signature
        global _pending
        if _in_flight is not None and not (
            HANDLED_SIGNALS[name].exits
            and not HANDLED_SIGNALS[_in_flight].exits
        ):
            return  # storm re-delivery during the save: already handled
        if _pending is None or (
            HANDLED_SIGNALS[name].exits
            and not HANDLED_SIGNALS[_pending].exits
        ):
            _pending = name
    _handler.__kfac_signal__ = name  # lets tests identify our handlers
    return _handler


@contextlib.contextmanager
def save_in_flight(name: str) -> Iterator[None]:
    """Mark an emergency save for ``name`` as running (handler-visible).

    While active, re-deliveries of ``name`` (or anything that does not
    escalate over it) are dropped in the handler — idempotence under
    signal storms. Re-entrant: an escalated save nested inside a
    continue-signal save restores the outer marker on exit. Assigning a
    str is atomic under the GIL and handlers only read it, so no
    masking/locking is needed.
    """
    global _in_flight
    if name not in HANDLED_SIGNALS:
        raise ValueError(
            f'unknown preemption signal {name!r}; handled signals: '
            f'{sorted(HANDLED_SIGNALS)}'
        )
    previous = _in_flight
    _in_flight = name
    try:
        yield
    finally:
        _in_flight = previous


class SignalHandle:
    """Installed-handler record; ``uninstall()`` restores what was there
    before (context-manager friendly)."""

    def __init__(self, previous: list[tuple[int, object]]) -> None:
        self._previous = previous

    def uninstall(self) -> None:
        while self._previous:
            signum, prev = self._previous.pop()
            _signal.signal(signum, prev)

    def __enter__(self) -> 'SignalHandle':
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()


def install(
    signals: Iterable[str] = ('SIGTERM', 'SIGUSR1'),
) -> SignalHandle:
    """Install flag-setting handlers for the named signals.

    Only signals listed in :data:`HANDLED_SIGNALS` are accepted (their
    semantics are documented and linted); returns a :class:`SignalHandle`
    whose ``uninstall()`` restores the previous handlers. Must run on the
    main thread (a CPython ``signal.signal`` constraint).
    """
    previous: list[tuple[int, object]] = []
    handle = SignalHandle(previous)
    try:
        for name in signals:
            if name not in HANDLED_SIGNALS:
                raise ValueError(
                    f'unknown preemption signal {name!r}; handled signals: '
                    f'{sorted(HANDLED_SIGNALS)}'
                )
            signum = getattr(_signal, name)
            previous.append((signum, _signal.getsignal(signum)))
            _signal.signal(signum, _handler_for(name))
    except Exception:
        handle.uninstall()
        raise
    return handle


def preemption_requested() -> str | None:
    """The pending signal name, or None. Does not clear the flag."""
    return _pending


def consume() -> str | None:
    """Return and clear the pending signal flag."""
    global _pending
    name, _pending = _pending, None
    return name


def exits(name: str) -> bool:
    """Whether the named signal's semantics end training after the save."""
    return HANDLED_SIGNALS[name].exits


def save_in_flight_signal() -> str | None:
    """The signal whose emergency save is currently running, or None."""
    return _in_flight


def reset() -> None:
    """Clear the pending and in-flight flags (tests)."""
    global _pending, _in_flight
    _pending = None
    _in_flight = None
