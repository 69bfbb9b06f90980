"""Checkpoint autopilot: keep-N rotation, atomic LATEST pointer, periodic
async saves, emergency flush on preemption, last-good fallback restore
(counterpart of ``kfac_tpu/resilience/manager.py``).

The primitives live in :mod:`kfac_tpu_torch.checkpoint`; this module
composes them into a loop that survives SIGTERM in the middle of an async
save and a torn write in the newest checkpoint. Invariants, as in the JAX
package:

- Every save goes to a fresh step-numbered directory
  (``<root>/step_00000042/ckpt``), so no write touches the bytes of an
  existing checkpoint.
- The ``LATEST`` pointer is a one-line file replaced atomically
  (``os.replace``) and committed only after the write has finished, so a
  crash at any instant leaves the previous pointer naming a durable
  checkpoint.
- Pruning keeps the newest ``keep`` committed checkpoints and never
  deletes the ``LATEST`` target.
- :meth:`CheckpointManager.restore_latest` walks newest to oldest,
  validating each candidate, and falls back to the last good one with a
  rate-limited warning.

Across processes (a :class:`~kfac_tpu_torch.parallel.DistributedKFAC`
run, one manager a rank over one shared rotation), the JAX package's
protocol: rank 0 alone clears a stale entry, then a barrier, then every
rank writes its shard; rank 0 alone points ``LATEST`` and prunes. Every
``coordinate_every`` steps the ranks gather their signal flags
(:func:`~kfac_tpu_torch.parallel.multihost.agree_emergency`), so one
rank's SIGTERM becomes one emergency checkpoint at one agreed step on
every rank; a signal seen between those steps waits for the next.
``restore_latest`` walks the candidates in the same order on every rank
and ends in ``assert_same_step``.

Only the host is involved between saves: a step that does not save reads
a flag, compares host integers and asks whether the writer thread has
ended, with no device sync; across processes it joins no collective
outside the coordination cadence, and those collectives move host values
over gloo.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
import warnings as _warnings
from typing import Any, Callable, NamedTuple

from kfac_tpu_torch import checkpoint as checkpoint_lib
from kfac_tpu_torch.parallel import multihost
from kfac_tpu_torch.resilience import signals as signals_lib
from kfac_tpu_torch.warnings import CheckpointResilienceWarning

_STEP_PREFIX = 'step_'
_LATEST = 'LATEST'
_CKPT_NAME = 'ckpt'
# agreed emergency codes: none, continue (SIGUSR1), exit (SIGTERM)
_CODE_NONE, _CODE_CONTINUE, _CODE_EXIT = 0, 1, 2

#: The JAX package's save-protocol table, copied as data for the lint
#: tiers' pod rules (not yet ported). Step order is the logical commit
#: order; the async path defers wait and commit to a later ``on_step`` or
#: ``finalize`` but never reorders them. Keep it a pure literal.
SAVE_PROTOCOL = {
    'machine': 'sequence',
    'name': 'checkpoint-save',
    'function': 'CheckpointManager.save',
    'steps': (
        {'op': 'flush_pending', 'rank': 'all', 'kind': 'host'},
        {'op': 'clear_stale_dir', 'rank': 0, 'kind': 'mutate',
         'effect': 'mutate_dir'},
        {'op': 'barrier', 'rank': 'all', 'kind': 'barrier'},
        {'op': 'write_checkpoint', 'rank': 'all', 'kind': 'mutate',
         'effect': 'write_step_dir'},
        {'op': 'wait_until_finished', 'rank': 'all', 'kind': 'wait'},
        {'op': 'commit_latest', 'rank': 0, 'kind': 'mutate',
         'effect': 'point_latest'},
    ),
}


class Preempted(RuntimeError):
    """Raised by :meth:`CheckpointManager.on_step` after a successful
    emergency save for an exit-semantics signal (SIGTERM): the state is
    durable; unwind the training loop now."""

    def __init__(self, signal_name: str, step: int, path: str) -> None:
        super().__init__(
            f'preempted by {signal_name} at step {step}; emergency '
            f'checkpoint is durable at {path!r} — resume with '
            'CheckpointManager.restore_latest()'
        )
        self.signal_name = signal_name
        self.step = step
        self.path = path


class RestoreResult(NamedTuple):
    """What :meth:`CheckpointManager.restore_latest` hands back."""

    state: Any
    extra: dict[str, Any]
    step: int
    path: str


class _PendingSave(NamedTuple):
    handle: Any
    step: int


class CheckpointManager:
    """Owns a rotation of step-numbered checkpoint directories.

    Args (the JAX package's):
        directory: rotation root (created if missing); each step's
            checkpoint lands in ``<directory>/step_<NNNNNNNN>/ckpt``.
        engine: the preconditioner; passed to ``checkpoint.save`` so every
            entry carries a layout manifest, and the default engine of
            :meth:`restore_latest`. A ``Trainer`` gives a manager without
            one its own.
        save_interval_steps: periodic-save cadence of :meth:`on_step`
            (None disables periodic saves; signals still work).
        keep: committed checkpoints retained.
        async_save: periodic saves return once their snapshot is enqueued
            and commit ``LATEST`` at a later :meth:`on_step` (the first
            after the write ended) or :meth:`finalize`; emergency saves
            always block.
        install_signals: install the flag-setting handlers of
            :mod:`kfac_tpu_torch.resilience.signals` for these names at
            construction (``()`` to manage handlers yourself); only from
            the main thread.
        coordinate_every: with several processes, every this many steps
            :meth:`on_step` gathers the ranks' signal flags, so one rank's
            signal reaches every rank (the pod's reaction latency; a
            signal seen between those steps stays pending). Identical on
            every rank.
        max_retries / backoff_base / backoff_max: each failed I/O attempt
            retries after ``min(backoff_max, backoff_base * 2**attempt)``
            seconds.

    ``extras_of``: a function of a ``TrainState`` giving the extras saved
    beside the K-FAC state. The port's ``TrainState`` holds no weights (the
    module and the optimizer do), so a ``Trainer`` sets this to its own
    ``checkpoint_extras``; without it a ``TrainState`` saves its
    ``model_state`` only.
    """

    def __init__(
        self,
        directory: str | os.PathLike[str],
        engine: Any = None,
        *,
        save_interval_steps: int | None = 100,
        keep: int = 3,
        async_save: bool = True,
        install_signals: tuple[str, ...] = ('SIGTERM', 'SIGUSR1'),
        coordinate_every: int = 1,
        max_retries: int = 3,
        backoff_base: float = 0.5,
        backoff_max: float = 8.0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if keep < 1:
            raise ValueError(f'keep must be >= 1, got {keep}')
        if save_interval_steps is not None and save_interval_steps < 1:
            raise ValueError(
                'save_interval_steps must be >= 1 or None, got '
                f'{save_interval_steps}'
            )
        if coordinate_every < 1:
            raise ValueError(f'coordinate_every must be >= 1, got {coordinate_every}')
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.engine = engine
        self.save_interval_steps = save_interval_steps
        self.keep = int(keep)
        self.async_save = bool(async_save)
        self.coordinate_every = int(coordinate_every)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.extras_of: Callable[[Any], dict[str, Any]] | None = None
        self._sleep = sleep
        self._pending: _PendingSave | None = None
        self._last_saved_step: int | None = None
        self._warned_paths: set[str] = set()
        self._signal_handle = (
            signals_lib.install(install_signals) if install_signals else None
        )

    # ------------------------------------------------------------ rotation

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f'{_STEP_PREFIX}{step:08d}')

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.step_dir(step), _CKPT_NAME)

    def _latest_path(self) -> str:
        return os.path.join(self.directory, _LATEST)

    def rotation_steps(self) -> list[int]:
        """Step numbers present in the rotation, newest first (presence =
        the step dir exists; commit state is checked per candidate)."""
        steps = []
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in entries:
            if name.startswith(_STEP_PREFIX):
                try:
                    steps.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps, reverse=True)

    def latest_step(self) -> int | None:
        """The committed ``LATEST`` pointer's step, or None. A torn pointer
        reads as absent, so the restore falls back to the rotation scan."""
        try:
            with open(self._latest_path(), 'rb') as f:
                name = f.read().decode('utf-8', errors='replace').strip()
        except OSError:
            return None
        if not name.startswith(_STEP_PREFIX):
            return None
        try:
            return int(name[len(_STEP_PREFIX):])
        except ValueError:
            return None

    def _is_committed(self, step: int) -> bool:
        """The rotation entry's commit marker is present."""
        return checkpoint_lib.is_committed(self.checkpoint_path(step))

    def _commit(self, step: int) -> None:
        """Atomically point ``LATEST`` at ``step`` and prune, on rank 0
        only (the rotation lives on a shared filesystem); called only after
        the step's write has finished."""
        self._last_saved_step = step
        if multihost.process_index() != 0:
            return
        latest = self._latest_path()
        tmp = f'{latest}.tmp.{os.getpid()}'
        with open(tmp, 'w') as f:
            f.write(os.path.basename(self.step_dir(step)) + '\n')
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, latest)
        self._prune(protect=step)

    def _prune(self, protect: int) -> None:
        """Drop committed entries beyond ``keep`` (never ``protect``, the
        LATEST target), and uncommitted dirs older than the newest committed
        step: saves are sequential, so those are torn remains of crashed
        attempts, never a write in flight."""
        steps = self.rotation_steps()
        committed = [s for s in steps if self._is_committed(s)]
        for step in committed[self.keep:]:
            if step != protect:
                shutil.rmtree(self.step_dir(step), ignore_errors=True)
        if committed:
            newest, live = committed[0], set(committed)
            for step in steps:
                if step < newest and step not in live and step != protect:
                    shutil.rmtree(self.step_dir(step), ignore_errors=True)

    # --------------------------------------------------------------- saving

    def _with_retries(self, what: str, fn: Callable[[], Any]) -> Any:
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except OSError as exc:
                if attempt == self.max_retries:
                    raise
                delay = min(self.backoff_max, self.backoff_base * (2 ** attempt))
                _warnings.warn(
                    f'{what} failed with transient I/O error ({exc}); '
                    f'retry {attempt + 1}/{self.max_retries} in {delay:.1f}s',
                    CheckpointResilienceWarning,
                    stacklevel=3,
                )
                self._sleep(delay)

    def _flush_pending(self) -> None:
        """Finish an in-flight async save and commit its LATEST pointer."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        self._with_retries(
            f'finishing async checkpoint for step {pending.step}',
            pending.handle.wait_until_finished,
        )
        self._commit(pending.step)

    def _split(self, state: Any, extra: dict[str, Any] | None) -> tuple[Any, dict[str, Any] | None]:
        """(engine state, extras) of a ``TrainState`` (duck-typed on
        ``kfac_state``) or a bare engine state."""
        if not hasattr(state, 'kfac_state'):
            return state, extra
        if extra is None:
            if self.extras_of is not None:
                extra = self.extras_of(state)
            elif state.model_state is not None:
                extra = {'model_state': state.model_state}
        return state.kfac_state, extra

    def save(
        self,
        state: Any,
        step: int | None = None,
        block: bool | None = None,
        extra: dict[str, Any] | None = None,
    ) -> str:
        """Save ``state`` (a ``TrainState`` or a bare engine state) and
        ``extra`` into a fresh rotation entry; returns the checkpoint path.

        Blocking saves commit ``LATEST`` before returning; async saves
        commit later. Either way the pointer moves only once the write has
        finished.
        """
        self._flush_pending()
        kstate, extra = self._split(state, extra)
        if step is None:
            step = int(kstate.step)
        block = (not self.async_save) if block is None else block
        sdir = self.step_dir(step)
        if multihost.process_index() == 0 and os.path.exists(sdir):
            # a dead earlier attempt at this step, or a re-save after a
            # restore: the rotation never reuses bytes. Rank 0 only:
            # concurrent removals on a shared filesystem race each other
            self._with_retries(
                f'clearing stale rotation entry for step {step}',
                lambda: shutil.rmtree(sdir),
            )
        if multihost.process_count() > 1:
            # no rank writes until rank 0's clear has finished
            multihost.barrier(f'kfac-resilience-save-{step}')
        path = self.checkpoint_path(step)

        def attempt():
            os.makedirs(sdir, exist_ok=True)
            return checkpoint_lib.save(
                path, kstate, extra=extra, engine=self.engine, wait=block,
            )

        handle = self._with_retries(f'checkpoint save for step {step}', attempt)
        if block:
            self._commit(step)
        else:
            self._pending = _PendingSave(handle, step)
        return path

    def save_emergency(
        self, state: Any, reason: str = 'signal', step: int | None = None,
        extra: dict[str, Any] | None = None,
    ) -> str:
        """Blocking save and commit for preemption and health events.

        ``step`` defaults to the state's own counter; with several
        processes every rank must pass the same value (:meth:`on_step`
        passes the agreed one).

        Idempotent per step: a step already durable in the rotation is
        pointed at, not written again. A signal-driven save runs under
        :func:`signals.save_in_flight`, so a re-delivery of its signal
        cannot re-arm the flag; an escalation (SIGTERM during a SIGUSR1
        save) still latches, and so does any signal during a save for
        another reason.
        """
        bracket = (
            signals_lib.save_in_flight(reason)
            if reason in signals_lib.HANDLED_SIGNALS
            else contextlib.nullcontext()
        )
        with bracket:
            self._flush_pending()
            if step is None:
                step = int(getattr(state, 'kfac_state', state).step)
            _warnings.warn(
                f'emergency checkpoint requested at step {step} ({reason})',
                CheckpointResilienceWarning,
                stacklevel=2,
            )
            if self._is_committed(step):
                if self._last_saved_step != step:
                    self._commit(step)
                return self.checkpoint_path(step)
            return self.save(state, step=step, block=True, extra=extra)

    # -------------------------------------------------------------- driving

    def _poll_emergency(self, step: int) -> tuple[int, int]:
        """The local signal flag as the ranks' agreed ``(code, step)``.
        With several processes the gather runs only on the coordination
        cadence, which every rank computes alike, so it always pairs up; a
        flag raised on another step stays pending until then."""
        local = signals_lib.preemption_requested()
        code = _CODE_NONE
        if local is not None:
            code = _CODE_EXIT if signals_lib.exits(local) else _CODE_CONTINUE
        if multihost.process_count() > 1:
            if step % self.coordinate_every != 0:
                return _CODE_NONE, step
            code, step = multihost.agree_emergency(code, step)
        return code, step

    def _pending_done(self, step: int) -> bool:
        """Whether the pending async save has ended on every rank: this
        process's writer alone in one process; with several, agreed on the
        coordination cadence only (never otherwise)."""
        if self._pending is None:
            return False
        if multihost.process_count() == 1:
            return self._pending.handle.done()
        if step % self.coordinate_every != 0:
            return False
        return multihost.agree_decision(self._pending.handle.done())

    def on_step(self, state: Any, step: int | None = None) -> str | None:
        """Drive the autopilot once per step: commit a finished async save,
        flush an emergency blocking save when a signal is pending (then
        raise :class:`Preempted` for SIGTERM, the state durable), else
        start the periodic save on cadence. Returns the path saved by this
        call, or None. ``Trainer`` calls it after every step when
        constructed with ``checkpoints=<manager>``.

        With several processes the signal is agreed on the coordination
        cadence: every rank saves one emergency checkpoint at the agreed
        (largest) step, and an exit on any rank is a SIGTERM on all.
        """
        if step is None:
            step = int(getattr(state, 'kfac_state', state).step)
        if self._pending_done(step):
            self._flush_pending()
        code, agreed = self._poll_emergency(step)
        if code != _CODE_NONE:
            local = signals_lib.consume()
            if code == _CODE_EXIT and (local is None or not signals_lib.exits(local)):
                name = 'SIGTERM'  # another rank saw the exit signal
            else:
                name = local or 'SIGUSR1'
            path = self.save_emergency(state, reason=name, step=agreed)
            if code == _CODE_EXIT:
                raise Preempted(name, agreed, path)
            return path
        if (
            self.save_interval_steps is not None
            and step > 0
            and step % self.save_interval_steps == 0
            and step != self._last_saved_step
            and (self._pending is None or self._pending.step != step)
        ):
            return self.save(state, step=step)
        return None

    # ------------------------------------------------------------ restoring

    def restore_latest(
        self,
        engine: Any = None,
        extra_template: dict[str, Any] | None = None,
    ) -> RestoreResult | None:
        """Restore the newest good checkpoint, falling back across the
        rotation: the ``LATEST`` target first, then every entry newest to
        oldest. A candidate without its commit marker, or one that
        ``checkpoint.restore`` rejects (corrupt payload, non-finite or
        mis-shaped factors, missing extras, another layout), falls back to
        the next with a :class:`CheckpointResilienceWarning`, once per
        path. Returns None when nothing restores. ``engine`` defaults to
        the manager's. With several processes every rank walks the same
        candidates in the same order (a distributed restore agrees on
        each), and the ranks check that they restored the same step.
        """
        engine = self.engine if engine is None else engine
        if engine is None:
            raise ValueError(
                'restore_latest needs an engine: construct the manager '
                'with engine=..., or pass one explicitly'
            )
        candidates: list[int] = []
        latest = self.latest_step()
        if latest is not None:
            candidates.append(latest)
        candidates += [s for s in self.rotation_steps() if s != latest]
        for step in candidates:
            path = self.checkpoint_path(step)
            if not self._is_committed(step):
                self._warn_fallback(
                    path, 'missing commit marker (torn or in-flight write)'
                )
                continue
            try:
                state, extra = checkpoint_lib.restore(
                    path, engine, extra_template=extra_template
                )
            except KeyboardInterrupt:
                raise
            except Exception as exc:
                self._warn_fallback(path, f'{type(exc).__name__}: {exc}')
                continue
            restored_step = int(state.step)
            multihost.assert_same_step(restored_step)
            self._last_saved_step = restored_step
            return RestoreResult(state, extra, restored_step, path)
        return None

    def _warn_fallback(self, path: str, why: str) -> None:
        if path in self._warned_paths:
            return
        self._warned_paths.add(path)
        _warnings.warn(
            f'checkpoint candidate {path!r} is unusable ({why}); falling '
            'back to the previous rotation entry',
            CheckpointResilienceWarning,
            stacklevel=3,
        )

    # ------------------------------------------------------------- lifecycle

    def finalize(self) -> None:
        """Flush any in-flight async save (commit its pointer)."""
        self._flush_pending()

    def close(self) -> None:
        """Finalize and restore the signal handlers this manager
        installed."""
        self.finalize()
        if self._signal_handle is not None:
            self._signal_handle.uninstall()
            self._signal_handle = None

    def __enter__(self) -> 'CheckpointManager':
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
