"""Cold-factor host offload: the factors go to host memory between cadence
boundaries and come back ahead of the next one (counterpart of
``kfac_tpu/compression/offload.py``).

The factors ``state.a`` / ``state.g`` are read only on a factor-update
step (``step % factor_update_steps == 0``) or a refresh step (``step %
inv_update_steps == 0``); between those they are device memory that no
step touches. The preconditioning reads the decompositions, which stay
resident.

:func:`pump` runs on the host at step entry (the Trainer calls it), as in
the JAX package. A spill enqueues copies of the factors into pinned host
buffers on the current stream, records an event behind them, and puts
zero-size placeholders in the state; the device tensors are dropped, and
the caching allocator may reuse their blocks at once, since everything
after the copies on the same stream runs after them. A prefetch copies the
host buffers back on a side stream, behind that event; a restore makes
the current stream wait on the prefetch and hands the tensors to it
(``record_stream``), or copies on the current stream when no prefetch ran
(a miss). None of these reads a device value on the host. The engines'
``step`` sees the placeholders (:func:`is_spilled`, from shapes alone)
and skips the factor and refresh work, which the pump's restore before
every boundary makes exact. Copies move bytes verbatim, so training with
offload on is bitwise training with it off.

The host copies are ephemeral: a checkpoint of a spilled state is refused
(``checkpoint.durable_state``), :meth:`OffloadManager.host_view` gives the
Trainer's checkpoint autopilot a resident view from the host buffers, and
a restore resets the manager.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kfac_tpu_torch import tracing

_SIDES = ('a', 'g')


def _cfg(engine: Any) -> Any:
    """The carrier of the knobs: ``engine.config`` for ``DistributedKFAC``,
    the dense engine itself."""
    return getattr(engine, 'config', engine)


def is_spilled(state: Any) -> bool:
    """Whether the state's factor dicts hold offload placeholders
    (zero-size 1-D tensors, told from a ``(d, d)`` factor or a ``(L, d,
    d)`` block by their shape, with no device read)."""
    a = getattr(state, 'a', None)
    if not a:
        return False
    v = next(iter(a.values()))
    return v.ndim == 1 and v.shape[0] == 0


class OffloadManager:
    """The host owner of one engine's spilled factors.

    Holds the pinned host copies while the state carries placeholders,
    runs the prefetch, and keeps the counters ``comms_report()`` and the
    bench's compression probe read (``spills``, ``restores``,
    ``prefetch_hits``, ``prefetch_misses``, ``bytes_to_host``,
    ``bytes_to_device``). Construction touches no device.
    """

    def __init__(self, engine: Any) -> None:
        self.engine = engine
        self.cfg = _cfg(engine).offload
        self.device = torch.device(engine.device)
        self.spilled = False
        self._host: dict[str, dict[str, torch.Tensor]] | None = None
        self._spill_event: torch.cuda.Event | None = None
        self._inflight: dict[str, dict[str, torch.Tensor]] | None = None
        self._inflight_event: torch.cuda.Event | None = None
        self._stream: torch.cuda.Stream | None = None
        self.stats = {
            'spills': 0,
            'restores': 0,
            'prefetch_hits': 0,
            'prefetch_misses': 0,
            'bytes_to_host': 0,
            'bytes_to_device': 0,
        }

    @property
    def _cuda(self) -> bool:
        return self.device.type == 'cuda'

    def reset(self) -> None:
        """Forget the spilled and in-flight copies (after a checkpoint
        restore or ``rematerialize``: the caller's state is resident)."""
        self.spilled = False
        self._host = None
        self._spill_event = None
        self._inflight = None
        self._inflight_event = None

    def _nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for d in self._host.values() for t in d.values())

    # ----------------------------------------------------------- transfers

    def spill(self, state: Any) -> Any:
        """Copy the factors into host memory and put placeholders in their
        place."""
        if self.spilled:
            return state
        host: dict[str, dict[str, torch.Tensor]] = {}
        for side in _SIDES:
            host[side] = {}
            for key, t in getattr(state, side).items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._cuda)
                h.copy_(t, non_blocking=self._cuda)
                host[side][key] = h
        if self._cuda:
            self._spill_event = torch.cuda.Event()
            self._spill_event.record(torch.cuda.current_stream(self.device))
        self._host = host
        self.stats['spills'] += 1
        self.stats['bytes_to_host'] += self._nbytes()
        self.spilled = True
        return _replace_factors(state, {
            side: {
                k: torch.zeros((0,), dtype=t.dtype, device=self.device)
                for k, t in getattr(state, side).items()
            }
            for side in _SIDES
        })

    def _put_all(self, stream: torch.cuda.Stream | None) -> dict[str, dict[str, torch.Tensor]]:
        """Device copies of the host buffers, enqueued on ``stream`` (the
        current one when None); non-blocking from pinned memory."""
        if not self._cuda:
            return {side: {k: h.clone() for k, h in d.items()} for side, d in self._host.items()}
        stream = stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            return {
                side: {k: h.to(self.device, non_blocking=True) for k, h in d.items()}
                for side, d in self._host.items()
            }

    def start_prefetch(self) -> None:
        """Start the copy back to the device on a side stream, behind the
        spill's copies (idempotent)."""
        if not self.spilled or self._inflight is not None:
            return
        if not self._cuda:
            self._inflight = self._put_all(None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_event(self._spill_event)
        self._inflight = self._put_all(self._stream)
        self._inflight_event = torch.cuda.Event()
        self._inflight_event.record(self._stream)

    def restore(self, state: Any) -> Any:
        """Put device factors back into the state: the prefetched ones
        (a hit; the current stream waits on their copy) or, without a
        prefetch, copies enqueued here on the current stream (a miss)."""
        if not self.spilled:
            return state
        if self._inflight is not None:
            self.stats['prefetch_hits'] += 1
            bufs = self._inflight
            if self._cuda:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(self._inflight_event)
                for d in bufs.values():
                    for t in d.values():
                        t.record_stream(current)  # allocated on the side stream
        else:
            self.stats['prefetch_misses'] += 1
            bufs = self._put_all(None)
        self.stats['restores'] += 1
        self.stats['bytes_to_device'] += self._nbytes()
        self.reset()
        return _replace_factors(state, bufs)

    def host_view(self, state: Any) -> Any:
        """A resident view of a spilled state whose factors are the host
        buffers (no device traffic): what the checkpoint autopilot saves
        inside a spill window. Waits for the spill's copies to land (the
        one host sync of this class, taken only by a save)."""
        if not self.spilled:
            return state
        if self._spill_event is not None:
            self._spill_event.synchronize()
        return _replace_factors(state, {side: dict(d) for side, d in self._host.items()})


def _replace_factors(state: Any, factors: dict[str, dict[str, torch.Tensor]]) -> Any:
    return dataclasses.replace(state, a=factors['a'], g=factors['g'])


def _next_use(step: int, f: int, c: int) -> int:
    """The first step at or after ``step`` that reads the factors: a factor
    update (``% f``) or a refresh (``% c``)."""
    return min(step + (-step) % f, step + (-step) % c)


@tracing.trace(name='kfac.offload_pump')
def pump(engine: Any, state: Any, step: int | None = None) -> Any:
    """Drive the offload at step entry, on the host.

    With ``step`` (the eager Trainer paths): restore before a step that
    reads the factors, start the prefetch ``prefetch_lead`` steps before
    it, and spill after it once the next such step is ``min_cold_steps``
    or more away. Without (the scan paths, as the JAX package's scan):
    restore, and leave the factors resident for the whole run.
    """
    mgr = getattr(engine, '_offload_manager', None)
    if mgr is None:
        return state
    if step is None:
        return mgr.restore(state)
    cfg = _cfg(engine)
    nu = _next_use(step, int(cfg.factor_update_steps), int(cfg.inv_update_steps))
    if mgr.spilled:
        if nu == step:
            return mgr.restore(state)
        if nu - step <= mgr.cfg.prefetch_lead:
            mgr.start_prefetch()
        return state
    if nu > step and nu - step >= mgr.cfg.min_cold_steps:
        return mgr.spill(state)
    return state
