"""Host-offloaded async refresh: the window's decompositions on a worker
thread (counterpart of ``kfac_tpu/async_inverse/host.py``).

At each window boundary the engine's step enqueues copies of the freshly
updated factors and of the layers' effective dampings into pinned host
memory on the current stream, records a CUDA event behind them, and hands
both to a worker thread; the step thread never waits on that event. The
worker waits on it, decomposes with numpy's LAPACK while the card keeps
stepping, and uploads the result on a stream of its own, with an event
behind the upload. At the next boundary the Trainer's :func:`pump` takes the
result, makes the current stream wait on the upload's event, and promotes
it through the sliced backend's swap core, so health gating, the discard of
a quarantined layer's refresh and ``last_inv_step`` are the same. No host
sync on the card's side.

The step itself runs no decomposition after the step-0 cold start. Results
are the synchronous path's maths (LAPACK against the device's eigh: the
same numbers to rounding, not the same bits), one window staler.

With a :class:`~kfac_tpu_torch.parallel.DistributedKFAC` each rank's
worker decomposes that rank's own factor blocks (a slot's LAPACK eigh is
the same whether it sees the block or the gathered stack, as the JAX
package's worker does). At a boundary every rank waits for its own
worker, then every rank gathers the blocks within its column and swaps
through the distributed swap core, so the collectives line up.

Driving: with a step number :func:`pump` swaps only at window boundaries,
waiting for the refresh in flight; without one (``Trainer.scan_steps``,
at entry, as the JAX package pumps its ``lax.scan``) it applies a finished
result, if any, without waiting; a distributed engine waits for the
refresh in flight there too, since every rank must enter the swap's
collectives alike. An engine stepped without the pump never swaps: it
keeps applying its last decompositions.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from kfac_tpu_torch import checkpoint
from kfac_tpu_torch import tracing
from kfac_tpu_torch.async_inverse import sliced as sliced_lib
from kfac_tpu_torch.hyperparams import resolve
from kfac_tpu_torch.parallel import collectives as collectives_lib


class HostRefreshWorker:
    """A daemon thread that runs decomposition jobs off the step path.

    :meth:`submit` enqueues a job and returns at once; the thread keeps the
    latest finished payload (a newer window's wins). :meth:`take` drains
    it, waiting for the job in flight when asked (the boundary pump).
    :meth:`reset` drops work in flight and finished, after a restore.
    """

    def __init__(self, compute: Callable[..., Any]):
        self._compute = compute
        self._jobs: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0
        self._result: Any = None
        self._epoch = 0
        self._last_step = -1
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name='kfac-async-refresh', daemon=True
            )
            self._thread.start()

    def submit(self, step: int, ready: torch.cuda.Event | None, *args: Any) -> None:
        """Queue ``compute(*args)`` for the window launched at ``step``.
        ``args`` are host copies that nothing else writes; ``ready`` is the
        event behind the copies into them (None for CPU tensors)."""
        with self._cv:
            self._pending += 1
            epoch = self._epoch
        self._jobs.put((epoch, step, ready, args))
        self._ensure_thread()

    def _run(self) -> None:
        while True:
            epoch, step, ready, args = self._jobs.get()
            out, err = None, None
            try:
                if ready is not None:
                    ready.synchronize()
                out = self._compute(*args)
            except Exception as e:  # raised again by the next take()
                err = e
            with self._cv:
                self._pending -= 1
                # a job of an older window never replaces a newer result
                if epoch == self._epoch:
                    if err is not None:
                        self._error = err
                    elif out is not None and step >= self._last_step:
                        self._result = out
                        self._last_step = step
                self._cv.notify_all()

    def has_work(self) -> bool:
        with self._cv:
            return self._pending > 0 or self._result is not None or self._error is not None

    def take(self, wait: bool = False, timeout: float = 300.0) -> Any:
        """The latest finished payload, or None. With ``wait``, block
        until no job is in flight first (a boundary must not swap a torn
        refresh). A worker's exception is raised here."""
        with self._cv:
            if wait:
                self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError('async inverse host refresh failed') from err
            if self._pending > 0 and not wait:
                return None
            result, self._result = self._result, None
            return result

    def reset(self) -> None:
        """Drop work in flight and finished: after a restore, the factors
        that produced it are not the state's."""
        with self._cv:
            self._epoch += 1
            self._result = None
            self._error = None
            self._last_step = -1


def reset_worker(engine) -> None:
    w = getattr(engine, '_async_worker', None)
    if w is not None:
        w.reset()


def _uploader(device: torch.device) -> Callable[[dict], tuple[dict, Any]]:
    """``upload(out)``: the worker's numpy results as tensors on ``device``,
    copied on a stream of the worker's own with an event behind them
    (None on the CPU)."""
    stream = torch.cuda.Stream(device) if device.type == 'cuda' else None

    def upload(out: dict[str, dict[str, np.ndarray]]):
        if stream is None:
            return {f: {n: torch.from_numpy(v) for n, v in d.items()} for f, d in out.items()}, None
        with torch.cuda.device(device), torch.cuda.stream(stream):
            tensors = {
                f: {n: torch.from_numpy(v).to(device, non_blocking=True) for n, v in d.items()}
                for f, d in out.items()
            }
            ready = torch.cuda.Event()
            ready.record(stream)
        return tensors, ready

    return upload


def _await_upload(engine, payload: dict[str, Any]) -> None:
    """Make the current stream wait on a payload's upload and hand its
    tensors (allocated on the worker's stream) to it."""
    if payload['ready'] is not None:
        current = torch.cuda.current_stream(engine.device)
        current.wait_event(payload['ready'])
        for d in payload['fields'].values():
            for t in d.values():
                t.record_stream(current)


def _dense_compute(engine) -> Callable[..., dict[str, Any]]:
    """The worker's refresh, as the JAX package's: numpy LAPACK in f32,
    eigenvalues clipped at 0, fused prediv ``1 / (outer(dg, da) + eff)``,
    or INVERSE as ``inv(F + eff I)``. The payload is uploaded to the
    engine's device on the worker's own stream; ``ready`` is the event
    behind the upload (None on the CPU)."""
    fields = sliced_lib.decomp_fields(engine.compute_method, engine.prediv_eigenvalues)
    upload = _uploader(engine.device)

    def compute(damping: float, effs, a: dict, g: dict) -> dict[str, Any]:
        out: dict[str, dict[str, np.ndarray]] = {f: {} for f in fields}
        for i, name in enumerate(a):
            eff = float(effs[i])
            fa = a[name].numpy().astype(np.float32, copy=False)
            fg = g[name].numpy().astype(np.float32, copy=False)
            if engine.eigen:
                wa, va = np.linalg.eigh(fa)
                wg, vg = np.linalg.eigh(fg)
                wa = np.clip(wa, 0.0, None)
                wg = np.clip(wg, 0.0, None)
                out['qa'][name] = va
                out['qg'][name] = vg
                if engine.prediv_eigenvalues:
                    out['dgda'][name] = (1.0 / (np.outer(wg, wa) + eff)).astype(np.float32)
                else:
                    out['da'][name] = wa
                    out['dg'][name] = wg
            else:
                eye_a = np.eye(fa.shape[0], dtype=np.float32)
                eye_g = np.eye(fg.shape[0], dtype=np.float32)
                out['a_inv'][name] = np.linalg.inv(fa + eff * eye_a)
                out['g_inv'][name] = np.linalg.inv(fg + eff * eye_g)
        tensors, ready = upload(out)
        return {'fields': tensors, 'damping': damping, 'ready': ready}

    return compute


@tracing.scope('kfac.async_host_launch')
def dense_host_step(engine, state: Any):
    """The host backend's stage of the engine's step: the step-0 cold
    start, then at each window boundary the launch of the window's refresh
    from the factors after this step's update."""
    if engine._async_worker is None:
        engine._async_worker = HostRefreshWorker(_dense_compute(engine))
    if state.step == 0:
        state = engine.update_inverses(state)
    if state.step % engine._async_n_steps == 0:
        damping = resolve(engine.damping, state.step)
        effs = engine._effective_damping(state, damping)
        # copies enqueued before the next step updates the factors in place
        (effs, a, g), ready = checkpoint.snapshot((effs, state.a, state.g))
        engine._async_worker.submit(state.step, ready, damping, effs, a, g)
    return state


def dense_apply(engine, state: Any, payload: dict[str, Any]):
    """Promote a finished host payload through the shared swap core, after
    the current stream has waited on its upload."""
    _await_upload(engine, payload)
    return sliced_lib.dense_swap_core(engine, state, payload['fields'], complete=True)


def _kaisa_compute(engine) -> Callable[..., dict[str, Any]]:
    """The distributed worker's refresh of this rank's factor blocks, the
    JAX package's maths: numpy LAPACK in f32 a slot, eigenvalues clipped
    at 0, fused prediv ``1 / (dg (x) da + dmp)``, or INVERSE as ``inv(F +
    dmp I)``, at each slot's damping ``dmp``. The blocks are uploaded as
    :func:`_dense_compute`'s payload is; the column gather runs at the
    swap."""
    fields = sliced_lib.decomp_fields(engine.config.compute_method, engine._prediv)
    upload = _uploader(engine.device)

    def compute(damping: float, dmp: dict, a: dict, g: dict) -> dict[str, Any]:
        out: dict[str, dict[str, np.ndarray]] = {f: {} for f in fields}
        eig: dict[tuple[str, str], np.ndarray] = {}
        for side, blocks in (('a', a), ('g', g)):
            for key, block in blocks.items():
                f32 = block.numpy().astype(np.float32, copy=False)
                slot_dmp = np.broadcast_to(np.asarray(dmp[side, key], np.float32), (f32.shape[0],))
                if engine._eigen:
                    w, v = np.linalg.eigh(f32)
                    w = np.clip(w, 0.0, None)
                    out['q' + side][key] = v
                    if engine._prediv:
                        eig[side, key] = w
                        if side == 'a':
                            eig['dmp', key] = slot_dmp
                    else:
                        out['d' + side][key] = w
                else:
                    eye = np.eye(f32.shape[-1], dtype=np.float32)
                    out[side + '_inv'][key] = np.linalg.inv(f32 + slot_dmp[:, None, None] * eye)
        if engine._prediv:
            for b in engine.buckets:
                out['dgda'][b.key] = (1.0 / (
                    eig['g', b.key][:, :, None] * eig['a', b.key][:, None, :]
                    + eig['dmp', b.key][:, None, None]
                )).astype(np.float32)
        tensors, ready = upload(out)
        return {'fields': tensors, 'damping': damping, 'ready': ready}

    return compute


@tracing.scope('dist_kfac.async_host_launch')
def kaisa_host_step(engine, state: Any):
    """The distributed engine's host stage: the step-0 cold start, then at
    each window boundary the launch of this rank's blocks' refresh from
    the factors after this step's update, with each slot's damping."""
    if engine._async_worker is None:
        engine._async_worker = HostRefreshWorker(_kaisa_compute(engine))
    if state.step == 0:
        state = engine.update_inverses(state)
    if state.step % engine._async_n_steps == 0:
        damping = float(resolve(engine.config.damping, state.step))
        dmp = {
            (side, sb.key): damping if engine.health is None
            else damping * engine._block_mults(state, side, sb)
            for side, store in (('a', engine.a_store), ('g', engine.g_store)) for sb in store
        }
        (dmp, a, g), ready = checkpoint.snapshot((dmp, state.a, state.g))
        engine._async_worker.submit(state.step, ready, damping, dmp, a, g)
    return state


def kaisa_apply(engine, state: Any, payload: dict[str, Any]):
    """Promote a finished payload of this rank's blocks: after the current
    stream has waited on its upload, each field's blocks are gathered
    within the column (every rank, in one order) and swapped through the
    distributed swap core."""
    _await_upload(engine, payload)
    col = engine.mesh.col_group
    cand = {
        f: {k: collectives_lib.all_gather_cat(v, col) for k, v in d.items()}
        for f, d in payload['fields'].items()
    }
    return sliced_lib.kaisa_swap_core(engine, state, cand, payload['damping'], complete=True)


@tracing.trace(name='kfac.async_host_pump')
def pump(engine, state: Any, step: int | None = None):
    """Promote a finished host refresh into ``state`` (the Trainer calls
    this before each step; a no-op outside host mode).

    With ``step``: only at a window boundary past step 0, waiting for the
    refresh in flight (the host's counterpart of the synchronous spike,
    about 0 when the window gave the worker time enough). Without it: a
    finished payload, if any, without waiting. Returns the state.
    """
    if getattr(engine, '_async_mode', None) != 'host':
        return state
    worker = engine._async_worker
    if worker is None or not worker.has_work():
        return state
    distributed = hasattr(engine, 'a_store')
    if step is not None:
        if step <= 0 or step % engine._async_n_steps != 0:
            return state
        payload = worker.take(wait=True)
    else:
        payload = worker.take(wait=distributed)
    if payload is None:
        return state
    return (kaisa_apply if distributed else dense_apply)(engine, state, payload)
