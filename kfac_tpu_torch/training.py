"""Training engine: K-FAC-preconditioned train steps with capture cadence
(counterpart of ``kfac_tpu/training.py``).

The :class:`Trainer` holds the ``nn.Module`` (whose parameters are the
trained weights) and a ``torch.optim`` optimizer; a :class:`TrainState`
carries what the JAX package's state carries beside them: the K-FAC state
and the model's mutable state. The factor cadence is the K-FAC state's
step, a host integer, so a capture step and a plain step are two Python
branches and no step reads a device value on the host, with two
exceptions, both the health sentinel's: ``skip_nonfinite`` reads the
finiteness of the loss and grads once a step (where the JAX package gates
the update with ``lax.cond`` on the device), and ``warn`` reads the health
counters after each eager step, as the JAX Trainer does. A checkpoint
manager (``checkpoints``) adds none on a step that does not save. Under
``async_inverse='host'`` every step path pumps the engine's refresh worker
where the JAX Trainer does (:meth:`Trainer._drive_async`), and under
``offload`` every step entry drives the spill, prefetch and restore of the
factors (:meth:`Trainer._drive_offload`); a save that lands inside a spill
window writes the offload manager's resident host view.

With a :class:`~kfac_tpu_torch.parallel.DistributedKFAC` every rank runs
the Trainer on the same global batch: each step takes the rank's row
block of it (the JAX package's ``batch_sharding``), and before the
engine's step the grads and the loss are mean-reduced across the ranks
(what pjit does implicitly), so the loss a step returns and the
parameters every rank updates are the global ones; the port's BatchNorm
layers take their batch moments over the global batch, as pjit's do
(``models.layers.sync_batch_norms``); the health sentinel's
``skip_nonfinite`` judges those reduced values, so its verdict is the same
on every rank. Its checkpoints are sharded: every rank saves its factor
blocks, rank 0 the extras, and every rank loads the extras on a restore,
so the parameters are bitwise equal on every rank after it.

On a :class:`~kfac_tpu_torch.parallel.mesh.TrainGrid` with ``model`` and
``seq`` axes each rank takes its row block and its sequence shard of the
global batch (``TrainGrid.local_tokens``), and the reduction averages the
loss and the replicated parameters' grads over every rank and the
tensor-parallel shards' grads over the data and sequence ranks
(``DistributedKFAC.average_grads``); :meth:`Trainer.step` is otherwise
the same. Checkpoints are not ported there yet.

Knobs of the JAX Trainer whose slice comes later (``auto_layout``,
``fleet``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import torch
import torch.nn as nn
from torch.utils import _pytree as pytree

from kfac_tpu_torch import health as health_lib
from kfac_tpu_torch import tracing
from kfac_tpu_torch.async_inverse import host as async_host_lib
from kfac_tpu_torch.compression import offload as offload_lib
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.observability import ledger as ledger_lib
from kfac_tpu_torch.preconditioner import set_grads


@dataclasses.dataclass
class TrainState:
    """``kfac_state``: the preconditioner's state (None without K-FAC);
    ``model_state``: mutable model collections, or None."""

    kfac_state: Any
    model_state: Any = None


_LATER_SLICE_KNOBS = ('auto_layout', 'fleet')


def _index(tree: Any, i: int) -> Any:
    """Entry ``i`` of the leading axis of every tensor in nested tuples,
    lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, i) for v in tree)
    raise TypeError(f'batches hold tensors in tuples, lists and dicts, not {type(tree)}')


def _leading(tree: Any) -> int:
    """Length of the leading axis of the first tensor in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    values = tree.values() if isinstance(tree, dict) else tree
    return _leading(next(iter(values)))


@dataclasses.dataclass
class Trainer:
    """Builds and dispatches K-FAC train steps.

    Args:
        model: the trained module; its parameters must lie on ``device``.
        optimizer: a ``torch.optim`` optimizer over ``model``'s parameters.
        loss_fn: ``loss_fn(model_state, batch) -> (loss, new_model_state)``;
            runs ``model`` inside, so capture's hooks see its layers.
        kfac: a :class:`kfac_tpu_torch.KFACPreconditioner` (anything with
            its ``registry``, ``factor_update_steps``, ``init`` and
            ``step``), a :class:`kfac_tpu_torch.parallel.DistributedKFAC`
            (data-parallel over its grid's ranks, each rank running its own
            Trainer and manager over one shared rotation), or None for a first-order baseline. Its registry's model must
            be ``model``; its ``factor_update_steps`` sets the capture
            cadence.
        checkpoints: a :class:`kfac_tpu_torch.resilience.CheckpointManager`.
            Every step entry (:meth:`step`, :meth:`scan_steps`,
            :meth:`apply_accumulated`, :meth:`step_accumulate` and
            :meth:`step_accumulate_scan`) calls its ``on_step`` once after
            its update, so periodic async saves and signal-driven emergency
            saves ride the loop; :meth:`restore_latest` resumes from its
            rotation. Its saves hold :meth:`checkpoint_extras` beside the
            K-FAC state, and a manager without an engine gets ``kfac``.
        run_id: identifier stamped into :meth:`run_header`; generated when
            None.
        device: where the model lies, ``'cuda'`` unless the caller passes
            another.
        local_batches: with a distributed engine, each step's batch is
            already this rank's row block (a per-rank loader,
            ``kfac_tpu_torch.data.lm_batches(..., rank, world)``): no row
            block is cut from it (a grid with a ``seq`` axis still takes its
            sequence positions).
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, Any]]
    kfac: Any = None
    checkpoints: Any = None
    auto_layout: Any = None
    fleet: Any = None
    run_id: str | None = None
    device: str | torch.device = 'cuda'
    local_batches: bool = False

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        for knob in _LATER_SLICE_KNOBS:
            if getattr(self, knob) is not None:
                raise NotImplementedError(f'Trainer({knob}=...) is not ported to kfac_tpu_torch yet')
        for p in self.model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f'model parameters are on {p.device}, not on {self.device}')
        if self.run_id is None:
            self.run_id = ledger_lib.new_run_id()
        # host mirror of kfac_state.step for cadence dispatch; None until
        # the first step reads it from the state (see resume)
        self._step_count: int | None = None
        self._accum: dict[str, Any] | None = None
        # whether the preconditioner's step accepts the loss; duck-typed so
        # engines with the bare (state, grads, stats) signature work
        self._kfac_takes_loss = (
            self.kfac is not None
            and 'loss' in inspect.signature(self.kfac.step).parameters
        )
        self._run_plain = capture_lib.value_and_grad(self.model, self.loss_fn, has_aux=True)
        if self.kfac is not None:
            self._bind_capture()
        if self.checkpoints is not None:
            if self.kfac is None:
                raise ValueError(
                    'Trainer(checkpoints=...) requires a kfac preconditioner: '
                    'the CheckpointManager persists the K-FAC durable state'
                )
            if getattr(self.kfac, 'total_devices', None) not in (None, getattr(self.kfac, 'world', None)):
                raise NotImplementedError(
                    'Trainer(checkpoints=...) with a DistributedKFAC over a grid with model or '
                    'seq axes is not ported to kfac_tpu_torch yet'
                )
            self.checkpoints.extras_of = self.checkpoint_extras
            if self.checkpoints.engine is None:
                self.checkpoints.engine = self.kfac

    def _distributed(self) -> bool:
        """Whether the engine is data-parallel over a grid of ranks."""
        return hasattr(self.kfac, 'average_grads')

    def _local(self, batch):
        """This rank's part of a global batch: its row block, and its
        sequence shard on a grid with a ``seq`` axis (the batch itself
        without a distributed engine); with ``local_batches`` the batch is
        the row block already."""
        if not self._distributed():
            return batch
        grid = self.kfac.mesh
        if not self.local_batches:
            return grid.local_tokens(batch)
        if getattr(grid, 'seq', 1) == 1 and not getattr(grid, 'zigzag', False):
            return batch
        return pytree.tree_map_only(torch.Tensor, grid.take_seq, batch)

    def _reduce(self, grads, loss):
        """The mean grads and loss over the ranks, each shard's over the
        ranks that hold it (as they are without a distributed engine)."""
        return self.kfac.average_grads(grads, loss) if self._distributed() else (grads, loss)

    def _bind_capture(self) -> None:
        if self.kfac.registry.model is not self.model:
            raise ValueError('the registry was built over another model than the trainer\'s')
        self._run_stats = capture_lib.CurvatureCapture(self.kfac.registry).value_stats_and_grad(
            self.loss_fn, has_aux=True
        )
        layers_lib.sync_batch_norms(self.model, self.kfac.mesh if self._distributed() else None)

    # ------------------------------------------------------------- builders

    def init(self, model_state: Any = None) -> TrainState:
        return TrainState(
            kfac_state=None if self.kfac is None else self.kfac.init(),
            model_state=model_state,
        )

    def run_header(self, stream: str) -> dict[str, Any]:
        """The shared run-header record for one telemetry stream."""
        return ledger_lib.run_header(self.run_id, stream)

    def _health_cfg(self) -> health_lib.HealthConfig | None:
        """The engine's health config, or None when the sentinel is off."""
        return None if self.kfac is None else getattr(self.kfac, 'health', None)

    def _finish_step(
        self, state: TrainState, grads, stats, new_model_state, loss
    ) -> TrainState:
        """Precondition (with K-FAC), write the grads into ``.grad`` and
        take the optimizer step.

        With the health sentinel's ``skip_nonfinite``, a non-finite loss or
        gradient skips the whole update: the parameters, the optimizer
        state, the factors and the model state stay put; only the step
        clock and ``skipped_steps`` advance. The verdict is read on the
        host, one sync a step.
        """
        kstate = state.kfac_state
        hc = self._health_cfg()
        if (
            hc is not None and hc.skip_nonfinite
            and getattr(kstate, 'health', None) is not None
            and not bool(health_lib.all_finite(loss, grads))
        ):
            return TrainState(health_lib.mark_skipped(kstate), state.model_state)
        if self.kfac is not None:
            if self._kfac_takes_loss:
                kstate, grads = self.kfac.step(kstate, grads, stats, loss=loss)
            else:
                kstate, grads = self.kfac.step(kstate, grads, stats)
        set_grads(self.model, grads)
        self.optimizer.step()
        return TrainState(kstate, new_model_state)

    # ------------------------------------------------------------- dispatch

    def resume(self, state: TrainState) -> None:
        """Align cadence dispatch with a (restored) TrainState's step.

        Called automatically on the first step; call explicitly after
        swapping in a different state mid-run.
        """
        ks = state.kfac_state
        self._step_count = 0 if ks is None else int(ks.step)

    def _sync_step_count(self, state: TrainState) -> None:
        if self._step_count is None:
            self.resume(state)

    def rebind_engine(self, engine: Any) -> None:
        """Swap in a rebuilt preconditioner over the same model (another
        configuration, or a dense engine for a distributed one and back):
        the capture is rebuilt from its registry, the step mirror resyncs
        from the next state, and the checkpoint manager saves and restores
        with it, so :meth:`restore_latest` then migrates the rotation's
        checkpoint into its layout."""
        self.kfac = engine
        self._kfac_takes_loss = 'loss' in inspect.signature(engine.step).parameters
        self._bind_capture()
        self._step_count = None
        if self.checkpoints is not None:
            self.checkpoints.engine = engine

    # ---------------------------------------------------------- checkpoints

    def checkpoint_extras(self, state: TrainState) -> dict[str, Any]:
        """What a checkpoint holds beside the K-FAC state: the module's and
        the optimizer's ``state_dict()`` (aliases of the live tensors; the
        save snapshots them) and the ``model_state`` when there is one.
        With a distributed engine every rank passes them and rank 0's are
        written."""
        extra = {'model': self.model.state_dict(), 'optimizer': self.optimizer.state_dict()}
        if state.model_state is not None:
            extra['model_state'] = state.model_state
        return extra

    def _drive_checkpoints(self, state: TrainState) -> None:
        """Tick the checkpoint autopilot after a completed step (host work
        only unless it saves). A ``Preempted`` raised here leaves the step
        call with the emergency checkpoint already durable. Inside a spill
        window of the cold-factor offload the manager gets a resident view
        built from the offload manager's host copies, so a checkpoint never
        holds placeholders."""
        if self.checkpoints is None:
            return
        mgr = getattr(self.kfac, '_offload_manager', None)
        if mgr is not None and mgr.spilled and state.kfac_state is not None:
            state = dataclasses.replace(state, kfac_state=mgr.host_view(state.kfac_state))
        self.checkpoints.on_step(state, step=self._step_count)

    def restore_latest(self, model_state: Any = None) -> TrainState | None:
        """Resume from the ``checkpoints`` manager's newest good checkpoint:
        the module's parameters and buffers and the optimizer's state are
        loaded in place, and the returned ``TrainState`` carries the
        rematerialized K-FAC state and the saved ``model_state`` (else
        ``model_state``), with the cadence dispatch aligned to the restored
        step. Returns None when the rotation holds nothing restorable (a
        fresh start: call :meth:`init`)."""
        if self.checkpoints is None:
            raise ValueError(
                'Trainer has no checkpoints manager: construct with '
                'checkpoints=CheckpointManager(...)'
            )
        result = self.checkpoints.restore_latest(
            engine=self.kfac, extra_template={'model': None, 'optimizer': None}
        )
        if result is None:
            return None
        self.model.load_state_dict(result.extra['model'])
        self.optimizer.load_state_dict(result.extra['optimizer'])
        saved_ms = result.extra.get('model_state', model_state)
        state = TrainState(result.state, pytree.tree_map_only(
            torch.Tensor, lambda t: t.to(self.device), saved_ms))
        self._accum = None
        self.resume(state)
        return state

    def check_health(self, state: TrainState) -> dict[str, Any]:
        """Host snapshot of the health counters (``health.summary``), with
        the first-occurrence warnings of quarantined and degraded layers;
        ``{}`` when the sentinel is off. One read from the device: the eager
        step paths call it after each step when ``HealthConfig.warn`` is
        set, :meth:`scan_steps` never does."""
        hc = self._health_cfg()
        ks = state.kfac_state
        if hc is None or ks is None or getattr(ks, 'health', None) is None:
            return {}
        return health_lib.check_and_warn(hc, ks.health, step=self._step_count)

    def _maybe_warn(self, state: TrainState) -> None:
        hc = self._health_cfg()
        if hc is not None and hc.warn:
            self.check_health(state)

    def _drive_async(self, state: TrainState, step: int | None) -> TrainState:
        """Promote a finished host-offloaded inverse refresh into the K-FAC
        state (``async_inverse='host'``, on either engine; a no-op
        otherwise). With ``step``: only at window boundaries, waiting for the
        refresh in flight. Without (``scan_steps``, once at entry, as the JAX
        Trainer pumps its compiled scan): a finished refresh, without
        waiting (a distributed engine waits, so its ranks swap alike)."""
        if (
            self.kfac is None
            or state.kfac_state is None
            or getattr(self.kfac, '_async_mode', None) != 'host'
        ):  # as the JAX Trainer: the traced pump runs in host mode only
            return state
        ks = async_host_lib.pump(self.kfac, state.kfac_state, step=step)
        if ks is state.kfac_state:
            return state
        return dataclasses.replace(state, kfac_state=ks)

    def _drive_offload(self, state: TrainState, step: int | None) -> TrainState:
        """Tick the cold-factor offload (``offload``; a no-op otherwise):
        with ``step``, spill, prefetch and restore on the cadence; without
        (``scan_steps``, as the JAX Trainer's scan), restore the factors and
        keep them resident for the whole run
        (:func:`kfac_tpu_torch.compression.offload.pump`)."""
        if (
            self.kfac is None
            or state.kfac_state is None
            or getattr(self.kfac, '_offload_manager', None) is None
        ):
            return state
        ks = offload_lib.pump(self.kfac, state.kfac_state, step=step)
        if ks is state.kfac_state:
            return state
        return dataclasses.replace(state, kfac_state=ks)

    def _capture_now(self) -> bool:
        """The engine's factor cadence at the host step count (a schedule
        is a function of the step)."""
        cadence = self.kfac.factor_update_steps
        if callable(cadence):
            cadence = max(1, int(cadence(self._step_count)))
        return self._step_count % cadence == 0

    def _step(self, state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        self._sync_step_count(state)
        batch = self._local(batch)
        if self.kfac is not None and self._capture_now():
            (loss, new_ms), grads, stats = self._run_stats(state.model_state, batch)
        else:
            (loss, new_ms), grads = self._run_plain(state.model_state, batch)
            stats = None
        grads, loss = self._reduce(grads, loss)
        new_state = self._finish_step(state, grads, stats, new_ms, loss)
        self._step_count += 1
        return new_state, loss

    @tracing.trace(name='trainer/step')
    def step(self, state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        """One optimization step; captures curvature on the factor cadence.

        Returns the new state and the loss as a 0-d tensor on the device
        (not read on the host). Recorded in the tracing table as
        ``trainer/step``.
        """
        self._sync_step_count(state)
        state = self._drive_async(state, self._step_count)
        state = self._drive_offload(state, self._step_count)
        new_state, loss = self._step(state, batch)
        self._maybe_warn(new_state)
        self._drive_checkpoints(new_state)
        return new_state, loss

    @tracing.trace(name='trainer/scan_steps')
    def scan_steps(self, state: TrainState, batches) -> tuple[TrainState, torch.Tensor]:
        """``len(batches)`` steps over the leading axis of ``batches``
        (tensors in nested tuples, lists and dicts), on the same cadence as
        :meth:`step`. Returns the final state and the per-step losses
        stacked on the device.

        Unlike the JAX package's ``lax.scan``, this is a host loop of eager
        steps, not one compiled program; it pumps the host refresh only at
        entry, as the JAX package's scan does.
        """
        state = self._drive_async(state, None)
        state = self._drive_offload(state, None)
        losses = []
        for i in range(_leading(batches)):
            state, loss = self._step(state, _index(batches, i))
            losses.append(loss)
        self._drive_checkpoints(state)
        return state, torch.stack(losses)

    # --------------------------------------------------------- accumulation

    def accumulate_microbatch(self, state: TrainState, microbatch) -> torch.Tensor:
        """Accumulate one micro-batch's gradients and statistics without
        stepping; finish with :meth:`apply_accumulated` or discard with
        :meth:`reset_batch`. Returns this micro-batch's loss."""
        if self.kfac is None:
            raise ValueError('accumulation requires a kfac preconditioner')
        self._sync_step_count(state)
        acc = self._accum
        if acc is None:
            acc = self._accum = {
                'grads': None, 'stats': None, 'loss': 0.0, 'count': 0,
                'model_state': state.model_state,
                'capture': self._capture_now(),
            }
        microbatch = self._local(microbatch)
        if acc['capture']:
            (loss, model_state), grads, stats = self._run_stats(acc['model_state'], microbatch)
            acc['stats'] = capture_lib.accumulate_stats(acc['stats'], stats)
        else:
            (loss, model_state), grads = self._run_plain(acc['model_state'], microbatch)
        acc['model_state'] = model_state
        acc['loss'] = acc['loss'] + loss
        acc['grads'] = (
            grads if acc['grads'] is None
            else {n: g + grads[n] for n, g in acc['grads'].items()}
        )
        acc['count'] += 1
        return loss

    def reset_batch(self) -> None:
        """Discard the pending micro-batch accumulation; the step counter
        and the factors are untouched."""
        self._accum = None

    def apply_accumulated(self, state: TrainState) -> tuple[TrainState, torch.Tensor]:
        """Finish an incremental accumulation: average the gradients,
        statistics and loss over the micro-batches, precondition, step."""
        acc = self._accum
        if acc is None or acc['count'] == 0:
            raise ValueError('no pending accumulation: call accumulate_microbatch first')
        n = acc['count']
        grads = {k: g / n for k, g in acc['grads'].items()}
        stats = capture_lib.average_stats(acc['stats'], n) if acc['capture'] else None
        loss = acc['loss'] / n
        grads, loss = self._reduce(grads, loss)
        state = self._drive_async(state, self._step_count)
        state = self._drive_offload(state, self._step_count)
        new_state = self._finish_step(state, grads, stats, acc['model_state'], loss)
        self._accum = None
        self._step_count += 1
        self._maybe_warn(new_state)
        self._drive_checkpoints(new_state)
        return new_state, loss

    def _step_accumulate(self, state: TrainState, microbatches) -> tuple[TrainState, torch.Tensor]:
        if self.kfac is None:
            raise ValueError('step_accumulate requires a kfac preconditioner')
        if self._accum is not None:
            raise ValueError(
                'an incremental accumulation is pending: finish it with '
                'apply_accumulated or drop it with reset_batch before step_accumulate'
            )
        for mb in microbatches:
            self.accumulate_microbatch(state, mb)
        return self.apply_accumulated(state)

    @tracing.trace(name='trainer/step_accumulate')
    def step_accumulate(self, state: TrainState, microbatches) -> tuple[TrainState, torch.Tensor]:
        """One optimization step over several micro-batches: gradients and
        curvature statistics are averaged before the preconditioner step.
        Off the factor cadence the micro-batches run without capture."""
        return self._step_accumulate(state, microbatches)

    @tracing.trace(name='trainer/step_accumulate_scan')
    def step_accumulate_scan(self, state: TrainState, microbatches) -> tuple[TrainState, torch.Tensor]:
        """:meth:`step_accumulate` over the leading axis of
        ``microbatches``. A host loop, not one compiled program as in the
        JAX package."""
        return self._step_accumulate(
            state, [_index(microbatches, i) for i in range(_leading(microbatches))]
        )
