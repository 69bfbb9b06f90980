"""Flight recorder: a rolling telemetry history on the device, and
postmortem bundles (counterpart of
``kfac_tpu/observability/flight_recorder.py``).

- :class:`FlightRecorderState`: a ring of ``capacity`` rows on the device,
  carried next to the metrics in the engine state. Each engine step writes
  row ``step % capacity``: the packed metric scalars, the training loss
  (when the Trainer passes one) and the global gradient norm. The step is a
  host integer, so the slot is known on the host and a row costs no sync.
  Unlike the JAX package's functional ``.at[].set``, the row is written in
  place: the ring is the engine's own buffer.
- :func:`drain_flight`: the ring's records, oldest first, in one copy from
  the device, with cross-process ``skew_*`` columns of a few headline keys
  (through :mod:`kfac_tpu_torch.parallel.multihost`: a collective, so
  every rank of a distributed run drains; with one process they equal the
  local value).
- :class:`PostmortemWriter`: a drain-time sink that writes a bundle
  directory when the health counters or the latest record show an event,
  in the JAX package's layout, which ``tools/kfac_inspect.py`` reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from kfac_tpu_torch.observability import metrics as metrics_lib
from kfac_tpu_torch.parallel import multihost

#: headline scalars that get cross-process skew columns on drain
DEFAULT_SKEW_KEYS = ('loss', 'grad_norm', 'kl_clip_scale')

#: bundle format version stamped into MANIFEST.json
BUNDLE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class FlightRecorderConfig:
    """``capacity``: ring rows, the last ``capacity`` engine steps kept
    (``capacity * (n_keys + 4) * 4`` bytes). ``skew_keys``: record keys
    that get ``skew_min/max/mean`` columns on drain. Pass as
    ``KFACPreconditioner(flight=...)``, ``flight=True`` for the defaults or
    ``flight=<int>`` for a capacity; it turns ``metrics`` on."""

    capacity: int = 64
    skew_keys: tuple[str, ...] = DEFAULT_SKEW_KEYS

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(
                f'flight recorder capacity must be >= 1, got {self.capacity}'
            )
        object.__setattr__(self, 'skew_keys', tuple(self.skew_keys))


@dataclasses.dataclass(frozen=True)
class FlightRecorderState:
    """The ring, five device buffers: ``steps`` (N,) int32, the engine step
    of each row (-1: never written; a skipped step leaves no row);
    ``scalars`` (N, n_keys) f32 in ``keys`` order; ``loss`` (N,) f32 with
    ``loss_valid`` (N,) bool (False where the step had no loss);
    ``grad_norm`` (N,) f32, the global L2 norm of the raw gradients."""

    keys: tuple[str, ...]
    steps: torch.Tensor
    loss: torch.Tensor
    loss_valid: torch.Tensor
    grad_norm: torch.Tensor
    scalars: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.steps.shape[0])


def init_flight(
    config: FlightRecorderConfig,
    keys: Sequence[str],
    device: str | torch.device = 'cuda',
) -> FlightRecorderState:
    """An empty ring for the scalar key schema ``keys``, on ``device``."""
    n = int(config.capacity)
    keys = tuple(keys)
    f32 = torch.float32
    return FlightRecorderState(
        keys=keys,
        steps=torch.full((n,), -1, dtype=torch.int32, device=device),
        loss=torch.zeros((n,), dtype=f32, device=device),
        loss_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        grad_norm=torch.zeros((n,), dtype=f32, device=device),
        scalars=torch.zeros((n, len(keys)), dtype=f32, device=device),
    )


def global_grad_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm, f32, of every floating tensor in ``grads`` (a dict
    or a list): one grouped ``_foreach_norm``, then the norm of the norms."""
    leaves = list(grads.values()) if isinstance(grads, dict) else list(grads)
    leaves = [x.float() for x in leaves if x.dtype.is_floating_point]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def record(
    flight: FlightRecorderState,
    step: int,
    scalars: torch.Tensor,
    loss: torch.Tensor | None = None,
    grad_norm: torch.Tensor | None = None,
) -> FlightRecorderState:
    """Write row ``step % capacity`` in place and return the ring.
    ``loss=None`` marks the row's loss invalid. Host values go in by
    ``fill_`` (an item assignment of a Python number to a CUDA tensor would
    copy it from the host and wait)."""
    i = step % flight.capacity
    flight.steps[i].fill_(step)
    flight.scalars[i].copy_(scalars)
    if loss is None:
        flight.loss[i].fill_(0.0)
    else:
        flight.loss[i].copy_(loss.detach())
    flight.loss_valid[i].fill_(loss is not None)
    if grad_norm is None:
        flight.grad_norm[i].fill_(0.0)
    else:
        flight.grad_norm[i].copy_(grad_norm)
    return flight


# ------------------------------------------------------------------- drain


def _pull(flight: FlightRecorderState) -> dict[str, np.ndarray]:
    """The whole ring on the host, in one copy from the device (f64 holds
    every int32 step and every f32 value exactly)."""
    packed = torch.cat([
        flight.steps.double()[:, None],
        flight.loss.double()[:, None],
        flight.loss_valid.double()[:, None],
        flight.grad_norm.double()[:, None],
        flight.scalars.double(),
    ], dim=1).cpu().numpy()
    return {
        'steps': packed[:, 0].astype(np.int32),
        'loss': packed[:, 1].astype(np.float32),
        'loss_valid': packed[:, 2].astype(bool),
        'grad_norm': packed[:, 3].astype(np.float32),
        'scalars': packed[:, 4:].astype(np.float32),
    }


def drain_flight(
    state: Any,
    skew_keys: Sequence[str] | None = DEFAULT_SKEW_KEYS,
) -> list[dict[str, Any]]:
    """The ring as chronological records, oldest first: ``{'step',
    'process_index', 'grad_norm', ['loss'], <metric keys...>}`` and, for
    each of ``skew_keys``, ``skew_min/<k>``, ``skew_max/<k>`` and
    ``skew_mean/<k>`` across processes. Takes an engine state, a
    ``TrainState`` or a bare ring; ``[]`` when the recorder is off."""
    flight = state if isinstance(state, FlightRecorderState) else getattr(
        getattr(state, 'kfac_state', state), 'flight', None)
    if flight is None:
        return []
    pulled = _pull(flight)
    steps = pulled['steps']
    valid = np.flatnonzero(steps >= 0)
    order = valid[np.argsort(steps[valid], kind='stable')]
    records: list[dict[str, Any]] = []
    pidx = multihost.process_index()
    for i in order:
        rec: dict[str, Any] = {
            'step': int(steps[i]),
            'process_index': pidx,
            'grad_norm': float(pulled['grad_norm'][i]),
        }
        if bool(pulled['loss_valid'][i]):
            rec['loss'] = float(pulled['loss'][i])
        rec.update({
            k: float(v) for k, v in zip(flight.keys, pulled['scalars'][i])
        })
        records.append(rec)
    if records and skew_keys:
        _add_skew_columns(records, tuple(skew_keys))
    return records


def _add_skew_columns(
    records: list[dict[str, Any]], skew_keys: tuple[str, ...]
) -> None:
    """Cross-process min, max and mean of the headline scalars, one gather
    for the whole drain."""
    mat = np.full((len(records), len(skew_keys)), np.nan, np.float32)
    for i, rec in enumerate(records):
        for j, k in enumerate(skew_keys):
            if k in rec:
                mat[i, j] = rec[k]
    gathered = multihost.allgather_scalars(mat)  # (P, R, S)
    for i, rec in enumerate(records):
        for j, k in enumerate(skew_keys):
            if k not in rec:
                continue
            col = gathered[:, i, j]
            rec[f'skew_min/{k}'] = float(np.min(col))
            rec[f'skew_max/{k}'] = float(np.max(col))
            rec[f'skew_mean/{k}'] = float(np.mean(col))


def skew_ratio(record: dict[str, Any], key: str) -> float:
    """``(skew_max - skew_min) / (|skew_mean| + 1e-12)`` of a drained
    record's ``key``; 0.0 where the record has no skew columns for it."""
    lo = record.get(f'skew_min/{key}')
    hi = record.get(f'skew_max/{key}')
    mean = record.get(f'skew_mean/{key}')
    if lo is None or hi is None or mean is None:
        return 0.0
    return float((hi - lo) / (abs(mean) + 1e-12))


# -------------------------------------------------------------- fingerprint


def fingerprint(engine: Any = None) -> dict[str, Any]:
    """Library versions and device topology, for offline triage; with a
    distributed engine, its grid's axes and shape too."""
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    info = {
        'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'numpy': np.__version__,
        'backend': 'cuda' if cuda else 'cpu',
        'device_count': count,
        'device_kinds': sorted({torch.cuda.get_device_name(i) for i in range(count)}),
        'process_count': multihost.process_count(),
        'process_index': multihost.process_index(),
    }
    mesh = getattr(engine, 'mesh', None)
    if mesh is not None:
        info['mesh'] = {
            'axis_names': ['kfac_gw', 'kfac_col'],
            'shape': [mesh.grad_workers, mesh.n_cols],
        }
    return info


def _config_snapshot(cfg: Any) -> dict[str, Any]:
    """JSON view of a config dataclass: the registry summarized, nested
    dataclasses expanded, other objects as strings."""
    if not dataclasses.is_dataclass(cfg):
        return {'repr': repr(cfg)}
    out: dict[str, Any] = {}
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name, None)
        if field.name == 'registry':
            layers = getattr(value, 'layers', {})
            out['registry'] = {'n_layers': len(layers), 'layers': list(layers)}
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            out[field.name] = dataclasses.asdict(value)
        elif isinstance(value, (bool, int, float, str, type(None))):
            out[field.name] = value
        elif isinstance(value, (tuple, list)) and all(
            isinstance(v, (bool, int, float, str, type(None))) for v in value
        ):
            out[field.name] = list(value)
        else:
            out[field.name] = str(value)
    return out


def _np_gershgorin(mat: np.ndarray) -> tuple[float, float]:
    """Host-side Gershgorin bounds (of :func:`metrics.gershgorin_bounds`)."""
    f = np.asarray(mat, np.float64)
    absrow = np.sum(np.abs(f), axis=-1)
    diag = np.diagonal(f, axis1=-2, axis2=-1)
    return float(np.min(diag - (absrow - np.abs(diag)))), float(np.max(absrow))


def _json_dump(path: str, obj: Any) -> None:
    with open(path, 'w') as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
        f.write('\n')


# ---------------------------------------------------------------- postmortem


class PostmortemWriter:
    """Drain-time sink: a health event or a non-finite record writes a
    bundle directory::

        pm = PostmortemWriter('postmortems/', engine=kfac)
        rec = collector.drain(state)
        bundle = pm.observe(state, rec)   # None, or the new bundle's path

    Triggers, each once per event: ``skip`` (``health/skipped_steps``
    advanced), ``quarantine`` (cumulative quarantine events advanced),
    ``degrade`` (a layer newly crossed ``degrade_after``), ``nonfinite``
    (the ring's latest record or the drained record holds a non-finite
    value, once per step).

    A bundle holds ``history.npz`` and ``history.jsonl`` (the ring),
    ``factors.json`` (per-layer Gershgorin bounds, norms, staleness),
    ``health.json``, ``describe.txt``, ``config.json``,
    ``fingerprint.json``, ``comms.json`` (a distributed engine's
    ``comms_report()``) and ``MANIFEST.json``. With a
    ``checkpoint_manager`` (a :class:`kfac_tpu_torch.resilience.
    CheckpointManager`), a degrade event first flushes one emergency
    checkpoint of the observed state, and ``MANIFEST.json`` records its
    path as ``emergency_checkpoint`` (else None). Only process 0 writes
    unless ``all_processes``. With a
    :class:`~kfac_tpu_torch.parallel.DistributedKFAC` every rank calls
    :meth:`observe` (and :meth:`write_bundle`): the drain and the factors
    are gathered, and every rank enters the emergency save.
    """

    def __init__(
        self,
        root: str | os.PathLike[str],
        engine: Any,
        collector: metrics_lib.MetricsCollector | None = None,
        max_bundles: int = 16,
        all_processes: bool = False,
        run_id: str | None = None,
        checkpoint_manager: Any = None,
    ) -> None:
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.engine = engine
        self.collector = collector or metrics_lib.MetricsCollector()
        self.max_bundles = int(max_bundles)
        self.all_processes = bool(all_processes)
        self.run_id = run_id
        self.checkpoint_manager = checkpoint_manager
        self.bundles: list[str] = []
        self._seen_skipped = 0
        self._seen_events = 0
        self._seen_degraded: set[str] = set()
        self._last_nonfinite_step: int | None = None

    # ------------------------------------------------------------- helpers

    def _config(self) -> Any:
        return getattr(self.engine, 'config', self.engine)

    def _skew_keys(self) -> tuple[str, ...]:
        fc = getattr(self._config(), 'flight', None)
        if isinstance(fc, FlightRecorderConfig):
            return fc.skew_keys
        return DEFAULT_SKEW_KEYS

    @staticmethod
    def _health_events(record: dict[str, Any]) -> tuple[int, int]:
        skipped = int(record.get('health/skipped_steps', 0))
        events = sum(
            int(v) for k, v in record.items()
            if k.startswith('health/') and k.endswith('/quarantine_events')
        )
        return skipped, events

    def _degraded_layers(self, record: dict[str, Any]) -> set[str]:
        hc = getattr(self._config(), 'health', None)
        if hc is None:
            return set()
        out = set()
        for k, v in record.items():
            if k.startswith('health/') and k.endswith('/bad_inv'):
                if int(v) >= hc.degrade_after:
                    out.add(k[len('health/'):-len('/bad_inv')])
        return out

    @staticmethod
    def _nonfinite(record: dict[str, Any]) -> bool:
        return any(
            isinstance(v, float) and not np.isfinite(v)
            for k, v in record.items() if k != 'process_index'
        )

    # ------------------------------------------------------------- observe

    def observe(
        self, state: Any, record: dict[str, Any] | None = None
    ) -> str | None:
        """Write a bundle if the counters or the ring show a new event;
        returns its path or None. ``record``: a collector drain the caller
        already made (else the writer drains)."""
        from kfac_tpu_torch import tracing

        kstate = getattr(state, 'kfac_state', state)
        if record is None:
            record = self.collector.drain(kstate)
        if 'health/skipped_steps' not in record:
            record = dict(record)
            record.update(tracing.health_counters(kstate))

        reasons: list[str] = []
        skipped, events = self._health_events(record)
        if skipped > self._seen_skipped:
            reasons.append('skip')
        if events > self._seen_events:
            reasons.append('quarantine')
        degraded = self._degraded_layers(record)
        if degraded - self._seen_degraded:
            reasons.append('degrade')
        self._seen_skipped = max(self._seen_skipped, skipped)
        self._seen_events = max(self._seen_events, events)
        self._seen_degraded |= degraded

        history = drain_flight(kstate, skew_keys=self._skew_keys())
        latest = history[-1] if history else None
        step = int(record.get('step', latest['step'] if latest else -1))
        if (latest is not None and self._nonfinite(latest)) or self._nonfinite(record):
            if step != self._last_nonfinite_step:
                reasons.append('nonfinite')
                self._last_nonfinite_step = step
        if not reasons:
            return None
        emergency_ckpt = None
        if 'degrade' in reasons and self.checkpoint_manager is not None:
            # every process enters the blocking save, once per degrade event
            # (the trigger above dedupes against _seen_degraded)
            emergency_ckpt = self.checkpoint_manager.save_emergency(state, reason='degrade')
        # the factors of a distributed state are gathered: every rank
        factors = self._factor_summaries(kstate, record)
        if not self.all_processes and multihost.process_index() != 0:
            return None
        if len(self.bundles) >= self.max_bundles:
            return None
        return self.write_bundle(
            kstate, '-'.join(reasons), record=record, history=history, step=step,
            emergency_checkpoint=emergency_ckpt, factors=factors,
        )

    # ---------------------------------------------------------- the bundle

    def write_bundle(
        self,
        state: Any,
        reason: str,
        record: dict[str, Any] | None = None,
        history: list[dict[str, Any]] | None = None,
        step: int | None = None,
        emergency_checkpoint: str | None = None,
        factors: dict[str, Any] | None = None,
    ) -> str:
        """Write one bundle directory now; returns its path. ``factors``:
        the per-layer summaries, when the caller has them."""
        kstate = getattr(state, 'kfac_state', state)
        if record is None:
            record = self.collector.drain(kstate)
        if history is None:
            history = drain_flight(kstate, skew_keys=self._skew_keys())
        if step is None:
            step = int(record.get('step', history[-1]['step'] if history else -1))

        tag = f'-p{multihost.process_index()}' if self.all_processes else ''
        base = f'postmortem-step{max(step, 0):08d}-{reason}{tag}'
        bdir = os.path.join(self.root, base)
        n = 2
        while os.path.exists(bdir):
            bdir = os.path.join(self.root, f'{base}-{n}')
            n += 1
        os.makedirs(bdir)
        files: list[str] = []

        flight = getattr(kstate, 'flight', None)
        if flight is not None:
            np.savez(
                os.path.join(bdir, 'history.npz'),
                keys=np.asarray(flight.keys), **_pull(flight),
            )
            files.append('history.npz')
        if history:
            with open(os.path.join(bdir, 'history.jsonl'), 'w') as f:
                for rec in history:
                    f.write(json.dumps(rec, sort_keys=True) + '\n')
            files.append('history.jsonl')

        if factors is None:
            factors = self._factor_summaries(kstate, record)
        _json_dump(os.path.join(bdir, 'factors.json'), factors)
        files.append('factors.json')
        _json_dump(os.path.join(bdir, 'health.json'),
                   self._health_snapshot(kstate, record))
        files.append('health.json')
        describe = getattr(self.engine, 'describe', None)
        if callable(describe):
            with open(os.path.join(bdir, 'describe.txt'), 'w') as f:
                f.write(describe() + '\n')
            files.append('describe.txt')
        comms_report = getattr(self.engine, 'comms_report', None)
        if callable(comms_report):
            _json_dump(os.path.join(bdir, 'comms.json'), comms_report())
            files.append('comms.json')
        _json_dump(os.path.join(bdir, 'config.json'), _config_snapshot(self._config()))
        files.append('config.json')
        _json_dump(os.path.join(bdir, 'fingerprint.json'), fingerprint(self.engine))
        files.append('fingerprint.json')

        _json_dump(os.path.join(bdir, 'MANIFEST.json'), {
            'schema': BUNDLE_SCHEMA,
            'run_id': self.run_id,
            'reason': reason,
            'step': step,
            'process_index': multihost.process_index(),
            'record': record,
            'files': sorted(files),
            'emergency_checkpoint': emergency_checkpoint,
        })
        self.bundles.append(bdir)
        return bdir

    def _factor_summaries(
        self, kstate: Any, record: dict[str, Any]
    ) -> dict[str, Any]:
        """Per-layer triage data: bounds, norms, staleness, health."""
        extract = getattr(self.engine, 'extract_factors', None)
        if not callable(extract):
            return {}
        out: dict[str, Any] = {}
        for name, fg in extract(kstate).items():
            entry: dict[str, Any] = {}
            for side in ('a', 'g'):
                mat = fg[side].detach().cpu().double().numpy()
                lmin, lmax = _np_gershgorin(mat)
                entry[side] = {
                    'dim': int(mat.shape[-1]),
                    'gershgorin_lmin': lmin,
                    'gershgorin_lmax': lmax,
                    'fro_norm': float(np.linalg.norm(mat)),
                    'finite': bool(np.isfinite(mat).all()),
                }
            for key in ('factor_staleness', 'inv_staleness'):
                if f'{key}/{name}' in record:
                    entry[key] = record[f'{key}/{name}']
            for key in ('damping_mult', 'quarantine_events', 'bad_inv'):
                if f'health/{name}/{key}' in record:
                    entry[key] = record[f'health/{name}/{key}']
            out[name] = entry
        return out

    def _health_snapshot(
        self, kstate: Any, record: dict[str, Any]
    ) -> dict[str, Any]:
        hc = getattr(self._config(), 'health', None)
        health = getattr(kstate, 'health', None)
        if hc is None or health is None:
            return {
                'enabled': False,
                'counters': {k: v for k, v in record.items() if k.startswith('health/')},
            }
        from kfac_tpu_torch import health as health_lib

        snap = health_lib.summary(hc, health)
        snap['enabled'] = True
        return snap
