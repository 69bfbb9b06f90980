"""Checkpoint and resume of the K-FAC state (counterpart of
``kfac_tpu/checkpoint.py``, dense engine).

As in the JAX package, only the step counter, the factors A and G and, with
the health sentinel on, its counters are durable; the decompositions are
derived state, recomputed on load by ``engine.rematerialize``.

The on-disk format is the port's own (the JAX package writes orbax):

- :func:`save` writes a directory holding ``state.pt``, a ``torch.save`` of
  CPU tensors and plain Python values read back with
  ``torch.load(..., weights_only=True)``, and the commit marker
  ``COMMITTED``, written last. The directory is written as a temporary
  sibling, fsynced, and renamed onto ``path``, so a torn write never looks
  committed.
- :func:`save_factors` writes one ``.npz`` of layer-named true-dim factors
  (``factors/<layer>/a``, ``factors/<layer>/g``) and ``step``, which any
  numpy reads.

Both carry the JAX package's JSON layout-manifest sidecar,
``<path>.manifest.json``, written only once the checkpoint is durable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import uuid
import warnings as _warnings
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from kfac_tpu_torch import health as health_lib
from kfac_tpu_torch.parallel import multihost
from kfac_tpu_torch.warnings import CheckpointResilienceWarning

PAYLOAD = 'state.pt'
COMMIT_MARKER = 'COMMITTED'
_FORMAT = 1
_HEALTH_FIELDS = ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')


def layout_manifest(engine: Any) -> dict[str, Any]:
    """JSON description of an engine's durable-state layout, with the JAX
    package's keys: ``format``, ``engine``, ``compute_method`` and, for
    information only, ``topology``. The dense engine has no stacked stores,
    so its layout is its class name."""
    man: dict[str, Any] = {'format': 1, 'engine': type(engine).__name__}
    cfg = getattr(engine, 'config', engine)
    cm = getattr(cfg, 'compute_method', None)
    man['compute_method'] = getattr(cm, 'name', str(cm))
    topo = getattr(engine, 'topology', None)
    if callable(topo):
        man['topology'] = topo()
    return man


# Manifest keys that determine the shape and keying of the durable payload
# (the JAX package's list; compute_method is not one: only step, a, g and
# the health counters are durable).
_LAYOUT_KEYS = (
    'engine', 'bucket_granularity', 'colocate_factors', 'a_store',
    'g_store', 'n_stages',
)


def _layout_view(man: dict[str, Any]) -> dict[str, Any]:
    return {k: man[k] for k in _LAYOUT_KEYS if k in man}


def _manifest_path(path: str) -> str:
    """The layout manifest sidecar's path."""
    return os.path.abspath(path) + '.manifest.json'


def _local(path: Any) -> str:
    p = os.fspath(path)
    if '://' in p:
        raise ValueError(
            f'checkpoint path {p!r} is a remote URI: kfac_tpu_torch writes '
            'checkpoints as local files only'
        )
    return p


def is_committed(path: str) -> bool:
    """Whether ``path`` is a :func:`save` directory whose commit marker
    landed."""
    return os.path.isfile(os.path.join(path, COMMIT_MARKER))


# ---------------------------------------------------------------- payload


def durable_state(state: Any) -> dict[str, Any]:
    """The persistent slice of a K-FAC state: ``step`` (an int), ``a`` and
    ``g`` (layer-keyed tensors) and, when the sentinel is on, ``health``:
    its counters with the layer ``names`` they are ordered by."""
    out: dict[str, Any] = {'step': int(state.step), 'a': dict(state.a), 'g': dict(state.g)}
    health = getattr(state, 'health', None)
    if health is not None:
        out['health'] = {
            'names': list(health.names), 'skipped_steps': health.skipped_steps,
            **{f: getattr(health, f) for f in _HEALTH_FIELDS},
        }
    return out


def _health_from_saved(saved: dict[str, Any], template: health_lib.HealthState) -> health_lib.HealthState:
    """The saved counters as a :class:`~kfac_tpu_torch.health.HealthState`
    on the template's device, in its layer order. ``saved`` is the port's
    form (``names`` and (L,) vectors) or the JAX package's (a dict per
    field keyed by layer)."""
    names = list(template.names)
    dev = template.damping_mult.device

    def vector(field, dtype):
        value = saved[field]
        if isinstance(value, dict):  # the JAX package's per-layer dict
            order = list(value)
            value = torch.from_numpy(np.array([np.asarray(v) for v in value.values()]))
        else:
            order, value = list(saved['names']), torch.as_tensor(value)
        if sorted(order) != sorted(names):
            raise ValueError(
                f'saved health counters name layers {sorted(order)}, the engine '
                f'registers {sorted(names)}'
            )
        return value[[order.index(n) for n in names]].to(dev, dtype)

    return dataclasses.replace(
        template,
        skipped_steps=torch.as_tensor(np.array(saved['skipped_steps'])).to(dev, torch.int32),
        damping_mult=vector('damping_mult', torch.float32),
        **{f: vector(f, torch.int32) for f in _HEALTH_FIELDS[1:]},
    )


def _with_durable(engine: Any, state: Any, loaded: dict[str, Any]) -> Any:
    """``state`` with the loaded step and factors and, where both the
    engine and the checkpoint have them, the health counters.

    The counterpart of the JAX package's ``_retry_health_mismatch``:
    toggling the sentinel between save and restore is configuration, not
    a layout change. Counters saved without a sentinel in the engine are
    dropped; an engine with a sentinel restoring a checkpoint without
    counters keeps ``init()``'s fresh ones.
    """
    factors = {n: {'a': loaded['a'][n], 'g': loaded['g'][n]} for n in loaded['a']}
    state = engine.insert_factors(state, factors)
    state = dataclasses.replace(state, step=int(np.asarray(loaded['step'])))
    if 'health' in loaded and getattr(state, 'health', None) is not None:
        state = dataclasses.replace(
            state, health=_health_from_saved(loaded['health'], state.health)
        )
    return state


def _validate_restored_factors(path: str, engine: Any, loaded: dict[str, Any]) -> None:
    """Reject a corrupt or mismatched checkpoint with a layer-named error:
    another layer set, a non-finite factor, or a factor of another shape
    than the engine's layer (the model changed between save and restore).
    Runs on the loaded (host) tensors, before anything reaches the device."""
    reg = engine.registry
    saved = set(loaded['a']) | set(loaded['g'])
    if saved != set(reg.layers):
        raise ValueError(
            f'checkpoint at {path!r} stores factors for layers {sorted(saved)} '
            f'but the restoring engine registers {sorted(reg.layers)}; the '
            'layer sets must be identical.'
        )
    for name, helper in reg.layers.items():
        for side, exp in (('a', helper.a_factor_shape), ('g', helper.g_factor_shape)):
            arr = torch.as_tensor(loaded[side][name])
            finite = torch.isfinite(arr)
            if not bool(finite.all()):
                bad = int(arr.numel() - int(finite.sum()))
                raise ValueError(
                    f'checkpoint at {path!r}: restored {side.upper()} factor for '
                    f'layer {name!r} contains {bad} non-finite values — the '
                    'checkpoint is corrupt (saved from a diverged run?); restore '
                    'a different one or reinitialize the preconditioner state.'
                )
            if tuple(arr.shape) != tuple(exp):
                raise ValueError(
                    f'checkpoint at {path!r}: restored {side.upper()} factor for '
                    f'layer {name!r} has shape {tuple(arr.shape)} but the engine '
                    f'expects {tuple(exp)} — the model architecture changed '
                    'between save and restore.'
                )


def from_durable(engine: Any, loaded: dict[str, Any], path: str) -> Any:
    """A rematerialized engine state from a durable dict (``step``, ``a``,
    ``g``, maybe ``health``; tensors or arrays): validated, inserted into
    ``engine.init()``, decompositions recomputed. The loaded health
    counters are kept over the ones ``rematerialize`` ticks, as the JAX
    package's restore keeps them: they are the durable truth of the run."""
    _validate_restored_factors(path, engine, loaded)
    state = _with_durable(engine, engine.init(), loaded)
    loaded_health = state.health
    state = engine.rematerialize(state)
    if loaded_health is not None:
        state = dataclasses.replace(state, health=loaded_health)
    return state


# ------------------------------------------------------------------- save


_ALIGN = 64


def snapshot(tree: Any) -> tuple[Any, torch.cuda.Event | None]:
    """A host copy of every tensor in ``tree`` (dicts, lists, tuples), taken
    as of now, and the CUDA event that marks its completion (None when no
    tensor is on a card).

    A card's tensors are copied into one pinned buffer by copies enqueued
    on the current stream, so whatever the caller enqueues next (the
    optimizer's in-place update, say) runs after them: the snapshot holds
    the values as they were at this call, with no host sync. Host tensors
    are cloned at once.
    """
    offsets, total = {}, 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda and id(t) not in offsets:
            offsets[id(t)] = total
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True) if total else None
    copies: dict[int, torch.Tensor] = {}

    def copy(t: torch.Tensor) -> torch.Tensor:
        if id(t) not in copies:
            if t.is_cuda:
                off, n = offsets[id(t)], t.numel() * t.element_size()
                dst = buf[off:off + n].view(t.dtype).view(t.shape)
                dst.copy_(t.detach(), non_blocking=True)
            else:
                dst = t.detach().clone()
            copies[id(t)] = dst
        return copies[id(t)]

    out = pytree.tree_map_only(torch.Tensor, copy, tree)
    event = None
    if buf is not None:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_committed(path: str, payload: Any) -> None:
    """Write ``payload`` as a committed :func:`save` directory at ``path``:
    a temporary sibling, fsynced, its marker last, renamed into place (an
    existing ``path`` is moved aside first and removed after)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tag = f'{os.getpid()}-{uuid.uuid4().hex[:8]}'
    tmp = f'{path}.tmp-{tag}'
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, PAYLOAD), 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
            nbytes = f.tell()
        with open(os.path.join(tmp, COMMIT_MARKER), 'w') as f:
            json.dump({'format': _FORMAT, 'payload': PAYLOAD, 'bytes': nbytes}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        old = None
        if os.path.exists(path):  # overwrite=True, checked by save
            old = f'{path}.old-{tag}'
            os.replace(path, old)
        os.replace(tmp, path)
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_json(path: str, obj: Any) -> None:
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _Writer(threading.Thread):
    """Writes one snapshot after its copies finish; keeps any error for the
    handle to raise."""

    def __init__(self, path: str, payload: Any, ready: torch.cuda.Event | None) -> None:
        super().__init__(name='kfac-checkpoint-writer')
        self.path, self.payload, self.ready = path, payload, ready
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            if self.ready is not None:
                self.ready.synchronize()
            _write_committed(self.path, self.payload)
        except BaseException as exc:  # raised by the handle's wait
            self.error = exc


class _AsyncSaveHandle:
    """Returned by :func:`save`: ``wait_until_finished()`` joins the writer,
    raises its error, and then writes the manifest sidecar, so a manifest
    on disk implies a durable checkpoint. After an error, the next wait
    writes the same snapshot again (a caller's retry).

    Usable as a context manager (``with save(..., wait=False):`` waits on
    exit). Dropping the handle without waiting warns: the write may still
    commit, but its manifest is never written.
    """

    def __init__(self, writer: _Writer, finalize) -> None:
        self._writer = writer
        self._finalize = finalize
        self._done = False
        self._failed = False

    def done(self) -> bool:
        """Whether the write has ended (no wait, no device sync)."""
        return not self._writer.is_alive()

    def wait_until_finished(self) -> None:
        if self._done:
            return
        if self._failed:
            w = self._writer
            self._writer = _Writer(w.path, w.payload, None)
            self._writer.start()
            self._failed = False
        self._writer.join()
        if self._writer.error is not None:
            self._failed = True
            raise self._writer.error
        self._done = True
        self._finalize()

    def __enter__(self) -> '_AsyncSaveHandle':
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.wait_until_finished()

    def __del__(self) -> None:
        if getattr(self, '_done', True):
            return
        try:  # pragma: no cover - interpreter-shutdown ordering
            _warnings.warn(
                'async checkpoint save handle dropped without '
                'wait_until_finished(): the checkpoint may commit in the '
                'background but its layout manifest is never written; hold the '
                'handle and wait on it, or use it as a context manager',
                ResourceWarning,
                stacklevel=2,
            )
        except Exception:
            pass


def save(
    path: str,
    state: Any,
    extra: dict[str, Any] | None = None,
    engine: Any | None = None,
    wait: bool = True,
    overwrite: bool = False,
) -> _AsyncSaveHandle:
    """Write the durable K-FAC state, and ``extra`` (for example a model's
    and an optimizer's ``state_dict()``), to the directory ``path``.

    Pass ``engine`` to also write the layout manifest sidecar
    (``<path>.manifest.json``), once the checkpoint is durable.

    ``wait=False`` returns once the snapshot is enqueued (device-to-host
    copies into pinned memory on the current stream, a CUDA event behind
    them); a thread writes it. Training can go on at once: the copies
    precede anything enqueued after this call, in-place updates included.
    Call the handle's ``wait_until_finished()`` before relying on the
    files. ``wait=True`` returns a finished handle.

    ``overwrite`` is the policy for an existing ``path``: the default
    refuses up front; ``overwrite=True`` replaces it. A stale sidecar is
    removed before the write, so a manifest on disk describes only this
    save. Rotations should prefer fresh step-numbered directories
    (:class:`kfac_tpu_torch.resilience.CheckpointManager`).
    """
    path = _local(path)
    if not overwrite and os.path.exists(path):
        raise ValueError(
            f'checkpoint path {path!r} already exists; pass '
            'overwrite=True to replace it, or save each step to a fresh '
            'step-numbered directory (kfac_tpu_torch.resilience.CheckpointManager '
            'manages such a rotation with an atomic LATEST pointer)'
        )
    payload = {'kfac': durable_state(state)}
    if extra:
        if 'kfac' in extra:
            raise ValueError("'kfac' is the K-FAC state's key; name the extra otherwise")
        payload.update(extra)
    host_payload, ready = snapshot(payload)
    mpath = _manifest_path(path)
    if multihost.process_index() == 0 and os.path.exists(mpath):
        os.remove(mpath)

    def finalize_manifest() -> None:
        if engine is not None and multihost.process_index() == 0:
            _write_json(mpath, layout_manifest(engine))

    writer = _Writer(path, host_payload, ready)
    writer.start()
    handle = _AsyncSaveHandle(writer, finalize_manifest)
    if wait:
        handle.wait_until_finished()
    return handle


# ---------------------------------------------------------------- restore


def _read_manifest(path: str) -> dict[str, Any] | None:
    mpath = _manifest_path(path)
    if os.path.exists(mpath):
        with open(mpath) as f:
            return json.load(f)
    _warnings.warn(
        f'checkpoint at {path!r} has no layout-manifest sidecar (saved '
        'without engine=, or the writer died between the commit and the '
        'manifest): restoring manifest-less',
        CheckpointResilienceWarning,
        stacklevel=3,
    )
    return None


def restore(
    path: str,
    engine: Any,
    extra_template: dict[str, Any] | None = None,
) -> tuple[Any, dict[str, Any]]:
    """Load a :func:`save` directory into a fresh ``engine.init()`` state
    and recompute its decompositions with ``engine.rematerialize``.
    Returns ``(state, extra)``; the extras are host tensors and values as
    saved.

    ``extra_template``: its keys name the extras the caller needs; a
    checkpoint without one of them is rejected, and only those are
    returned (the payload carries its own structure, so the values are not
    read).

    A manifest whose layout differs from the engine's raises
    ``ValueError``: the JAX package's cross-layout migration waits for the
    port's distributed engine. A checkpoint without the commit marker, or
    with a corrupt payload, raises as well.
    """
    path = _local(path)
    if not is_committed(path):
        raise ValueError(
            f'checkpoint at {path!r} is not committed (no {COMMIT_MARKER} '
            'marker: a torn or in-flight write)'
        )
    saved_man = _read_manifest(path)
    if saved_man is not None:
        cur = layout_manifest(engine)
        if _layout_view(saved_man) != _layout_view(cur):
            diff = [k for k in _LAYOUT_KEYS if saved_man.get(k) != cur.get(k)]
            raise ValueError(
                f'checkpoint at {path!r} was saved under a different state '
                f'layout (differing fields: {diff}; saved engine '
                f"{saved_man.get('engine')}, restoring into {cur.get('engine')}). "
                'Cross-layout factor migration is not ported to kfac_tpu_torch '
                'yet; restore into the engine it was saved from, or move the '
                'factors with save_factors / load_factors.'
            )
    payload = torch.load(os.path.join(path, PAYLOAD), map_location='cpu', weights_only=True)
    if not isinstance(payload, dict) or 'kfac' not in payload:
        raise ValueError(f'checkpoint at {path!r} holds no K-FAC state')
    state = from_durable(engine, payload['kfac'], path)
    extra = {k: v for k, v in payload.items() if k != 'kfac'}
    if extra_template is not None:
        missing = sorted(set(extra_template) - set(extra))
        if missing:
            raise ValueError(
                f'checkpoint at {path!r} lacks the extras {missing} (it holds '
                f'{sorted(extra)})'
            )
        extra = {k: extra[k] for k in extra_template}
    return state, extra


# ------------------------------------------------------- portable factors


def _factor_key(name: str, side: str) -> str:
    return f'factors/{name}/{side}'


def save_factors(path: str, engine: Any, state: Any) -> None:
    """Write each layer's true-dim factors and the step to the ``.npz``
    file ``path`` (keys ``step`` and ``factors/<layer>/a``, ``.../g``),
    atomically, with the layout manifest sidecar. Any numpy reads it; the
    JAX package's factors written in this layout load with
    :func:`load_factors`."""
    path = _local(path)
    arrays = {'step': np.asarray(int(state.step), np.int64)}
    for name, fg in engine.extract_factors(state).items():
        for side in ('a', 'g'):
            arrays[_factor_key(name, side)] = fg[side].detach().cpu().numpy()
    mpath = _manifest_path(path)
    if os.path.exists(mpath):
        os.remove(mpath)
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    _write_json(mpath, layout_manifest(engine))


def load_factors(path: str, engine: Any) -> Any:
    """A fresh ``engine`` state holding a :func:`save_factors` file's
    factors and step, decompositions rematerialized. The engine must
    register exactly the stored layers at the stored dims."""
    path = _local(path)
    with np.load(path) as z:
        step = int(z['step'])
        loaded: dict[str, Any] = {'step': step, 'a': {}, 'g': {}}
        for key in z.files:
            if key.startswith('factors/'):
                name, side = key[len('factors/'):].rsplit('/', 1)
                loaded[side][name] = np.array(z[key])
    return from_durable(engine, loaded, path)
