"""Checkpoint and resume of the K-FAC state (counterpart of
``kfac_tpu/checkpoint.py``).

As in the JAX package, only the step counter, the factors A and G, with
the health sentinel on its counters, and with the compressed stat
transport its error-feedback residuals (``comp_ef``) are durable; the
decompositions are derived state, recomputed on load by
``engine.rematerialize``. A state whose factors are spilled to host memory
(the cold-factor offload) is refused: the Trainer saves its manager's
resident ``host_view`` instead.

The on-disk format is the port's own (the JAX package writes orbax):

- :func:`save` writes a directory and its commit marker ``COMMITTED``,
  last. Every file is a ``torch.save`` of CPU tensors and plain Python
  values, read back with ``torch.load(..., weights_only=True)``. The
  directory is written as a temporary sibling, fsynced, and renamed onto
  ``path``, so a torn write never looks committed. The dense engine's
  state and the extras go into one ``state.pt``. A
  :class:`~kfac_tpu_torch.parallel.DistributedKFAC`'s state is sharded:
  each rank writes its own ``shard-<rank>-of-<world>.pt`` (the step, its
  factor blocks and the health counters), rank 0 writes the extras
  (``extra.pt``), and rank 0 commits only once a barrier has shown every
  shard durable (the JAX package's single-writer ``SAVE_PROTOCOL``). A
  shared filesystem is assumed, as orbax assumes.
- :func:`save_factors` writes one ``.npz`` of layer-named true-dim factors
  (``factors/<layer>/a``, ``factors/<layer>/g``) and ``step``, which any
  numpy reads.

Both carry the JAX package's JSON layout-manifest sidecar,
``<path>.manifest.json``, written only once the checkpoint is durable.
:func:`restore` reads a checkpoint into another layout too (another bucket
granularity or colocation, another world, dense and distributed in either
direction), migrating through per-layer factors as the JAX package does.
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
EXTRA = 'extra.pt'
COMMIT_MARKER = 'COMMITTED'
_FORMAT = 1
_HEALTH_FIELDS = ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')


def layout_manifest(engine: Any) -> dict[str, Any]:
    """JSON description of an engine's durable-state layout, with the JAX
    package's keys: ``format``, ``engine``, ``compute_method``, for
    information only ``topology`` and, for the stacked engine,
    ``bucket_granularity``, ``colocate_factors`` and each ``a_store`` and
    ``g_store`` entry's ``key``, ``layers``, ``d``, ``padded`` and
    ``dims``. The dense engine has no stacked stores, so its layout is its
    class name."""
    man: dict[str, Any] = {'format': 1, 'engine': type(engine).__name__}
    cfg = getattr(engine, 'config', engine)
    cm = getattr(cfg, 'compute_method', None)
    man['compute_method'] = getattr(cm, 'name', str(cm))
    topo = getattr(engine, 'topology', None)
    if callable(topo):
        man['topology'] = topo()
    if _stacked(engine):
        man['bucket_granularity'] = int(cfg.bucket_granularity)
        man['colocate_factors'] = bool(cfg.colocate_factors)
        man['a_store'] = [_bucket_entry(sb) for sb in engine.a_store]
        man['g_store'] = [_bucket_entry(sb) for sb in engine.g_store]
    return man


def _stacked(engine: Any) -> bool:
    """Whether ``engine`` keeps the stacked, sharded state."""
    return hasattr(engine, 'a_store')


def _bucket_entry(sb: Any) -> dict[str, Any]:
    return {
        'key': str(sb.key),
        'layers': list(sb.layers),
        'd': int(sb.d),
        'padded': int(sb.padded),
        'dims': [int(d) for d in sb.dims],
    }


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
    ``g`` (layer-keyed tensors, or a distributed state's store-keyed
    blocks), when the sentinel is on ``health``: its counters with the
    layer ``names`` they are ordered by, and with error feedback
    ``comp_ef`` (a distributed state's slices of each chunk's residual).

    Raises on a spilled state (the cold-factor offload's placeholders), as
    the JAX package does."""
    from kfac_tpu_torch.compression import offload as offload_lib

    if offload_lib.is_spilled(state):
        raise ValueError(
            'cannot checkpoint a spilled K-FAC state: the factor slots are '
            'cold-offload placeholders (the real factors live in host RAM). '
            'Use OffloadManager.host_view(state) for a resident view, or '
            'let the Trainer checkpoint driver handle it.'
        )
    out: dict[str, Any] = {'step': int(state.step), 'a': dict(state.a), 'g': dict(state.g)}
    health = getattr(state, 'health', None)
    if health is not None:
        out['health'] = {
            'names': list(health.names), 'skipped_steps': health.skipped_steps,
            **{f: getattr(health, f) for f in _HEALTH_FIELDS},
        }
    comp_ef = getattr(state, 'comp_ef', None)
    if comp_ef is not None:
        out['comp_ef'] = dict(comp_ef)
    return out


def shard_name(rank: int, world: int) -> str:
    """The file of rank ``rank``'s shard in a ``world``-rank checkpoint."""
    return f'shard-{rank:05d}-of-{world:05d}.pt'


def durable_shard(engine: Any, state: Any) -> dict[str, Any]:
    """This rank's shard of a distributed state's durable slice:
    :func:`durable_state` of its factor blocks, with the ``world``, its
    ``rank`` and the slot range ``[lo, hi)`` of each store's block
    (``ranges``), so a restore onto another world can reassemble the
    stacks."""
    return {
        **durable_state(state),
        'world': engine.world,
        'rank': engine.mesh.rank,
        'ranges': {
            side: {sb.key: list(engine._factor_range(sb.padded)) for sb in store}
            for side, store in (('a', engine.a_store), ('g', engine.g_store))
        },
    }


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


def _with_health(state: Any, loaded: dict[str, Any]) -> Any:
    """``state`` with the loaded step and, where both the engine and the
    checkpoint have them, the loaded health counters.

    The counterpart of the JAX package's ``_retry_health_mismatch``:
    toggling the sentinel between save and restore is configuration, not
    a layout change. Counters saved without a sentinel in the engine are
    dropped; an engine with a sentinel restoring a checkpoint without
    counters keeps ``init()``'s fresh ones.
    """
    state = dataclasses.replace(state, step=int(np.asarray(loaded['step'])))
    if 'health' in loaded and getattr(state, 'health', None) is not None:
        state = dataclasses.replace(
            state, health=_health_from_saved(loaded['health'], state.health)
        )
    return state


def _with_durable(engine: Any, state: Any, loaded: dict[str, Any]) -> Any:
    """``state`` with the loaded per-layer factors, step and health."""
    factors = {n: {'a': loaded['a'][n], 'g': loaded['g'][n]} for n in loaded['a']}
    return _with_health(engine.insert_factors(state, factors), loaded)


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
            _check_finite(path, side, name, arr)
            if tuple(arr.shape) != tuple(exp):
                raise ValueError(
                    f'checkpoint at {path!r}: restored {side.upper()} factor for '
                    f'layer {name!r} has shape {tuple(arr.shape)} but the engine '
                    f'expects {tuple(exp)} — the model architecture changed '
                    'between save and restore.'
                )


def _check_finite(path: str, side: str, name: str, arr: torch.Tensor) -> None:
    finite = torch.isfinite(arr)
    if not bool(finite.all()):
        bad = int(arr.numel() - int(finite.sum()))
        raise ValueError(
            f'checkpoint at {path!r}: restored {side.upper()} factor for '
            f'layer {name!r} contains {bad} non-finite values — the '
            'checkpoint is corrupt (saved from a diverged run?); restore '
            'a different one or reinitialize the preconditioner state.'
        )


def _validate_blocks(path: str, engine: Any, loaded: dict[str, Any]) -> None:
    """:func:`_validate_restored_factors` for a distributed engine's own
    factor blocks: each store's block of the engine's shape, and every
    layer slot finite (the error names the layer)."""
    for side, store in (('a', engine.a_store), ('g', engine.g_store)):
        for sb in store:
            lo, hi = engine._factor_range(sb.padded)
            block = loaded[side].get(sb.key)
            if block is None or tuple(block.shape) != (hi - lo, sb.d, sb.d):
                raise ValueError(
                    f'checkpoint at {path!r}: its {side.upper()} store {sb.key!r} does not '
                    f"hold this rank's block of {hi - lo} slots of {sb.d} x {sb.d}; "
                    'restore into the layout it was saved from, or save with engine= so '
                    'the layout manifest lets it migrate.'
                )
            for s in range(lo, min(hi, len(sb.layers))):
                _check_finite(path, side, sb.layers[s], block[s - lo])


def from_durable(engine: Any, loaded: dict[str, Any], path: str) -> Any:
    """A rematerialized engine state from a durable dict (``step``, ``a``,
    ``g`` per layer, maybe ``health``; tensors or arrays): validated,
    inserted into ``engine.init()``, decompositions recomputed. The loaded
    health counters are kept over the ones ``rematerialize`` ticks, as the
    JAX package's restore keeps them: they are the durable truth of the
    run."""
    _validate_restored_factors(path, engine, loaded)
    return _rematerialized(engine, _with_durable(engine, engine.init(), loaded))


def _rematerialized(engine: Any, state: Any) -> Any:
    """``engine.rematerialize(state)`` with the state's health counters
    (the loaded ones) put back after it."""
    loaded_health = getattr(state, 'health', None)
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


def _write_file(path: str, payload: Any) -> int:
    """``torch.save`` of ``payload`` to ``path``, fsynced; its bytes."""
    with open(path, 'wb') as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


def _commit_dir(tmp: str, path: str, marker: dict[str, Any]) -> None:
    """Write the commit ``marker`` into the written directory ``tmp``,
    fsync it, and rename it onto ``path`` (an existing ``path`` is moved
    aside first and removed after)."""
    with open(os.path.join(tmp, COMMIT_MARKER), 'w') as f:
        json.dump({'format': _FORMAT, **marker}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    old = None
    if os.path.exists(path):  # overwrite=True, checked by save
        old = f'{path}.old-{os.path.basename(tmp).rsplit("-", 1)[-1]}'
        os.replace(path, old)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _tmp_dir(path: str, tag: str) -> str:
    return f'{path}.tmp-{tag}'


def _write_committed(path: str, payload: Any) -> None:
    """Write ``payload`` as a committed one-file :func:`save` directory at
    ``path``: a temporary sibling, fsynced, its marker last, renamed into
    place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = _tmp_dir(path, f'{os.getpid()}-{uuid.uuid4().hex[:8]}')
    os.makedirs(tmp)
    try:
        nbytes = _write_file(os.path.join(tmp, PAYLOAD), payload)
        _commit_dir(tmp, path, {'payload': PAYLOAD, 'bytes': nbytes})
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
    """Runs one ``write`` after the snapshot's copies finish; keeps any
    error for the handle to raise."""

    def __init__(self, write, ready: torch.cuda.Event | None) -> None:
        super().__init__(name='kfac-checkpoint-writer')
        self.write, self.ready = write, ready
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            if self.ready is not None:
                self.ready.synchronize()
            self.write()
        except BaseException as exc:  # raised by the handle's wait
            self.error = exc


class _AsyncSaveHandle:
    """Returned by :func:`save`: ``wait_until_finished()`` joins the writer,
    raises its error, and then finalizes (the sharded commit and the
    manifest sidecar), so a manifest on disk implies a durable checkpoint.
    After an error, the next wait writes the same snapshot again (a
    caller's retry). A sharded save's wait is a collective: every rank
    learns whether every shard landed, and all raise (``OSError``) or all
    commit.

    Usable as a context manager (``with save(..., wait=False):`` waits on
    exit). Dropping the handle without waiting warns: the write may still
    commit, but its manifest is never written.
    """

    def __init__(self, writer: _Writer, finalize, agree=None) -> None:
        self._writer = writer
        self._finalize = finalize
        self._agree = agree  # a sharded save's vote over its ranks
        self._done = False
        self._failed = False

    def done(self) -> bool:
        """Whether this process's write has ended (no wait, no device
        sync)."""
        return not self._writer.is_alive()

    def wait_until_finished(self) -> None:
        if self._done:
            return
        if self._failed:
            self._writer = _Writer(self._writer.write, None)
            self._writer.start()
            self._failed = False
        self._writer.join()
        error = self._writer.error
        if self._agree is not None and not self._agree(error is None):
            self._failed = True
            raise OSError(
                f'a checkpoint shard write failed ({"here: " + repr(error) if error else "on another process"})'
            ) from error
        if error is not None:
            self._failed = True
            raise error
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
    (``<path>.manifest.json``), once the checkpoint is durable. A
    :class:`~kfac_tpu_torch.parallel.DistributedKFAC`'s state needs its
    engine (its blocks' slot ranges go into each shard), and every rank of
    its grid calls: each writes its shard, rank 0 the extras, the manifest
    and, after a barrier shows every shard durable, the commit marker; the
    ranks pass each ``extra`` (only rank 0's is written).

    ``wait=False`` returns once the snapshot is enqueued (device-to-host
    copies into pinned memory on the current stream, a CUDA event behind
    them); a thread writes it. Training can go on at once: the copies
    precede anything enqueued after this call, in-place updates included.
    Call the handle's ``wait_until_finished()`` before relying on the
    files (every rank, for a sharded save). ``wait=True`` returns a
    finished handle.

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
    if extra and 'kfac' in extra:
        raise ValueError("'kfac' is the K-FAC state's key; name the extra otherwise")
    if hasattr(state, 'inv_damping') and not _stacked(engine):
        raise ValueError(
            'a DistributedKFAC state is saved with its engine: pass engine=<the DistributedKFAC>'
        )
    rank0 = (engine.mesh.rank if _stacked(engine) else multihost.process_index()) == 0
    mpath = _manifest_path(path)

    def finalize_manifest() -> None:
        if engine is not None and rank0:
            _write_json(mpath, layout_manifest(engine))

    if not _stacked(engine):
        # one replicated state: process 0 writes it, the others wait on it
        handle = _save_replicated(path, state, extra, rank0, mpath, finalize_manifest)
    else:
        handle = _save_sharded(path, state, extra, engine, rank0, mpath, finalize_manifest)
    handle._writer.start()
    if wait:
        handle.wait_until_finished()
    return handle


def _save_replicated(path, state, extra, rank0, mpath, finalize_manifest) -> _AsyncSaveHandle:
    """The one-file save of a dense state; with several processes, process
    0 writes and the handle's wait is a collective (every process returns
    once the checkpoint is committed)."""
    if multihost.process_count() > 1:
        multihost.barrier('kfac-checkpoint-check')  # every process checked the path
    if not rank0:
        return _AsyncSaveHandle(
            _Writer(lambda: None, None), lambda: multihost.barrier('kfac-checkpoint-commit'),
            multihost.agree_decision,
        )
    host_payload, ready = snapshot({'kfac': durable_state(state), **(extra or {})})
    if os.path.exists(mpath):
        os.remove(mpath)
    if multihost.process_count() == 1:
        return _AsyncSaveHandle(
            _Writer(lambda: _write_committed(path, host_payload), ready), finalize_manifest
        )

    def finalize() -> None:
        finalize_manifest()
        multihost.barrier('kfac-checkpoint-commit')

    return _AsyncSaveHandle(
        _Writer(lambda: _write_committed(path, host_payload), ready), finalize,
        multihost.agree_decision,
    )


def _save_sharded(path, state, extra, engine, rank0, mpath, finalize_manifest) -> _AsyncSaveHandle:
    """The sharded save of a distributed state (every rank of its grid):
    rank 0 makes the temporary directory, each rank's writer writes its
    shard (and rank 0's the extras) into it, and the handle's wait commits
    once every rank has its shard durable."""
    world, group = engine.world, engine.mesh.group
    name = shard_name(engine.mesh.rank, world)
    tmp = _tmp_dir(path, multihost.from_process_zero(f'{os.getpid()}-{uuid.uuid4().hex[:8]}', group))
    files = {name: durable_shard(engine, state)}
    if rank0:
        files[EXTRA] = dict(extra or {})
        if os.path.exists(mpath):
            os.remove(mpath)
        os.makedirs(tmp)
    # a pinned buffer a file (a file saves the whole storage of its views);
    # the last event marks every copy, all on one stream
    host_files, ready = {}, None
    for fname, payload in files.items():
        host_files[fname], event = snapshot(payload)
        ready = event or ready
    multihost.barrier('kfac-checkpoint-mkdir', group)

    def write() -> None:
        for fname, payload in host_files.items():
            _write_file(os.path.join(tmp, fname), payload)

    def finalize() -> None:
        # every shard is durable (the wait's agreement): rank 0 commits
        if rank0:
            sizes = {n: os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp)}
            _commit_dir(tmp, path, {
                'world': world, 'shards': [shard_name(r, world) for r in range(world)],
                'extra': EXTRA, 'bytes': sizes,
            })
            finalize_manifest()
        multihost.barrier('kfac-checkpoint-commit', group)

    return _AsyncSaveHandle(
        _Writer(write, ready), finalize, lambda ok: multihost.agree_decision(ok, group)
    )


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


def _load(path: str, name: str) -> Any:
    return torch.load(os.path.join(path, name), map_location='cpu', weights_only=True)


def _full_stacks(path: str, marker: dict[str, Any]) -> dict[str, Any]:
    """A sharded checkpoint's durable state with each store's stack
    reassembled from every shard's block: ``{'step', 'a': {key: (L, d,
    d)}, 'g', 'health'?, 'comp_ef'?}``; each residual is the ranks'
    slices in rank order (its first ``elements`` are the JAX package's
    replicated residual)."""
    shards = [_load(path, n) for n in marker['shards']]
    out = {k: v for k, v in shards[0].items() if k in ('step', 'health')}
    if 'comp_ef' in shards[0]:
        by_rank = sorted(shards, key=lambda sh: sh['rank'])
        out['comp_ef'] = {
            key: torch.cat([sh['comp_ef'][key] for sh in by_rank]) for key in shards[0]['comp_ef']
        }
    for side in ('a', 'g'):
        out[side] = {
            key: torch.cat([
                sh[side][key] for sh in sorted(shards, key=lambda sh: sh['ranges'][side][key][0])
            ])
            for key in shards[0][side]
        }
    return out


def _factors_from_saved(durable: dict[str, Any], saved_man: dict[str, Any]) -> dict[str, Any]:
    """Per-layer true-dim factors from a saved durable state and the
    manifest it was written with (the JAX package's function): a stacked
    payload's slots sliced out by each store entry, or a dense payload's
    layer-keyed factors as they are. Returns ``{'step', 'a': {layer: A},
    'g': {layer: G}, 'health'?}``."""
    out = {k: v for k, v in durable.items() if k in ('step', 'health')}
    out['a'], out['g'] = {}, {}
    if 'a_store' not in saved_man:
        out['a'], out['g'] = dict(durable['a']), dict(durable['g'])
        return out
    for side in ('a', 'g'):
        for entry in saved_man[f'{side}_store']:
            stack = durable[side][entry['key']]
            for i, name in enumerate(entry['layers']):
                d = entry['dims'][i]
                out[side][name] = stack[i, :d, :d]
    return out


def _check_migration(path: str, engine: Any, loaded: dict[str, Any]) -> None:
    """The JAX package's refusals of a migration: another layer set, or a
    layer of another width."""
    reg = engine.registry
    saved = set(loaded['a'])
    if saved != set(reg.names()):
        raise ValueError(
            f'checkpoint at {path!r} stores factors for layers {sorted(saved)} '
            f'but the restoring engine registers {sorted(reg.names())}; factor '
            'migration requires identical layer sets.'
        )
    for name, h in reg.layers.items():
        exp = (tuple(h.a_factor_shape), tuple(h.g_factor_shape))
        got = (tuple(loaded['a'][name].shape), tuple(loaded['g'][name].shape))
        if exp != got:
            raise ValueError(
                f'checkpoint at {path!r}: layer {name!r} stores factor shapes {got} '
                f'but the restoring engine expects {exp} — the model architecture '
                'changed between save and restore; factors cannot migrate across '
                'layer widths.'
            )


def _load_durable(
    path: str, engine: Any, marker: dict[str, Any]
) -> tuple[str, dict[str, Any], dict[str, Any] | None]:
    """Read and validate a checkpoint's durable state for ``engine`` (no
    device work): ``('layers', per-layer durable dict, ...)`` for the
    dense engine or a migration, ``('blocks', the engine's own factor
    blocks, ...)`` for a distributed engine restoring its own layout; the
    third item is a one-file checkpoint's whole payload (its extras), else
    None."""
    saved_man = _read_manifest(path)
    sharded = 'shards' in marker
    cur = layout_manifest(engine)
    if saved_man is not None and _layout_view(saved_man) != _layout_view(cur):
        diff = [k for k in _LAYOUT_KEYS if saved_man.get(k) != cur.get(k)]
        payload = None if sharded else _load(path, PAYLOAD)
        durable = _full_stacks(path, marker) if sharded else payload['kfac']
        loaded = _factors_from_saved(durable, saved_man)
        _check_migration(path, engine, loaded)
        _validate_restored_factors(path, engine, loaded)
        _warnings.warn(
            f'checkpoint at {path!r} was saved under a different state layout '
            f'(differing fields: {diff}); migrating through per-layer factors '
            '(slower than a layout-exact restore, numerically identical)',
            stacklevel=4,
        )
        return 'layers', loaded, payload
    if not sharded:
        payload = _load(path, PAYLOAD)
        if not isinstance(payload, dict) or 'kfac' not in payload:
            raise ValueError(f'checkpoint at {path!r} holds no K-FAC state')
        _validate_restored_factors(path, engine, payload['kfac'])
        return 'layers', payload['kfac'], payload
    if not _stacked(engine):
        raise ValueError(
            f'checkpoint at {path!r} holds a distributed state and has no layout '
            'manifest to migrate it by'
        )
    # the same layout: this rank's own shard, or the stacks reassembled
    # from every shard when the world changed
    own = shard_name(engine.mesh.rank, engine.world)
    if marker['world'] == engine.world and own in marker['shards']:
        loaded = _load(path, own)
    else:
        loaded = _full_stacks(path, marker)
        for side, store in (('a', engine.a_store), ('g', engine.g_store)):
            for sb in store:
                lo, hi = engine._factor_range(sb.padded)
                if sb.key in loaded[side]:
                    loaded[side][sb.key] = loaded[side][sb.key][lo:hi]
        if 'comp_ef' in loaded and getattr(engine, '_comp_plan', None) is not None:
            loaded['comp_ef'] = {k: engine.ef_slice(k, v) for k, v in loaded['comp_ef'].items()}
    _validate_blocks(path, engine, loaded)
    _check_comp_ef(path, engine, loaded)
    return 'blocks', loaded, None


def _check_comp_ef(path: str, engine: Any, loaded: dict[str, Any]) -> None:
    """The JAX package's refusal of error-feedback residuals that the
    engine cannot take: saved under ``stat_compression``, restored into an
    engine without it (or with another chunking). A checkpoint without
    residuals restores into a compressed engine with ``init()``'s zeros."""
    if 'comp_ef' not in loaded:
        return
    plan = getattr(engine, '_comp_plan', None)
    want = None
    if plan is not None and engine._compression.error_feedback:
        want = {f'c{i}': (c['padded'] // engine.world,) for i, c in enumerate(plan)}
    if want != {k: tuple(v.shape) for k, v in loaded['comp_ef'].items()}:
        raise ValueError(
            f'checkpoint at {path!r} does not match the engine state '
            'layout. For DistributedKFAC the stacked bucket keys/shapes '
            'depend on the config (notably bucket_granularity and '
            'colocate_factors), and error-feedback residuals saved under '
            'stat_compression need a compression-enabled engine (or the same '
            'chunking) to restore into: restore with the SAME values the '
            'checkpoint was saved under — or write checkpoints with '
            'save(..., engine=engine) so restore can diagnose and migrate '
            'layout changes. Original error: the checkpoint holds comp_ef '
            'residuals the engine has no slot for'
        )


def restore(
    path: str,
    engine: Any,
    extra_template: dict[str, Any] | None = None,
) -> tuple[Any, dict[str, Any]]:
    """Load a :func:`save` directory into a fresh ``engine.init()`` state
    and recompute its decompositions with ``engine.rematerialize``.
    Returns ``(state, extra)``; the extras are host tensors and values as
    saved (a sharded checkpoint's, written by rank 0, read on every rank).

    ``extra_template``: its keys name the extras the caller needs; a
    checkpoint without one of them is rejected, and only those are
    returned (the payload carries its own structure, so the values are not
    read).

    The layout cases, as in the JAX package: a manifest whose layout keys
    match the engine's restores directly (a distributed engine's ranks each
    read their own shard, or reassemble the stacks without a warning when
    the world changed); a manifest whose layout keys differ (bucket
    granularity, colocation, dense and distributed either way, a world that
    changes the padding) migrates through per-layer true-dim factors with
    the JAX package's ``migrating`` warning, refusing another layer set or
    another layer width with its messages, the health counters carried
    verbatim. A checkpoint without the commit marker, or with a corrupt
    payload, raises ``ValueError``. With a distributed engine every rank
    calls, and all of them raise, or none does.
    """
    path = _local(path)
    try:
        if not is_committed(path):
            raise ValueError(
                f'checkpoint at {path!r} is not committed (no {COMMIT_MARKER} '
                'marker: a torn or in-flight write)'
            )
        with open(os.path.join(path, COMMIT_MARKER)) as f:
            marker = json.load(f)
        kind, loaded, payload = _load_durable(path, engine, marker)
        extra = payload if payload is not None else _load(path, marker['extra'])
        if not isinstance(extra, dict):
            raise ValueError(f'checkpoint at {path!r} holds no extras dict')
        extra = {k: v for k, v in extra.items() if k != 'kfac'}
        if extra_template is not None:
            missing = sorted(set(extra_template) - set(extra))
            if missing:
                raise ValueError(
                    f'checkpoint at {path!r} lacks the extras {missing} (it holds '
                    f'{sorted(extra)})'
                )
            extra = {k: extra[k] for k in extra_template}
        error = None
    except Exception as exc:  # agreed across the ranks below
        error = exc
    if _stacked(engine) and not multihost.agree_decision(error is None, engine.mesh.group):
        if error is None:
            raise ValueError(f'checkpoint at {path!r} was rejected on another process')
    if error is not None:
        raise error
    if kind == 'layers':
        # a migration's residuals start from init()'s zeros, as the JAX
        # package's migration leaves them
        state = _with_durable(engine, engine.init(), loaded)
    else:
        state = _with_health(dataclasses.replace(
            engine.init(),
            a={k: v.to(engine.device) for k, v in loaded['a'].items()},
            g={k: v.to(engine.device) for k, v in loaded['g'].items()},
        ), loaded)
        if 'comp_ef' in loaded:
            state = dataclasses.replace(
                state, comp_ef={k: v.to(engine.device) for k, v in loaded['comp_ef'].items()}
            )
    return _rematerialized(engine, state), extra


# ------------------------------------------------------- portable factors


def _factor_key(name: str, side: str) -> str:
    return f'factors/{name}/{side}'


def save_factors(path: str, engine: Any, state: Any) -> None:
    """Write each layer's true-dim factors and the step to the ``.npz``
    file ``path`` (keys ``step`` and ``factors/<layer>/a``, ``.../g``),
    atomically, with the layout manifest sidecar. Any numpy reads it; the
    JAX package's factors written in this layout load with
    :func:`load_factors`. With a distributed engine every rank calls (the
    factors are gathered) and rank 0 writes."""
    path = _local(path)
    arrays = {'step': np.asarray(int(state.step), np.int64)}
    for name, fg in engine.extract_factors(state).items():
        for side in ('a', 'g'):
            arrays[_factor_key(name, side)] = fg[side].detach().cpu().numpy()
    if (engine.mesh.rank if _stacked(engine) else multihost.process_index()) == 0:
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
    if _stacked(engine):
        multihost.barrier('kfac-save-factors', engine.mesh.group)


def load_factors(path: str, engine: Any) -> Any:
    """A fresh ``engine`` state holding a :func:`save_factors` file's
    factors and step, decompositions rematerialized. The engine must
    register exactly the stored layers at the stored dims; with a
    distributed engine every rank calls."""
    path = _local(path)
    with np.load(path) as z:
        step = int(z['step'])
        loaded: dict[str, Any] = {'step': step, 'a': {}, 'g': {}}
        for key in z.files:
            if key.startswith('factors/'):
                name, side = key[len('factors/'):].rsplit('/', 1)
                loaded[side][name] = np.array(z[key])
    return from_durable(engine, loaded, path)
