"""Carry weights and K-FAC state over from the JAX package.

Takes numpy arrays (``numpy.asarray`` of JAX arrays), so this module
needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from kfac_tpu_torch.preconditioner import KFACPreconditioner, KFACState


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's module of the same structure.

    Dense ``kernel`` (d_in, d_out) becomes ``weight`` (d_out, d_in); a
    conv ``kernel`` (kh, kw, C_in, C_out) becomes ``weight`` (C_out, C_in,
    kh, kw); ``Embed.embedding`` and LayerNorm and BatchNorm ``scale``
    become ``weight``; ``bias`` and raw params (``pos_embed``) keep their
    names. Paths join with '.', so an MoE block's ``moe/router`` and
    ``moe/expert{e}_{up,down}`` and a LoRA unit's ``base``, ``down`` and
    ``up`` land on the port's modules of those names.
    """
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        *mod, leaf = path
        arr = np.asarray(value)
        if leaf == 'kernel':
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f'only dense and 2-D conv kernels convert, got {path} {arr.shape}')
            leaf = 'weight'
        elif leaf in ('embedding', 'scale'):
            leaf = 'weight'
        out['.'.join((*mod, leaf))] = torch.from_numpy(np.array(arr, copy=True))
    return out


def from_flax_batch_stats(
    batch_stats: Mapping[str, Any], device: str | torch.device = 'cpu'
) -> dict[str, dict[str, torch.Tensor]]:
    """The port's ``model_state`` from a flax ``batch_stats`` collection
    (numpy): ``{'stage0_block0/bn1': {'mean': ..., 'var': ...}}``, each
    BatchNorm's statistics under its module path joined with '/', on
    ``device``."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for path, value in _flatten(batch_stats):
        *mod, leaf = path
        tensor = torch.from_numpy(np.array(value, np.float32)).to(device)
        out.setdefault('/'.join(mod), {})[leaf] = tensor
    return out


_STATE_FIELDS = ('a', 'g', 'qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')


def _tensor(value: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(dtype).to(device)


def _observability_from_jax(
    state: Any, jax_state: Any, dev: torch.device, flight: bool
) -> dict[str, Any]:
    """The JAX state's health counters (its per-layer dicts packed in
    registry order), metrics (scalars and step trackers) and, with
    ``flight``, flight ring, for each that both sides have: the
    ``health``, ``metrics`` and ``flight`` fields of a
    ``dataclasses.replace`` of ``state``."""
    out: dict[str, Any] = {}
    jh = getattr(jax_state, 'health', None)
    if state.health is not None and jh is not None:
        names = state.health.names
        out['health'] = dataclasses.replace(
            state.health,
            skipped_steps=_tensor(jh.skipped_steps, torch.int32, dev),
            damping_mult=_tensor([jh.damping_mult[n] for n in names], torch.float32, dev),
            **{
                field: _tensor([getattr(jh, field)[n] for n in names], torch.int32, dev)
                for field in ('quarantined', 'bad_inv', 'quarantine_events')
            },
        )
    jm = getattr(jax_state, 'metrics', None)
    if state.metrics is not None and jm is not None:
        if tuple(jm.keys) != state.metrics.keys:
            raise ValueError('the JAX state\'s metric keys differ from the engine\'s')
        out['metrics'] = dataclasses.replace(
            state.metrics,
            last_factor_step=_tensor(jm.last_factor_step, torch.int32, dev),
            last_inv_step=_tensor(jm.last_inv_step, torch.int32, dev),
            scalars=_tensor(jm.scalars, torch.float32, dev),
        )
    jf = getattr(jax_state, 'flight', None) if flight else None
    if state.flight is not None and jf is not None:
        if tuple(jf.keys) != state.flight.keys or jf.steps.shape[0] != state.flight.capacity:
            raise ValueError('the JAX state\'s flight ring differs from the engine\'s')
        out['flight'] = dataclasses.replace(state.flight, **{
            field: _tensor(getattr(jf, field), dtype, dev)
            for field, dtype in (
                ('steps', torch.int32), ('loss', torch.float32), ('loss_valid', torch.bool),
                ('grad_norm', torch.float32), ('scalars', torch.float32),
            )
        })
    return out


def from_jax_kfac_state(jax_state: Any, kfac: KFACPreconditioner) -> KFACState:
    """The port's :class:`KFACState` holding the JAX state's step, factors
    and decompositions, on ``kfac.device``; with health and metrics on both
    sides, also the health counters (the JAX package's per-layer dicts
    packed in registry order) and the metrics' scalars and step trackers;
    with ``async_inverse='sliced'`` on both sides, the shadow's fields,
    ``progress`` and ``damping``, so a run continues from a mid-window JAX
    state. The flight ring starts empty.

    ``jax_state`` is a ``kfac_tpu.KFACState`` (or anything with its fields);
    slots the port's configuration does not use are dropped. An offload
    engine's state converts while resident; a spilled one (the JAX
    package's zero-size placeholders) is refused.
    """
    a0 = next(iter(jax_state.a.values()), None)
    if a0 is not None and np.ndim(a0) == 1 and np.shape(a0)[0] == 0:
        raise ValueError(
            'the JAX state is spilled (cold-offload placeholders in place of '
            'its factors): convert it while resident, or its host_view'
        )
    state = kfac.init()
    dev = kfac.device
    updates: dict[str, Any] = {'step': int(np.asarray(jax_state.step))}
    for field in _STATE_FIELDS:
        ours = getattr(state, field)
        theirs = getattr(jax_state, field)
        updates[field] = {
            n: torch.from_numpy(np.array(theirs[n], np.float32)).to(dev)
            for n in ours
        }
    updates.update(_observability_from_jax(state, jax_state, dev, flight=False))
    js = getattr(jax_state, 'shadow', None)
    if state.shadow is not None and js is not None:
        updates['shadow'] = dataclasses.replace(
            state.shadow,
            progress=int(np.asarray(js.progress)),
            damping=float(np.asarray(js.damping)),
            **{
                field: {n: _tensor(getattr(js, field)[n], torch.float32, dev) for n in ours}
                for field in _STATE_FIELDS[2:]
                if (ours := getattr(state.shadow, field))
            },
        )
    return dataclasses.replace(state, **updates)


def from_jax_durable(arrays: Mapping[str, Any], kfac: KFACPreconditioner) -> KFACState:
    """A rematerialized port :class:`KFACState` from the JAX package's
    durable dict (``kfac_tpu.checkpoint.durable_state``) as numpy arrays:
    ``{'step', 'a': {layer: A}, 'g': {layer: G}}`` and, when its sentinel
    was on, ``'health'`` (a dict per counter keyed by layer). The factors
    go through :meth:`KFACPreconditioner.insert_factors` and
    :meth:`~KFACPreconditioner.rematerialize`, as a restore does, so a JAX
    run continues in the port; the JAX health counters are kept where the
    engine has a sentinel."""
    from kfac_tpu_torch import checkpoint

    loaded = {
        'step': int(np.asarray(arrays['step'])),
        'a': {n: np.array(v, np.float32) for n, v in arrays['a'].items()},
        'g': {n: np.array(v, np.float32) for n, v in arrays['g'].items()},
    }
    if arrays.get('health') is not None:
        loaded['health'] = arrays['health']
    return checkpoint.from_durable(kfac, loaded, 'the JAX durable state')


def from_jax_dist_state(jax_state: Any, engine: Any) -> Any:
    """This rank's :class:`~kfac_tpu_torch.parallel.DistKFACState` from a
    JAX ``DistKFACState`` of the same configuration and world, or from the
    dict of its fields that :func:`gather_dist_state` returns, its stacks
    as numpy (``numpy.asarray`` of the global arrays): the rank's factor
    block of each store and its column's block of each decomposition, on
    ``engine.device``. The step and ``inv_damping`` are carried over, and
    the health counters, metrics and flight ring where the JAX state and
    the engine both have them (replicated: the same on every rank), the
    sliced refresh's shadow (its column blocks, ``progress`` and
    ``damping``) and the compressed transport's residuals (this rank's
    slice of each replicated chunk, :meth:`DistributedKFAC.ef_slice`)."""
    def field_of(name):
        return jax_state[name] if isinstance(jax_state, Mapping) else getattr(jax_state, name)

    state = engine.init()
    dev = engine.device
    updates: dict[str, Any] = {
        'step': int(np.asarray(field_of('step'))),
        'inv_damping': float(np.asarray(field_of('inv_damping'))),
    }
    for field in _STATE_FIELDS:
        theirs = field_of(field)
        blocks = {}
        for key in getattr(state, field):
            full = np.asarray(theirs[key], np.float32)
            lo, hi = (
                engine._factor_range(full.shape[0]) if field in ('a', 'g')
                else engine._column_range(full.shape[0])
            )
            blocks[key] = torch.from_numpy(np.array(full[lo:hi])).to(dev)
        updates[field] = blocks
    if not isinstance(jax_state, Mapping):
        updates.update(_observability_from_jax(state, jax_state, dev, flight=True))
        js = getattr(jax_state, 'shadow', None)
        if state.shadow is not None and js is not None:
            fields = {}
            for field, ours in vars(state.shadow).items():
                if isinstance(ours, dict):
                    fields[field] = {}
                    for key in ours:
                        full = np.asarray(getattr(js, field)[key], np.float32)
                        lo, hi = engine._column_range(full.shape[0])
                        fields[field][key] = torch.from_numpy(np.array(full[lo:hi])).to(dev)
            updates['shadow'] = dataclasses.replace(
                state.shadow, progress=int(np.asarray(js.progress)),
                damping=float(np.asarray(js.damping)), **fields,
            )
        jef = getattr(jax_state, 'comp_ef', None)
        if state.comp_ef is not None and jef is not None:
            updates['comp_ef'] = {k: engine.ef_slice(k, np.asarray(jef[k])) for k in state.comp_ef}
    return dataclasses.replace(state, **updates)


def gather_dist_state(state: Any, engine: Any) -> dict[str, Any]:
    """The global stacks of a distributed state, as numpy on every rank
    (a collective: every rank calls it): ``{'step', 'inv_damping', 'a':
    {key: (L, d, d)}, 'g', 'qa', ...}`` in the JAX ``DistKFACState``'s
    layout. Factors are gathered from every rank's block; a decomposition
    from the first row's ranks (each holds its column's block)."""
    from kfac_tpu_torch.parallel import collectives

    out: dict[str, Any] = {'step': state.step, 'inv_damping': state.inv_damping}
    for field in _STATE_FIELDS:
        stacks = {}
        for key, local in getattr(state, field).items():
            if field in ('a', 'g'):
                full = engine._gather_blocks(local)
            else:
                full = collectives.all_gather_cat(local, engine.mesh.group)
                full = full[:local.shape[0] * engine.mesh.n_cols]
            stacks[key] = full.detach().cpu().numpy()
        out[field] = stacks
    return out


def local_params(params: Mapping[str, torch.Tensor], module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The entries of a whole model's ``state_dict`` that ``module`` holds:
    a model with expert-parallel blocks keeps its rank's experts (the JAX
    package's stacked experts, sharded over the expert axis, go to each
    rank's local ones)."""
    own = module.state_dict()
    missing = [k for k in own if k not in params]
    if missing:
        raise ValueError(f'the parameters lack {missing[:5]}')
    return {k: params[k] for k in own}


def _stage_slice(params: Mapping[str, Any], index: int) -> dict[str, torch.Tensor]:
    """Slice ``index`` of every leaf of the stage-stacked ``stages``, as a
    stage module's ``state_dict``."""
    sliced: dict[str, Any] = {}
    for path, value in _flatten(params['stages']):
        node = sliced
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value)[index]
    return from_flax_params(sliced)


def _replicated(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A pipelined LM's embedding, positions, ``ln_f`` and bias-free head."""
    out = from_flax_params({k: v for k, v in params.items() if k not in ('stages', 'head')})
    out['lm_head.weight'] = torch.from_numpy(np.array(np.asarray(params['head']['kernel']).T))
    return out


def from_flax_pipeline_params(params: Mapping[str, Any], stage: int) -> dict[str, torch.Tensor]:
    """A ``PipelinedLM``'s full ``state_dict`` for stage ``stage`` from the
    JAX ``PipelinedLM``'s params (numpy): the embedding, positions,
    ``ln_f`` and the head as they are, and the ``stage``-th slice of every
    leaf of the stage-stacked ``stages`` under ``stage.`` (load it before
    the stage is sharded: ``PipelinedLM(..., params=...)``)."""
    out = {f'stage.{k}': v for k, v in _stage_slice(params, stage).items()}
    out.update(_replicated(params))
    return out


def from_flax_interleaved_params(
    params: Mapping[str, Any], rank: int, p: int, v: int
) -> dict[str, torch.Tensor]:
    """An ``InterleavedPipelinedLM``'s full ``state_dict`` for pipe rank
    ``rank`` of ``p`` from the JAX ``InterleavedPipelinedLM``'s params
    (numpy): its chunk ``c`` (logical stage ``c * p + rank``) from the
    rank-major stack index ``logical_to_stack(p, v, c * p + rank)`` under
    ``stage.chunk{c}.``, and the replicated parameters as
    :func:`from_flax_pipeline_params` takes them."""
    from kfac_tpu_torch.parallel.interleaved_scan import logical_to_stack

    out = {}
    for c in range(v):
        index = logical_to_stack(p, v, c * p + rank)
        out.update({f'stage.chunk{c}.{k}': t for k, t in _stage_slice(params, index).items()})
    out.update(_replicated(params))
    return out


def from_jax_pipeline_state(jax_state: Mapping[str, Any], engine: Any) -> KFACState:
    """A ``PipelineKFAC``'s state for this rank's stage from the JAX
    engine's (numpy; every leaf stage-stacked): the factors and the
    decompositions (EIGEN: ``qa/qg/da/dg``; INVERSE: the inverses in the
    ``qa/qg`` slots) of ``engine.grid.stage``; over an
    ``InterleavedPipelinedLM``, of each of its chunks (``chunk{c}.``, the
    JAX stack index ``stage * v + c``; its layers ``chunk{c}/...``)."""
    stage = engine.grid.stage
    cfg = engine.config
    state = cfg.init()
    dev = cfg.device
    v = getattr(engine.model, 'virtual_chunks', None)

    def take(field, name, dtype):
        if v is None:
            return _tensor(np.asarray(jax_state[field][name])[stage], dtype, dev)
        # the interleaved model: chunk c's layer `chunk{c}/name` is the JAX
        # layer `name` at the rank-major stack index stage * v + c
        chunk, layer = name.split('/', 1)
        index = stage * v + int(chunk[len('chunk'):])
        return _tensor(np.asarray(jax_state[field][layer])[index], dtype, dev)

    names = list(engine.registry.layers)
    fields = {
        'a': {n: take('a', n, cfg.factor_dtype) for n in names},
        'g': {n: take('g', n, cfg.factor_dtype) for n in names},
    }
    if cfg.eigen:
        fields.update({f: {n: take(f, n, cfg.inv_dtype) for n in names} for f in ('qa', 'qg', 'da', 'dg')})
    else:
        fields['a_inv'] = {n: take('qa', n, cfg.inv_dtype) for n in names}
        fields['g_inv'] = {n: take('qg', n, cfg.inv_dtype) for n in names}
    return dataclasses.replace(state, step=int(np.asarray(jax_state['step'])), **fields)
