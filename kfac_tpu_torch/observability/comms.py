"""Comms and padding accounting of the distributed engine (counterpart of
``kfac_tpu/observability/comms.py``).

Every number is derived on the host from the engine's static layout
(size-class buckets, stores, transport configuration, strategy), the
flows its step runs:

- the factor stat transport (each capture step): one all-reduce per
  captured factor (``ALLREDUCE``) or byte-capped flat buffers of packed
  upper triangles (``ALLREDUCE_BUCKETED``), with the chunk plan;
- the decomposition reshard (each refresh): the inverse broadcast within
  each column of the grid;
- the gradient broadcast (each step): the preconditioned stacks shared
  within each row;
- the padding of each store: true-dim content, identity padding inside
  the class dims, and whole slots rounding a stack to the world.

Bytes are global logical bytes a flow moves per occurrence, as in the JAX
package: factors (the stat transport, the padding, a spill) at the
engine's ``factor_dtype``, decompositions and preconditioned stacks (the
reshard, the gradient broadcast) at its ``inv_dtype``. With
``stat_compression`` the stat transport's ``wire_bytes`` is the quantized
payload and its f32 scales (the JAX package's static figure), and
``collectives`` lists what the port's compressed transport runs per chunk
(a reduce-scatter of the f32 partials, all-gathers of the payload and the
scales) with their buffer bytes beside the f32 all-reduce's. With
``offload`` its entry is the plan (knobs and the bytes a spill moves), to
which the engine's ``comms_report()`` adds the live counters.
"""

from __future__ import annotations

from typing import Any

import torch

from kfac_tpu_torch import enums
from kfac_tpu_torch.compression import quant as quant_lib
from kfac_tpu_torch.parallel import collectives

F32_BYTES = 4


def _itemsize(dtype: torch.dtype) -> int:
    return dtype.itemsize


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix('torch.')


def padding_report(engine: Any) -> dict[str, dict[str, Any]]:
    """Resident against padding bytes of each A and G store, keyed
    ``'a/<key>'`` / ``'g/<key>'``."""
    item = _itemsize(engine.config.factor_dtype)
    out: dict[str, dict[str, Any]] = {}
    for side, store in (('a', engine.a_store), ('g', engine.g_store)):
        for sb in store:
            resident = sum(d * d for d in sb.dims) * item
            layer_slots = len(sb.layers) * sb.d * sb.d * item
            total = sb.padded * sb.d * sb.d * item
            out[f'{side}/{sb.key}'] = {
                'layers': len(sb.layers),
                'slots': sb.padded,
                'class_dim': sb.d,
                'resident_bytes': resident,
                'identity_pad_bytes': layer_slots - resident,
                'slot_pad_bytes': total - layer_slots,
                'total_bytes': total,
                'fill': resident / total if total else 1.0,
            }
    return out


def transport_report(engine: Any) -> dict[str, Any]:
    """Bytes of the factor stat transport on a capture step: true-dim
    dense bytes, one collective a factor (``ALLREDUCE``), or the upper
    triangles of every class-dim row in capped buffers
    (``ALLREDUCE_BUCKETED``; ``savings`` against shipping them dense)."""
    cfg = engine.config
    stores = (engine.a_store, engine.g_store)
    item = _itemsize(cfg.factor_dtype)
    if cfg.allreduce_method != enums.AllreduceMethod.ALLREDUCE_BUCKETED:
        dense = sum(d * d for store in stores for sb in store for d in sb.dims) * item
        return {
            'method': 'ALLREDUCE',
            'collectives': sum(len(sb.layers) for store in stores for sb in store),
            'bytes': dense,
            'raw_bytes': dense,
            'wire_bytes': dense,
            'wire_dtype': _name(cfg.factor_dtype),
            'dense_bytes': dense,
            'savings': 0.0,
            'compression': None,
            'chunks': [],
        }
    specs = [
        (sb.d * (sb.d + 1) // 2, cfg.factor_dtype)
        for store in stores for sb in store for _ in sb.layers
    ]
    cap = cfg.allreduce_bucket_cap_mb
    ccfg = cfg.stat_compression
    chunks = []
    for c in collectives.plan_chunks(specs, max_bytes=None if cap is None else cap * 1e6):
        entry = dict(c, raw_bytes=c['bytes'])
        if ccfg is None:
            entry.update(wire_bytes=c['bytes'], wire_dtype=c['dtype'])
        else:
            wb = quant_lib.wire_bytes(c['elements'], ccfg.dtype, ccfg.block_size)
            entry.update(wb, wire_dtype=ccfg.dtype, bytes=wb['wire_bytes'])
        chunks.append(entry)
    raw = sum(c['raw_bytes'] for c in chunks)
    wire = sum(c['wire_bytes'] for c in chunks)
    dense = sum(sb.d * sb.d * len(sb.layers) for store in stores for sb in store) * item
    out = {
        'method': 'ALLREDUCE_BUCKETED',
        'collectives': len(chunks),
        'bytes': wire,
        'raw_bytes': raw,
        'wire_bytes': wire,
        'wire_dtype': _name(cfg.factor_dtype) if ccfg is None else ccfg.dtype,
        'dense_bytes': dense,
        'savings': 1.0 - wire / dense if dense else 0.0,
        'compression': None if ccfg is None else {
            'dtype': ccfg.dtype,
            'block_size': ccfg.block_size,
            'error_feedback': ccfg.error_feedback,
            'ratio': raw / wire if wire else 1.0,
        },
        'chunks': chunks,
    }
    if ccfg is not None:
        # the JAX package's keys above; what the port's collectives move
        out['port_collectives'] = port_collectives(engine)
    return out


def port_collectives(engine: Any) -> dict[str, Any]:
    """The collectives the port's compressed stat transport runs on a
    capture step with more than one rank, per chunk: a ``reduce_scatter``
    of the f32 chunk padded to ``world * block_size``, an ``all_gather``
    of the one-byte payload and one of the f32 scales, each with its
    buffer's bytes. ``buffer_bytes`` sums them; ``f32_all_reduce_bytes``
    is the f32 all-reduce of the same rows, the uncompressed transport."""
    ccfg = engine.config.stat_compression
    ops = []
    for c in engine._comp_plan if engine.world > 1 else ():
        ops += [
            {'op': 'reduce_scatter', 'dtype': 'float32', 'bytes': c['padded'] * F32_BYTES},
            {'op': 'all_gather', 'dtype': ccfg.dtype, 'bytes': c['padded']},
            {'op': 'all_gather', 'dtype': 'float32',
             'bytes': c['padded'] // ccfg.block_size * F32_BYTES},
        ]
    return {
        'ops': ops,
        'buffer_bytes': sum(o['bytes'] for o in ops),
        'f32_all_reduce_bytes': sum(c['elements'] for c in engine._comp_plan) * F32_BYTES,
    }


def grad_broadcast_bytes(engine: Any) -> int:
    """Bytes of the per-step gradient broadcast: every pair bucket's
    (padded, dg, da) preconditioned stack, at ``inv_dtype``."""
    return sum(b.padded * b.dg * b.da for b in engine.buckets) * _itemsize(engine.config.inv_dtype)


def decomp_reshard_bytes(engine: Any) -> int:
    """Bytes of the refresh's decomposition reshard: eigenvector stacks and
    eigenvalues (EIGEN), eigenvector stacks and fused eigenvalue grids
    (prediv), or inverse stacks (INVERSE), at ``inv_dtype``."""
    stores = (engine.a_store, engine.g_store)
    total = sum(sb.padded * sb.d * sb.d for store in stores for sb in store)
    if engine._prediv:
        total += sum(b.padded * b.dg * b.da for b in engine.buckets)
    elif engine._eigen:
        total += sum(sb.padded * sb.d for store in stores for sb in store)
    return total * _itemsize(engine.config.inv_dtype)


def comms_summary(engine: Any) -> dict[str, Any]:
    """The comms and padding accounting of a ``DistributedKFAC``, the keys
    of the JAX package's."""
    padding = padding_report(engine)
    ocfg = engine.config.offload
    offload = None if ocfg is None else {
        'min_cold_steps': int(ocfg.min_cold_steps),
        'prefetch_lead': int(ocfg.prefetch_lead),
        # the factor stacks' global bytes a spill moves to the host
        'spill_bytes': sum(
            sb.padded * sb.d * sb.d * _itemsize(engine.config.factor_dtype)
            for store in (engine.a_store, engine.g_store) for sb in store
        ),
    }
    return {
        'strategy': engine.strategy.name,
        'grad_worker_fraction': engine.grad_workers / engine.world,
        'devices': engine.total_devices,
        'grad_workers': engine.grad_workers,
        'n_cols': engine.mesh.n_cols,
        'stat_transport': transport_report(engine),
        'grad_broadcast_bytes': grad_broadcast_bytes(engine),
        'decomp_reshard_bytes': decomp_reshard_bytes(engine),
        'offload': offload,
        'padding': padding,
        'padding_totals': {
            key: sum(p[key] for p in padding.values())
            for key in ('resident_bytes', 'identity_pad_bytes', 'slot_pad_bytes')
        },
    }
