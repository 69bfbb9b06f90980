"""Sliced async refresh: the window's decompositions, one slice per step
(counterpart of ``kfac_tpu/async_inverse/sliced.py``).

Takes the place of the inverse cadence in the engine's ``step``, in three
stages on the host step counter, in the JAX package's order:

1. **swap** (``phase == 0``): a complete shadow (``progress >=
   n_slices``) is promoted into the active slots; with health, only for
   layers whose shadow is finite and not quarantined, chosen on the device
   by ``torch.where``. ``last_inv_step`` advances for the layers that
   swapped, and ``progress`` resets whether or not the swap ran.
2. **cold start** (``step == 0``): one synchronous ``update_inverses``, so
   the first window does not precondition with zero decompositions.
3. **slice** ``min(phase, n_slices)``: this phase's units are decomposed
   into the shadow from the current factors, by the functions the
   synchronous refresh calls at the damping it uses (``compute_eigh``,
   ``damped_inverse`` warm-started from the active inverse), so a swapped
   shadow is bit for bit the synchronous refresh one window back. Phases
   at or past ``n_slices`` do nothing.

Units are balanced by their n^3 cost: for the dense engine one per (side,
layer), or one per layer under fused prediv, where ``dgda`` needs both
sides' eigenvalues; for ``DistributedKFAC`` one per storage bucket (a pair
bucket under prediv), each rank decomposing its block and the column
gathering it into the shadow, as the synchronous refresh does. The
distributed swap's health verdicts travel in one ``all_reduce``.
A layer quarantined at the boundary keeps its active decompositions: its
shadow came from suspect factors. Its ``bad_inv`` counts up as a
quarantined synchronous refresh's would.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kfac_tpu_torch import enums
from kfac_tpu_torch import health as health_lib
from kfac_tpu_torch import tracing
from kfac_tpu_torch.async_inverse import slots as slots_lib
from kfac_tpu_torch.hyperparams import resolve
from kfac_tpu_torch.observability import metrics as metrics_lib
from kfac_tpu_torch.ops import factors as factors_lib


def decomp_fields(compute_method: enums.ComputeMethod, prediv: bool) -> tuple[str, ...]:
    """The state's decomposition fields a configuration uses."""
    if compute_method == enums.ComputeMethod.EIGEN:
        return ('qa', 'qg', 'dgda') if prediv else ('qa', 'qg', 'da', 'dg')
    return ('a_inv', 'g_inv')


def _fields(engine) -> tuple[str, ...]:
    return decomp_fields(engine.compute_method, engine.prediv_eigenvalues)


def dense_units(engine) -> list[tuple[tuple[str, str], float]]:
    """``[((side, layer), n^3 cost)]``: sides ``'a'`` and ``'g'`` apart, or
    ``'ag'`` under fused prediv."""
    fused = engine.eigen and engine.prediv_eigenvalues
    units: list[tuple[tuple[str, str], float]] = []
    for name, h in engine.registry.layers.items():
        na = float(h.a_factor_shape[0]) ** 3
        ng = float(h.g_factor_shape[0]) ** 3
        if fused:
            units.append((('ag', name), na + ng))
        else:
            units += [(('a', name), na), (('g', name), ng)]
    return units


def dense_shadow(engine, state) -> slots_lib.ShadowSlots:
    """A zeroed shadow mirroring the state's decomposition slots."""
    return slots_lib.empty_shadow({f: getattr(state, f) for f in _fields(engine)})


def dense_swap_core(engine, state, cand: dict[str, dict[str, torch.Tensor]], complete: bool):
    """Promote the candidate decompositions ``cand`` (field -> layer ->
    tensor) into the active slots when ``complete``; else return ``state``.

    A layer's fields swap together. With health, a layer swaps where all
    its candidates are finite and it is not quarantined (a ``torch.where``
    each, nothing read on the host), and ``bad_inv`` takes the inversion
    transition. ``last_inv_step`` advances for the layers that swapped.
    Shared by the sliced swap and the host backend's apply.
    """
    if not complete:
        return state
    fields = _fields(engine)
    names = list(engine.registry.layers)
    cfg = engine.health
    swapped = None  # every layer, when health is off
    if cfg is None:
        updates = {f: {n: cand[f][n] for n in names} for f in fields}
    else:
        h = state.health
        ok = torch.stack([
            torch.stack([torch.isfinite(cand[f][n]).all() for f in fields]).all()
            for n in names
        ])
        swapped = ok & (h.quarantined <= 0)
        updates = {
            f: {n: torch.where(swapped[i], cand[f][n], getattr(state, f)[n])
                for i, n in enumerate(names)}
            for f in fields
        }
        updates['health'] = dataclasses.replace(
            h, bad_inv=health_lib.inversion_update(cfg, ok, h.quarantined, h.bad_inv)
        )
    if engine.metrics is not None and state.metrics is not None:
        ms = state.metrics
        updates['metrics'] = dataclasses.replace(
            ms, last_inv_step=metrics_lib.advance_all(ms.last_inv_step, swapped, state.step)
        )
    return dataclasses.replace(state, **updates)


def _dense_swap(engine, state):
    sh = state.shadow
    state = dense_swap_core(
        engine, state, {f: getattr(sh, f) for f in _fields(engine)},
        sh.progress >= engine._async_n_slices,
    )
    # every unit is recomputed each window, whether or not this swap ran
    return dataclasses.replace(state, shadow=dataclasses.replace(state.shadow, progress=0))


def _dense_slice(engine, state, units: list[tuple[str, str]]):
    """Decompose one slice's units into the shadow from the current
    factors."""
    sh = state.shadow
    damping = resolve(engine.damping, state.step)
    eff = engine._effective_damping(state, damping)
    index = {n: i for i, n in enumerate(engine.registry.layers)}
    upd = {f: dict(getattr(sh, f)) for f in _fields(engine)}
    for side, name in units:
        i = index[name]
        if engine.eigen:
            if side in ('a', 'ag'):
                adec = factors_lib.compute_eigh(state.a[name], engine.eigh_impl)
                upd['qa'][name] = adec.q
                if not engine.prediv_eigenvalues:
                    upd['da'][name] = adec.d
            if side in ('g', 'ag'):
                gdec = factors_lib.compute_eigh(state.g[name], engine.eigh_impl)
                upd['qg'][name] = gdec.q
                if not engine.prediv_eigenvalues:
                    upd['dg'][name] = gdec.d
            if side == 'ag':
                upd['dgda'][name] = factors_lib.prediv_eigenvalues(adec, gdec, eff[i])
        else:
            # warm-started from the active inverse, as the JAX package does
            key, factor, x0 = (
                ('a_inv', state.a[name], state.a_inv[name]) if side == 'a'
                else ('g_inv', state.g[name], state.g_inv[name])
            )
            upd[key][name] = factors_lib.damped_inverse(
                factor, eff[i], engine.inverse_solver, engine.newton_schulz_iters, x0=x0,
            )
    return dataclasses.replace(state, shadow=dataclasses.replace(
        sh, progress=sh.progress + 1, damping=damping, **upd,
    ))


@tracing.scope('kfac.async_refresh')
def dense_async_step(engine, state: Any):
    """The sliced dispatcher in place of the inverse cadence (see the
    module's docstring for its three stages)."""
    phase = state.step % engine._async_n_steps
    if phase == 0:
        state = _dense_swap(engine, state)
    if state.step == 0:
        state = engine.update_inverses(state)
    if phase < engine._async_n_slices:
        state = _dense_slice(engine, state, engine._async_slices[phase])
    return state


# --------------------------------------------------------------- distributed


def _kaisa_fields(engine) -> tuple[str, ...]:
    return decomp_fields(engine.config.compute_method, engine._prediv)


def kaisa_units(engine) -> list[tuple[tuple[str, str], float]]:
    """The distributed engine's units: one storage bucket's batched
    decomposition, ``(side, key)``, or a pair bucket's, ``('ag', key)``,
    under fused prediv; the cost is the stack's n^3 over its padded slots,
    as in the JAX package."""
    if engine._prediv:
        return [
            (('ag', b.key), b.padded * (float(b.da) ** 3 + float(b.dg) ** 3))
            for b in engine.buckets
        ]
    return [
        ((side, sb.key), sb.padded * float(sb.d) ** 3)
        for side, store in (('a', engine.a_store), ('g', engine.g_store)) for sb in store
    ]


def kaisa_shadow(engine, state) -> slots_lib.ShadowSlots:
    """A zeroed shadow mirroring the resident (column) stacks."""
    return slots_lib.empty_shadow({f: getattr(state, f) for f in _kaisa_fields(engine)})


def kaisa_swap_core(engine, state, cand, cand_damping: float, complete: bool):
    """Promote column-resident candidate stacks ``cand`` (field -> store
    key -> tensor) into the active slots when ``complete``; ``inv_damping``
    becomes ``cand_damping``.

    Without health every slot swaps. With health a layer swaps where its
    A and G candidates (and its fused grid under prediv) are finite and it
    is not quarantined: each rank judges the slots of its own factor
    block within its column's candidates, the verdicts reach every rank in
    one zeros-elsewhere ``all_reduce`` (``_exchange``), and each store takes
    its per-slot mask by ``torch.where``, nothing read on the host.
    ``bad_inv`` takes the inversion transition and ``last_inv_step``
    advances for the layers that swapped. Shared by the sliced swap and
    the host backend's apply; every rank calls it alike.
    """
    if not complete:
        return state
    hc = engine.health
    fields = _kaisa_fields(engine)
    updates: dict[str, Any] = {}
    swapped = None  # every layer, when health is off
    if hc is None:
        updates = {f: dict(cand[f]) for f in fields}
    else:
        n = len(engine.registry.layers)
        sub = engine.mesh.row
        parts = []
        for side, store in (('a', engine.a_store), ('g', engine.g_store)):
            side_fields = [f for f in fields if f in ('q' + side, 'd' + side, side + '_inv')]
            if side == 'a' and 'dgda' in fields:
                side_fields.append('dgda')
            for sb in store:
                lo, hi = engine._factor_range(sb.padded)
                per = hi - lo
                ok = torch.stack([
                    torch.isfinite(cand[f][sb.key][sub * per:(sub + 1) * per]).flatten(1).all(dim=1)
                    for f in side_fields
                ]).all(dim=0)
                parts.append((0 if side == 'a' else n, side, sb, ~ok))
        bad = engine._exchange(parts, 2 * n)
        ok = (bad[:n] + bad[n:]) == 0
        h = state.health
        swapped = ok & (h.quarantined <= 0)
        for f in fields:
            side = 'g' if f in ('qg', 'dg', 'g_inv') else 'a'
            updates[f] = {}
            for key, c in cand[f].items():
                sb = engine._stores[side, key]
                lo, hi = engine._column_range(sb.padded)
                mask = health_lib.slot_mask(swapped, engine._index[side, key], sb.padded)[lo:hi]
                updates[f][key] = torch.where(
                    mask.view((-1,) + (1,) * (c.ndim - 1)), c, getattr(state, f)[key]
                )
        updates['health'] = dataclasses.replace(
            h, bad_inv=health_lib.inversion_update(hc, ok, h.quarantined, h.bad_inv)
        )
    if engine.metrics is not None and state.metrics is not None:
        ms = state.metrics
        updates['metrics'] = dataclasses.replace(
            ms, last_inv_step=metrics_lib.advance_all(ms.last_inv_step, swapped, state.step)
        )
    return dataclasses.replace(state, **updates, inv_damping=cand_damping)


def _kaisa_swap(engine, state):
    sh = state.shadow
    state = kaisa_swap_core(
        engine, state, {f: getattr(sh, f) for f in _kaisa_fields(engine)},
        sh.damping, sh.progress >= engine._async_n_slices,
    )
    return dataclasses.replace(state, shadow=dataclasses.replace(state.shadow, progress=0))


def _kaisa_slice(engine, state, units: list[tuple[str, str]]):
    """Refresh one slice's storage buckets into the shadow from the
    current factors, with the synchronous refresh's own code
    (:meth:`DistributedKFAC.refresh_units`: this rank's block, then the
    column's all-gather), so a swapped shadow is that refresh one window
    back, bit for bit."""
    sh = state.shadow
    damping = float(resolve(engine.config.damping, state.step))
    upd = {f: dict(getattr(sh, f)) for f in _kaisa_fields(engine)}
    for f, stacks in engine.refresh_units(state, units, damping).items():
        upd[f].update(stacks)
    return dataclasses.replace(state, shadow=dataclasses.replace(
        sh, progress=sh.progress + 1, damping=damping, **upd,
    ))


@tracing.scope('dist_kfac.async_refresh')
def kaisa_async_step(engine, state: Any):
    """The distributed engine's sliced dispatcher: the dense one's three
    stages on the host step counter, so every rank takes the same branch
    and enters the same collectives."""
    phase = state.step % engine._async_n_steps
    if phase == 0:
        state = _kaisa_swap(engine, state)
    if state.step == 0:
        state = engine.update_inverses(state)
    if phase < engine._async_n_slices:
        state = _kaisa_slice(engine, state, engine._async_slices[phase])
    return state
