"""Per-layer metrics: state, schema and host-side collector (counterpart of
``kfac_tpu/observability/metrics.py``).

The engine carries a :class:`MetricsState` in its state: per-layer scalars
(gradient and preconditioned-gradient norms, effective damping, Gershgorin
eigenvalue bounds of the factors, factor and inverse staleness in steps)
computed inside the step with no host sync, drained whenever the user
likes by :class:`MetricsCollector` in one copy from the device.

The schema (:func:`metric_keys`) is the JAX package's key for key, and the
state its packed layout: one f32 vector of every scalar and one int32
vector per step tracker. A family of per-layer keys sits at a fixed index
vector, built on the device once by :func:`init_metrics`, so a step writes
a family with one ``index_copy`` and no copy from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from kfac_tpu_torch.ops import factors as factors_lib

FAMILIES = (
    'grad_norm', 'precond_grad_norm', 'damping_eff',
    'factor_lmin/a', 'factor_lmax/a', 'factor_lmin/g', 'factor_lmax/g',
    'factor_staleness', 'inv_staleness',
)


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Which per-layer scalar families to record (all cheap; the toggles
    shrink the drained record)."""

    grad_norms: bool = True
    factor_bounds: bool = True
    staleness: bool = True

    def __post_init__(self) -> None:
        if not (self.grad_norms or self.factor_bounds or self.staleness):
            raise ValueError(
                'MetricsConfig with every family disabled records nothing; '
                'pass metrics=None/False to the engine instead')


@dataclasses.dataclass(frozen=True)
class MetricsState:
    """Telemetry riding in the engine state: three device buffers.

    ``last_factor_step`` / ``last_inv_step``: (L,) int32, per layer in
    ``names`` order, the engine step at which a factor / inverse update was
    last accepted (a health rollback does not advance it). ``scalars``:
    (n_keys,) f32 in ``keys`` order. ``index``: each family's (L,) int64
    positions in ``scalars`` (``'kl_clip_scale'``: one), on the device.
    """

    names: tuple[str, ...]
    keys: tuple[str, ...]
    last_factor_step: torch.Tensor
    last_inv_step: torch.Tensor
    scalars: torch.Tensor
    index: Mapping[str, torch.Tensor] = dataclasses.field(repr=False, compare=False)

    def as_dict(self) -> dict[str, torch.Tensor]:
        """The scalar vector as ``{key: 0-d tensor}``."""
        return {k: self.scalars[i] for i, k in enumerate(self.keys)}


def metric_keys(config: MetricsConfig, names: list[str]) -> list[str]:
    """The order-stable scalar key schema for the layer ``names``."""
    keys = ['kl_clip_scale']
    for n in names:
        if config.grad_norms:
            keys.append(f'grad_norm/{n}')
            keys.append(f'precond_grad_norm/{n}')
        keys.append(f'damping_eff/{n}')
        if config.factor_bounds:
            keys.append(f'factor_lmin/a/{n}')
            keys.append(f'factor_lmax/a/{n}')
            keys.append(f'factor_lmin/g/{n}')
            keys.append(f'factor_lmax/g/{n}')
        if config.staleness:
            keys.append(f'factor_staleness/{n}')
            keys.append(f'inv_staleness/{n}')
    return keys


def init_metrics(
    config: MetricsConfig, names: list[str], device: str | torch.device = 'cuda'
) -> MetricsState:
    """Zeros for every key but ``kl_clip_scale``, which starts at 1 (no
    rescaling), on ``device``; the families' index vectors built there."""
    names = tuple(names)
    keys = tuple(metric_keys(config, list(names)))
    position = {k: i for i, k in enumerate(keys)}
    scalars = torch.zeros((len(keys),), dtype=torch.float32, device=device)
    scalars[position['kl_clip_scale']].fill_(1.0)
    index = {'kl_clip_scale': torch.tensor([position['kl_clip_scale']], device=device)}
    for family in FAMILIES:
        if names and f'{family}/{names[0]}' in position:
            index[family] = torch.tensor(
                [position[f'{family}/{n}'] for n in names], device=device
            )
    return MetricsState(
        names=names,
        keys=keys,
        last_factor_step=torch.zeros((len(names),), dtype=torch.int32, device=device),
        last_inv_step=torch.zeros((len(names),), dtype=torch.int32, device=device),
        scalars=scalars,
        index=index,
    )


def set_families(
    ms: MetricsState, values: Mapping[str, torch.Tensor]
) -> MetricsState:
    """Write each family's value vector ((L,), or (1,) for
    ``'kl_clip_scale'``, in ``names`` order) into the scalars: one
    ``index_copy``, nothing read or copied from the host."""
    if not values:
        return ms
    idx = torch.cat([ms.index[f] for f in values])
    vals = torch.cat([v.reshape(-1).float() for v in values.values()])
    return dataclasses.replace(ms, scalars=ms.scalars.index_copy(0, idx, vals))


def update_scalars(
    ms: MetricsState, updates: Mapping[str, torch.Tensor | float]
) -> MetricsState:
    """Scatter ``{key: value}`` into the packed scalar vector, for any keys
    of the schema (their positions go to the device with the values; the
    engine writes whole families with :func:`set_families` instead)."""
    if not updates:
        return ms
    position = {k: i for i, k in enumerate(ms.keys)}
    dev = ms.scalars.device
    idx = torch.tensor([position[k] for k in updates], device=dev)
    vals = torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
        for v in updates.values()
    ])
    return dataclasses.replace(ms, scalars=ms.scalars.index_copy(0, idx, vals))


def advance_last(
    last: torch.Tensor,
    names: tuple[str, ...],
    touched: Mapping[str, torch.Tensor | None],
    step: int,
) -> torch.Tensor:
    """Advance the last-accepted-step entries of the ``touched`` layers:
    ``touched[name]`` None advances unconditionally (health off), a bool
    tensor gates it (a rolled-back update keeps the old step)."""
    new = last.clone()
    for i, n in enumerate(names):
        if n not in touched:
            continue
        acc = touched[n]
        if acc is None:
            new[i].fill_(step)
        else:
            new[i].copy_(torch.where(acc, step, last[i]))
    return new


def advance_all(
    last: torch.Tensor, accepted: torch.Tensor | None, step: int
) -> torch.Tensor:
    """:func:`advance_last` with every layer touched: ``accepted`` an (L,)
    bool vector (or None, every layer accepted), one launch."""
    if accepted is None:
        return torch.full_like(last, step)
    return torch.where(accepted, torch.full_like(last, step), last)


def _gershgorin_each(factor: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lmin, lmax)`` of each trailing (d, d) matrix."""
    f32 = factor.float()
    absrow = torch.sum(torch.abs(f32), dim=-1)
    diag = torch.diagonal(f32, dim1=-2, dim2=-1)
    lmax = torch.amax(absrow, dim=-1)
    lmin = torch.amin(diag - (absrow - torch.abs(diag)), dim=-1)
    return lmin, lmax


def gershgorin_bounds(factor: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gershgorin eigenvalue bounds of a symmetric factor (or the whole of a
    stack): ``lmax = max_i sum_j |a_ij|`` and ``lmin = min_i (a_ii -
    sum_{j != i} |a_ij|)``, f32. A bound, not an estimate: ``lmin`` may be
    negative for a positive spectrum."""
    lmin, lmax = _gershgorin_each(factor)
    if lmax.ndim:
        lmax = torch.amax(lmax)
        lmin = torch.amin(lmin)
    return lmin, lmax


def gershgorin_bounds_each(
    factors: list[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gershgorin_bounds` of every factor of ``factors``, ``(lmin,
    lmax)`` each (len(factors),): the factors of one shape stacked and
    bounded together, a few launches a shape rather than a few a factor."""
    lmins, lmaxs = [None] * len(factors), [None] * len(factors)
    for idx, stack in factors_lib.stacked_by_shape(factors):
        lmin, lmax = _gershgorin_each(stack)
        for k, lo, hi in zip(idx, lmin.unbind(), lmax.unbind()):
            lmins[k], lmaxs[k] = lo, hi
    return torch.stack(lmins), torch.stack(lmaxs)


def finalize(ms: MetricsState, config: MetricsConfig, step: int) -> MetricsState:
    """Staleness of the step ending at ``step``, in steps since the
    curvature was last accepted (0 for an update accepted this step)."""
    if not config.staleness:
        return ms
    return set_families(ms, {
        'factor_staleness': step - ms.last_factor_step,
        'inv_staleness': step - ms.last_inv_step,
    })


class MetricsCollector:
    """Host-side drain: one ``drain(state)`` copies the step's scalars from
    the device once and folds in the host families, the health counters
    (``include_health``) and the tracing table as ``time/*`` keys
    (``include_trace``, over the last ``trace_max_history`` calls)."""

    def __init__(
        self,
        include_health: bool = True,
        include_trace: bool = False,
        trace_max_history: int | None = 256,
    ) -> None:
        self.include_health = include_health
        self.include_trace = include_trace
        self.trace_max_history = trace_max_history

    def drain(self, state: Any) -> dict[str, Any]:
        """A flat JSON-ready record of an engine state or a Trainer's
        ``TrainState``: ``step``, every metric key, then ``health/*`` and
        ``time/*``; ``{}`` when nothing applies."""
        from kfac_tpu_torch import tracing

        kstate = getattr(state, 'kfac_state', state)
        record: dict[str, Any] = {}
        metrics = getattr(kstate, 'metrics', None)
        if metrics is not None:
            record['step'] = int(kstate.step)
            values = metrics.scalars.cpu().tolist()  # the one copy
            record.update(zip(metrics.keys, values))
        if self.include_health:
            record.update(tracing.health_counters(kstate))
        if self.include_trace:
            trace = tracing.get_trace(average=True, max_history=self.trace_max_history)
            for key, seconds in trace.items():
                record[f'time/{key}'] = seconds
        return record
