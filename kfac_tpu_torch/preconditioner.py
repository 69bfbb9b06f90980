"""K-FAC preconditioner over a layer registry (counterpart of
``kfac_tpu/preconditioner.py``, dense engine).

The state is an explicit :class:`KFACState`, as in the JAX package, and
``step`` returns a new one. The step counter is a host integer, so the
factor and inverse cadence is a Python ``if`` where JAX traces a
``lax.cond``. Gradients are dicts keyed by ``model.named_parameters()``
names; unregistered parameters pass through unchanged.

The numerical-health sentinel (``health``), the per-layer metrics
(``metrics``) and the flight recorder (``flight``) ride in the state as the
JAX engine's do, and none of them reads a device value on the host. The
per-layer gradient norms come from the norm instantiation of the grouped
kl-clip dot kernel, in its one read of every layer's p and g.

The async inverse refresh (``async_inverse``) double-buffers the
decompositions in a ``shadow`` slot, refreshed in per-step slices
(``'sliced'``) or by a host worker thread (``'host'``); see
:mod:`kfac_tpu_torch.async_inverse`.

The cold-factor offload (``offload``) spills the factors to host memory
between cadence boundaries (:mod:`kfac_tpu_torch.compression.offload`);
``stat_compression`` is validated here and read by
:class:`~kfac_tpu_torch.parallel.DistributedKFAC`. The compile watch of
the JAX engine raises ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from kfac_tpu_torch import enums
from kfac_tpu_torch import health as health_lib
from kfac_tpu_torch.async_inverse import config as async_config_lib
from kfac_tpu_torch.async_inverse import host as async_host
from kfac_tpu_torch.async_inverse import sliced as async_sliced
from kfac_tpu_torch.async_inverse import slots as async_slots
from kfac_tpu_torch.compression import config as compression_config_lib
from kfac_tpu_torch.compression import offload as offload_lib
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.hyperparams import ScalarOrSchedule, resolve
from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.observability import flight_recorder as flight_lib
from kfac_tpu_torch.observability import metrics as metrics_lib
from kfac_tpu_torch.ops import factors as factors_lib
from kfac_tpu_torch.ops import klclip


def default_compute_method(
    platform: str | None = None,
) -> tuple[enums.ComputeMethod, str]:
    """Platform-appropriate ``(compute_method, inverse_solver)`` defaults:
    ``'tpu'`` -> (INVERSE, ``'newton_schulz'``); ``'cuda'`` and anything
    else -> (EIGEN, ``'cholesky'``), the JAX package's off-TPU branch."""
    if platform == 'tpu':
        return enums.ComputeMethod.INVERSE, 'newton_schulz'
    return enums.ComputeMethod.EIGEN, 'cholesky'


@dataclasses.dataclass
class KFACState:
    """All K-FAC second-order state.

    ``a``/``g``: EMA Kronecker factors; ``qa``/``qg``/``da``/``dg``:
    eigendecompositions (EIGEN); ``dgda``: fused ``1/(dg (x) da +
    damping)`` with prediv; ``a_inv``/``g_inv``: explicit inverses
    (INVERSE). Unused slots hold empty dicts. ``health``, ``metrics`` and
    ``flight``: the sentinel's counters, the per-layer metrics and the
    flight recorder's ring when the engine has them on, else None.
    ``shadow``: the :class:`~kfac_tpu_torch.async_inverse.ShadowSlots` of
    ``async_inverse='sliced'``, else None (the host mode's double buffer
    is its worker's payload). It is ephemeral: a restore rematerializes
    the active decompositions and resets it.
    """

    step: int
    a: dict[str, torch.Tensor]
    g: dict[str, torch.Tensor]
    qa: dict[str, torch.Tensor]
    qg: dict[str, torch.Tensor]
    da: dict[str, torch.Tensor]
    dg: dict[str, torch.Tensor]
    dgda: dict[str, torch.Tensor]
    a_inv: dict[str, torch.Tensor]
    g_inv: dict[str, torch.Tensor]
    health: health_lib.HealthState | None = None
    metrics: metrics_lib.MetricsState | None = None
    flight: flight_lib.FlightRecorderState | None = None
    shadow: async_slots.ShadowSlots | None = None


_LATER_SLICE_KNOBS = ('compile_watch',)
# the dtypes the engines store factors and decompositions in
STORE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass
class KFACPreconditioner:
    """Configuration and step functions for K-FAC preconditioning.

    Args mirror the JAX engine's: ``factor_update_steps`` and
    ``inv_update_steps`` (int or schedule of the step), ``damping``,
    ``factor_decay`` (EMA alpha), ``kl_clip`` (None disables), ``lr`` (for
    the kl-clip scale), ``compute_method`` (None picks
    :func:`default_compute_method` for ``device``), ``inverse_solver``
    (``'cholesky'``, ``'newton_schulz'`` or ``'auto'``, for INVERSE),
    ``newton_schulz_iters`` (the iteration cap), ``eigh_impl`` (the EIGEN
    decomposition: ``'device'``, ``'host'`` or ``'eig_host'``, see
    :func:`~kfac_tpu_torch.ops.factors.batched_eigh`),
    ``prediv_eigenvalues``. ``factor_dtype`` and ``inv_dtype`` (f32, bf16
    or f16) are the dtypes the factors and the decompositions or inverses
    are stored in, as the JAX engine's: the EMA's result is pinned to
    ``factor_dtype``, decompositions run in f32 and are cast to
    ``inv_dtype``, and the preconditioning runs in ``inv_dtype`` and returns
    each grad in its own dtype; a half-precision store with
    ``async_inverse``, ``offload`` or ``stat_compression`` is not ported
    yet (raises).
    ``health``: a :class:`~kfac_tpu_torch.health.HealthConfig` (True for its
    defaults). ``metrics``: a :class:`~kfac_tpu_torch.observability.
    metrics.MetricsConfig` (True for its defaults). ``flight``: a
    :class:`~kfac_tpu_torch.observability.flight_recorder.
    FlightRecorderConfig`, True, or an int capacity; it turns ``metrics``
    on. ``async_inverse``: an :class:`~kfac_tpu_torch.async_inverse.
    AsyncInverseConfig`, a mode (``'sliced'`` or ``'host'``), or True
    (``'sliced'``); it needs an int ``inv_update_steps``. ``mask``: a
    trainability mask over module paths whose frozen layers are dropped
    from the registry (:func:`~kfac_tpu_torch.layers.registry.
    masked_registry`). ``device`` is where the state lives, ``'cuda'``
    unless the caller passes another.

    Read only by :class:`~kfac_tpu_torch.parallel.DistributedKFAC`:
    ``bucket_granularity`` (the size classes of its factor stacks; None
    resolves to 1, exact dims, as the JAX package resolves it off a TPU),
    ``colocate_factors`` (a layer's A and G in one slot), and the stat
    transport's ``allreduce_method`` and ``allreduce_bucket_cap_mb`` (the
    byte cap of each packed buffer, in MB; None for one buffer).
    """

    registry: registry_lib.Registry
    factor_update_steps: int | Callable[[int], int] = 1
    inv_update_steps: int | Callable[[int], int] = 1
    damping: ScalarOrSchedule = 0.001
    factor_decay: ScalarOrSchedule = 0.95
    kl_clip: ScalarOrSchedule | None = 0.001
    lr: ScalarOrSchedule = 0.1
    compute_method: enums.ComputeMethod | str | None = None
    inverse_solver: str | None = None
    newton_schulz_iters: int = 40
    eigh_impl: str = 'device'
    prediv_eigenvalues: bool = False
    factor_dtype: torch.dtype = torch.float32
    inv_dtype: torch.dtype = torch.float32
    device: str | torch.device = 'cuda'
    health: Any = None
    metrics: Any = None
    flight: Any = None
    async_inverse: Any = None
    offload: Any = None
    stat_compression: Any = None
    compile_watch: Any = None
    mask: Any = None
    bucket_granularity: int | None = None
    colocate_factors: bool = True
    allreduce_method: enums.AllreduceMethod | str = enums.AllreduceMethod.ALLREDUCE
    allreduce_bucket_cap_mb: float | None = 25.0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        for knob in _LATER_SLICE_KNOBS:
            if getattr(self, knob) not in (None, False):
                raise NotImplementedError(
                    f'{knob} is not ported to kfac_tpu_torch yet'
                )
        if self.mask is not None:
            # every consumer of the registry sees only trainable layers
            self.registry = registry_lib.masked_registry(self.registry, self.mask)
        self._normalize_observability()
        if self.eigh_impl not in factors_lib.EIGH_IMPLS:
            raise ValueError(f'unknown eigh_impl {self.eigh_impl!r}')
        if isinstance(self.compute_method, str):
            try:
                self.compute_method = enums.ComputeMethod[self.compute_method.upper()]
            except KeyError:
                raise ValueError(
                    f'unknown compute_method {self.compute_method!r}; expected '
                    f'one of {[m.name.lower() for m in enums.ComputeMethod]}'
                ) from None
        method, solver = default_compute_method(self.device.type)
        if self.compute_method is None:
            self.compute_method = method
        if self.inverse_solver is None:
            self.inverse_solver = solver
        if self.inverse_solver not in ('cholesky', 'newton_schulz', 'auto'):
            raise ValueError(
                f'unknown inverse_solver {self.inverse_solver!r}; expected '
                "'cholesky', 'newton_schulz', or 'auto'"
            )
        if self.inverse_solver in ('newton_schulz', 'auto') and self.eigen:
            warnings.warn(
                f'inverse_solver={self.inverse_solver!r} has no effect with '
                'the EIGEN compute method (it replaces the INVERSE-method '
                "solve); pass compute_method='inverse' to use it",
                stacklevel=2,
            )
        self._normalize_distributed()
        for name in ('factor_update_steps', 'inv_update_steps'):
            value = getattr(self, name)
            if not callable(value) and value < 1:
                raise ValueError(f'{name} must be >= 1, got {value}')
        if (
            not callable(self.factor_update_steps)
            and not callable(self.inv_update_steps)
            and self.inv_update_steps % self.factor_update_steps != 0
        ):
            warnings.warn(
                'inv_update_steps is not a multiple of factor_update_steps; '
                'some inverse updates will recompute from unchanged factors',
                stacklevel=2,
            )
        self.async_inverse = async_config_lib.as_async_config(self.async_inverse)
        if self.async_inverse is not None and callable(self.inv_update_steps):
            raise ValueError(
                'async_inverse requires a static int inv_update_steps (the '
                'refresh window is planned when the engine is built); got a '
                'schedule'
            )
        self.stat_compression = compression_config_lib.as_compression_config(
            self.stat_compression
        )
        if (
            self.stat_compression is not None
            and self.allreduce_method != enums.AllreduceMethod.ALLREDUCE_BUCKETED
        ):
            raise ValueError(
                'stat_compression quantizes the bucketed flat-buffer '
                "transport; set allreduce_method='allreduce_bucketed'"
            )
        self.offload = compression_config_lib.as_offload_config(self.offload)
        if self.offload is not None:
            if self.async_inverse is not None and self.async_inverse.mode == 'sliced':
                raise ValueError(
                    "offload is incompatible with async_inverse='sliced': "
                    'the sliced refresh reads the factor state every step, '
                    'so it is never cold'
                )
            if callable(self.factor_update_steps) or callable(self.inv_update_steps):
                raise ValueError(
                    'offload requires static int factor_update_steps and '
                    'inv_update_steps (the host-side pump computes cadence '
                    'boundaries from them); got a schedule'
                )
        for name in ('factor_dtype', 'inv_dtype'):
            if getattr(self, name) not in STORE_DTYPES:
                raise ValueError(
                    f'{name} must be one of {STORE_DTYPES}, got {getattr(self, name)}'
                )
        if self.reduced_precision:
            for knob in ('async_inverse', 'offload', 'stat_compression'):
                if getattr(self, knob) is not None:
                    raise NotImplementedError(
                        f'{knob} with factor_dtype={self.factor_dtype}, '
                        f'inv_dtype={self.inv_dtype} is not ported to kfac_tpu_torch yet'
                    )
        self._plan_async()
        self._plan_offload()

    def _plan_offload(self) -> None:
        """The offload manager of the dense engine (its own knob carrier);
        ``DistributedKFAC`` builds its own."""
        self._offload_manager = (
            None if self.offload is None else offload_lib.OffloadManager(self)
        )

    def _plan_async(self) -> None:
        """The async refresh's plan: ``_async_mode`` (None, ``'sliced'`` or
        ``'host'``), ``_async_n_steps`` (the window) and, for sliced mode,
        ``_async_slices`` / ``_async_n_slices`` (the balanced per-step
        unit buckets)."""
        acfg = self.async_inverse
        self._async_mode = None if acfg is None else acfg.mode
        self._async_worker = None
        if acfg is None:
            return
        self._async_n_steps = int(self.inv_update_steps)
        if acfg.mode == 'sliced':
            units = async_sliced.dense_units(self)
            n = min(self._async_n_steps, acfg.max_slices or len(units))
            self._async_slices = async_slots.plan_slices(units, n)
            self._async_n_slices = len(self._async_slices)

    def _normalize_distributed(self) -> None:
        """The distributed engine's fields, validated as the JAX config
        validates them; ``bucket_granularity=None`` becomes 1."""
        if self.bucket_granularity is None:
            self.bucket_granularity = 1
        elif self.bucket_granularity < 1:
            raise ValueError(
                f'bucket_granularity must be >= 1 (or None for the '
                f'platform default), got {self.bucket_granularity}'
            )
        if isinstance(self.allreduce_method, str):
            try:
                self.allreduce_method = enums.AllreduceMethod[self.allreduce_method.upper()]
            except KeyError:
                raise ValueError(
                    f'unknown allreduce_method {self.allreduce_method!r}; '
                    f'expected one of {[m.name.lower() for m in enums.AllreduceMethod]}'
                ) from None
        if self.allreduce_bucket_cap_mb is not None and self.allreduce_bucket_cap_mb <= 0:
            raise ValueError(
                f'allreduce_bucket_cap_mb must be > 0 (or None for '
                f'unbounded), got {self.allreduce_bucket_cap_mb}'
            )

    def _normalize_observability(self) -> None:
        """``metrics``, ``flight`` and ``health`` to a config or None, as the
        JAX engine takes them (``flight`` turns ``metrics`` on)."""
        if self.metrics is True:
            self.metrics = metrics_lib.MetricsConfig()
        elif self.metrics is False:
            self.metrics = None
        elif self.metrics is not None and not isinstance(self.metrics, metrics_lib.MetricsConfig):
            raise TypeError(
                'metrics must be a MetricsConfig, True, False, or None; '
                f'got {self.metrics!r}'
            )
        if self.flight is True:
            self.flight = flight_lib.FlightRecorderConfig()
        elif self.flight is False:
            self.flight = None
        elif isinstance(self.flight, int) and not isinstance(self.flight, bool):
            self.flight = flight_lib.FlightRecorderConfig(capacity=self.flight)
        elif self.flight is not None and not isinstance(
            self.flight, flight_lib.FlightRecorderConfig
        ):
            raise TypeError(
                'flight must be a FlightRecorderConfig, True, False, an '
                f'int capacity, or None; got {self.flight!r}'
            )
        if self.flight is not None and self.metrics is None:
            # the ring records the metric scalar schema
            self.metrics = metrics_lib.MetricsConfig()
        if self.health is True:
            self.health = health_lib.HealthConfig()
        elif self.health is False:
            self.health = None
        elif self.health is not None and not isinstance(self.health, health_lib.HealthConfig):
            raise TypeError(
                'health must be a HealthConfig, True, False, or None; got '
                f'{self.health!r}'
            )

    @property
    def reduced_precision(self) -> bool:
        """Whether the factors or the decompositions are stored below f32."""
        return self.factor_dtype != torch.float32 or self.inv_dtype != torch.float32

    @property
    def eigen(self) -> bool:
        return self.compute_method == enums.ComputeMethod.EIGEN

    # ------------------------------------------------------------------ init

    def init(self) -> KFACState:
        """Identity factors and zero decompositions on ``device``, with
        fresh health counters, metrics and flight ring where they are on."""
        dev = self.device
        state = KFACState(0, {}, {}, {}, {}, {}, {}, {}, {}, {})
        for name, h in self.registry.layers.items():
            na, ng = h.a_factor_shape[0], h.g_factor_shape[0]
            fdt, idt = self.factor_dtype, self.inv_dtype
            state.a[name] = torch.eye(na, device=dev, dtype=fdt)
            state.g[name] = torch.eye(ng, device=dev, dtype=fdt)
            if self.eigen:
                state.qa[name] = torch.zeros((na, na), device=dev, dtype=idt)
                state.qg[name] = torch.zeros((ng, ng), device=dev, dtype=idt)
                if self.prediv_eigenvalues:
                    state.dgda[name] = torch.zeros((ng, na), device=dev, dtype=idt)
                else:
                    state.da[name] = torch.zeros((na,), device=dev, dtype=idt)
                    state.dg[name] = torch.zeros((ng,), device=dev, dtype=idt)
            else:
                state.a_inv[name] = torch.zeros((na, na), device=dev, dtype=idt)
                state.g_inv[name] = torch.zeros((ng, ng), device=dev, dtype=idt)
        names = list(self.registry.layers)
        if self.health is not None:
            state.health = health_lib.init_health(names, dev)
        if self.metrics is not None:
            state.metrics = metrics_lib.init_metrics(self.metrics, names, dev)
        if self.flight is not None:
            state.flight = flight_lib.init_flight(
                self.flight, metrics_lib.metric_keys(self.metrics, names), dev
            )
        # the host mode's double buffer is its worker's payload
        if self._async_mode == 'sliced':
            state.shadow = async_sliced.dense_shadow(self, state)
        return state

    def _effective_damping(self, state: KFACState, damping: float):
        """Per layer, the damping its decompositions and preconditioning
        use: ``damping`` without health, else the (L,) device vector
        ``damping * damping_mult`` (its entries 0-d views, never read on the
        host)."""
        if self.health is None:
            return [damping] * len(self.registry.layers)
        return damping * state.health.damping_mult

    # --------------------------------------------------------------- factors

    def update_factors(
        self, state: KFACState, stats: capture_lib.CapturedStats
    ) -> KFACState:
        """EMA-update the running factors from per-batch statistics; layers
        absent from ``stats`` keep theirs.

        With health, a layer's update that is non-finite or whose Gershgorin
        condition bound at its effective damping passes the quarantine
        threshold rolls both its factors back and escalates its damping;
        the factor metrics then describe the factors after the rollback, and
        ``last_factor_step`` advances only for accepted updates.

        A layer with an evidence weight in ``stats.w`` (a routed layer)
        decays by ``effective_alpha(alpha, w)``, a device tensor: a capture
        in which its expert saw no token leaves its factors as they were.
        """
        alpha = resolve(self.factor_decay, state.step)

        def decay(n):
            if n in stats.w:
                return factors_lib.effective_alpha(alpha, stats.w[n])
            return alpha

        # the result is pinned to factor_dtype: a routed layer's f32 decay
        # would otherwise promote a half-precision factor
        fdt = self.factor_dtype
        new_a = {
            n: factors_lib.ema_update(state.a[n], stats.a[n].to(fdt), decay(n)).to(fdt)
            if n in stats.a else state.a[n]
            for n in state.a
        }
        new_g = {
            n: factors_lib.ema_update(state.g[n], stats.g[n].to(fdt), decay(n)).to(fdt)
            if n in stats.g else state.g[n]
            for n in state.g
        }
        names = list(self.registry.layers)
        touched = [i for i, n in enumerate(names) if n in stats.a or n in stats.g]
        ok = None  # (len(touched),) verdicts, with health
        health = state.health
        if self.health is not None and touched:
            cfg = self.health
            eff = self._effective_damping(state, resolve(self.damping, state.step))
            # both factors of each touched layer, judged at its damping
            ok = health_lib.factors_ok(
                [f[names[i]] for i in touched for f in (new_a, new_g)],
                [eff[i] for i in touched for _ in range(2)],
                cfg.quarantine_threshold,
            ).view(len(touched), 2).all(dim=1)
            for k, i in enumerate(touched):
                n = names[i]
                new_a[n] = torch.where(ok[k], new_a[n], state.a[n])
                new_g[n] = torch.where(ok[k], new_g[n], state.g[n])
            idx = health_lib.positions(touched, len(names), ok.device)
            fields = (health.damping_mult, health.quarantined, health.quarantine_events)
            moved = health_lib.quarantine_update(
                cfg, ok, *(f if idx is None else f[idx] for f in fields)
            )
            mult, quarantined, events = (
                m if idx is None else f.index_copy(0, idx, m) for f, m in zip(fields, moved)
            )
            health = dataclasses.replace(
                health, damping_mult=mult, quarantined=quarantined, quarantine_events=events
            )
        state = dataclasses.replace(state, a=new_a, g=new_g, health=health)
        if self.metrics is not None and state.metrics is not None and touched:
            state = dataclasses.replace(
                state, metrics=self._record_factor_metrics(state, touched, ok)
            )
        return state

    def _record_factor_metrics(
        self, state: KFACState, touched: list[int], ok: torch.Tensor | None
    ) -> metrics_lib.MetricsState:
        """The factor phase's metrics on the factors after any rollback:
        the Gershgorin bounds of the ``touched`` layers, and their
        ``last_factor_step`` advanced where ``ok`` (None: every one)."""
        ms = state.metrics
        names = list(self.registry.layers)
        if self.metrics.factor_bounds:
            lmin, lmax = metrics_lib.gershgorin_bounds_each(
                [f[names[i]] for f in (state.a, state.g) for i in touched]
            )
            k = len(touched)
            values = {
                'factor_lmin/a': lmin[:k], 'factor_lmax/a': lmax[:k],
                'factor_lmin/g': lmin[k:], 'factor_lmax/g': lmax[k:],
            }
            if len(touched) == len(names):
                ms = metrics_lib.set_families(ms, values)
            else:
                ms = metrics_lib.update_scalars(ms, {
                    f'{f}/{names[i]}': v[k]
                    for f, v in values.items() for k, i in enumerate(touched)
                })
        if len(touched) == len(names):
            last = metrics_lib.advance_all(ms.last_factor_step, ok, state.step)
        else:
            last = metrics_lib.advance_last(
                ms.last_factor_step, ms.names,
                {names[i]: None if ok is None else ok[k] for k, i in enumerate(touched)},
                state.step,
            )
        return dataclasses.replace(ms, last_factor_step=last)

    # -------------------------------------------------------------- inverses

    def update_inverses(self, state: KFACState) -> KFACState:
        """Recompute eigendecompositions (or damped inverses) from the
        current factors. Newton-Schulz warm-starts each factor from its
        previous inverse, A then G in registry order, as the JAX engine
        does; the all-zeros inverses of a fresh state take the cold start.

        With health, each layer runs at its effective damping; a non-finite
        result rolls back to the layer's previous decomposition, and
        ``bad_inv`` counts up when the refresh ran from a quarantined factor
        or was non-finite, down otherwise.
        """
        eff = self._effective_damping(state, resolve(self.damping, state.step))
        names = list(self.registry.layers)
        oks = []  # with health, each layer's verdict

        def checked(name, cand, prev):
            """``cand`` with health: kept where every output is finite, else
            ``prev`` (the layer's previous slots)."""
            if self.health is None:
                return cand
            ok = torch.stack([torch.isfinite(v).all() for v in cand.values()]).all()
            oks.append(ok)
            return {k: torch.where(ok, v, prev[k][name]) for k, v in cand.items()}

        slots = {}
        if not self.eigen:
            for i, n in enumerate(names):
                cand = {
                    key: factors_lib.damped_inverse(
                        factor, eff[i], self.inverse_solver,
                        self.newton_schulz_iters, x0=prev,
                    ).to(self.inv_dtype)
                    for key, factor, prev in (
                        ('a_inv', state.a[n], state.a_inv[n]),
                        ('g_inv', state.g[n], state.g_inv[n]),
                    )
                }
                slots[n] = checked(n, cand, {'a_inv': state.a_inv, 'g_inv': state.g_inv})
        else:
            prev = {'qa': state.qa, 'qg': state.qg, 'da': state.da, 'dg': state.dg,
                    'dgda': state.dgda}
            for i, n in enumerate(names):
                adec = factors_lib.compute_eigh(state.a[n], self.eigh_impl, self.inv_dtype)
                gdec = factors_lib.compute_eigh(state.g[n], self.eigh_impl, self.inv_dtype)
                cand = {'qa': adec.q, 'qg': gdec.q}
                if self.prediv_eigenvalues:
                    cand['dgda'] = factors_lib.prediv_eigenvalues(
                        adec, gdec, eff[i]
                    ).to(self.inv_dtype)
                else:
                    cand['da'], cand['dg'] = adec.d, gdec.d
                slots[n] = checked(n, cand, prev)
        updates = {
            key: {n: slots[n][key] for n in names}
            for key in next(iter(slots.values()), {})
        }
        state = dataclasses.replace(state, **updates)
        ok = None
        if self.health is not None and names:
            h = state.health
            ok = torch.stack(oks)
            state = dataclasses.replace(state, health=dataclasses.replace(
                h, bad_inv=health_lib.inversion_update(self.health, ok, h.quarantined, h.bad_inv)
            ))
        if self.metrics is not None and state.metrics is not None:
            ms = state.metrics
            state = dataclasses.replace(state, metrics=dataclasses.replace(
                ms, last_inv_step=metrics_lib.advance_all(ms.last_inv_step, ok, state.step)
            ))
        return state

    # --------------------------------------------------------- precondition

    def _precondition_one(
        self, state: KFACState, name: str, grad_mat: torch.Tensor, damping
    ) -> torch.Tensor:
        if not self.eigen:
            return factors_lib.inverse_preconditioned_grad(
                grad_mat, state.a_inv[name], state.g_inv[name]
            )
        if self.prediv_eigenvalues:
            v1 = state.qg[name].T @ grad_mat.to(self.inv_dtype) @ state.qa[name]
            v2 = v1 * state.dgda[name]
            return (state.qg[name] @ v2 @ state.qa[name].T).to(grad_mat.dtype)
        return factors_lib.eigen_preconditioned_grad(
            grad_mat,
            factors_lib.EigenDecomp(q=state.qa[name], d=state.da[name]),
            factors_lib.EigenDecomp(q=state.qg[name], d=state.dg[name]),
            damping,
        )

    def precondition(
        self,
        state: KFACState,
        grads: dict[str, torch.Tensor],
        metrics_out: dict[str, torch.Tensor] | None = None,
        vg_reduce: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    ) -> dict[str, torch.Tensor]:
        """Precondition a ``named_parameters``-keyed grads dict.

        kl-clip takes one scalar over all layers, summed in registry order on
        the device (no host sync): every layer's term, their sum and the
        scale in one launch of the kl-clip dot kernel; then every layer is
        scaled in one kernel launch, in place.

        With health, each layer is preconditioned at its effective damping,
        and a degraded layer's preconditioned gradient is its raw gradient
        (still kl-clipped with the rest). ``metrics_out``, when given, gets
        this phase's metric families as vectors in registry order:
        ``damping_eff``, ``kl_clip_scale`` and, with ``grad_norms``,
        ``grad_norm`` and ``precond_grad_norm`` (its pre-scale norm times
        ``|scale|``), both from the norm instantiation of the kl-clip dot's
        one pass, with or without kl-clip.

        ``vg_reduce(terms, vg_sum) -> vg_total``, when given, makes the
        kl-clip sum span the layers other ranks precondition (the experts
        of expert parallelism, the other stages of a pipeline): it takes
        the kernel's per-layer terms (registry order) and their sum, on the
        device, and returns the whole model's sum, from which the scale is
        taken on the device.
        """
        damping = resolve(self.damping, state.step)
        eff = self._effective_damping(state, damping)
        degraded = (
            None if self.health is None
            else health_lib.is_degraded(self.health, state.health.bad_inv)
        )
        layer_grads = registry_lib.slice_layer_grads(grads, self.registry)
        helpers, gmats, pmats = [], [], []
        for i, (name, helper) in enumerate(self.registry.layers.items()):
            gmat = helper.grads_to_matrix(layer_grads[name])
            pmat = self._precondition_one(state, name, gmat, eff[i])
            if degraded is not None:
                pmat = torch.where(degraded[i], gmat.to(pmat.dtype), pmat)
            helpers.append(helper)
            gmats.append(gmat)
            pmats.append(pmat)
        norms = metrics_out is not None and self.metrics.grad_norms and bool(pmats)
        scale = None
        if pmats and (self.kl_clip is not None or norms):
            lr = resolve(self.lr, state.step)
            kl_clip = 1.0 if self.kl_clip is None else resolve(self.kl_clip, state.step)
            if norms:
                terms, vg_sum, scale, g_sq, p_sq = klclip.klclip_dot_norms_many(
                    pmats, gmats, lr, kl_clip
                )
            else:
                terms, vg_sum, scale = klclip.klclip_dot_many(pmats, gmats, lr, kl_clip)
            if vg_reduce is not None:
                scale = factors_lib.kl_clip_scale(vg_reduce(terms, vg_sum), kl_clip)
            if self.kl_clip is None:
                scale = None
            else:
                pmats = factors_lib.kl_clip_apply_many_(pmats, scale)
        if metrics_out is not None:
            dev = self.device
            metrics_out['kl_clip_scale'] = (
                torch.ones((), device=dev) if scale is None else scale
            )
            if norms:
                p_norm = torch.sqrt(p_sq)
                metrics_out['grad_norm'] = torch.sqrt(g_sq)
                metrics_out['precond_grad_norm'] = (
                    p_norm if scale is None else p_norm * torch.abs(scale)
                )
            metrics_out['damping_eff'] = (
                eff if self.health is not None
                else torch.full((len(pmats),), damping, device=dev)
            )
        out = {
            name: helper.matrix_to_grads(pmat)
            for name, helper, pmat in zip(self.registry.layers, helpers, pmats)
        }
        return registry_lib.merge_layer_grads(grads, out, self.registry)

    # ------------------------------------------------------------------ step

    def step(
        self,
        state: KFACState,
        grads: dict[str, torch.Tensor],
        stats: capture_lib.CapturedStats | None,
        loss: torch.Tensor | None = None,
        vg_reduce: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    ) -> tuple[KFACState, dict[str, torch.Tensor]]:
        """One K-FAC step: maybe update factors and inverses, then
        precondition (``vg_reduce``: :meth:`precondition`'s).
        ``stats=None`` skips the factor update (a step without capture);
        under ``async_inverse`` the sliced or host stage
        takes the place of the inverse cadence. With metrics, the step's
        scalars and staleness go into ``state.metrics``; with the flight
        recorder, one ring row then records them beside ``loss`` (when
        given) and the raw grads' global norm.

        A spilled state (cold-factor offload: placeholders in place of the
        factors) skips the factor and inverse work: the offload pump
        restores the factors before every step that would do it."""
        step = state.step
        spilled = offload_lib.is_spilled(state)
        if (
            stats is not None and not spilled
            and step % resolve(self.factor_update_steps, step) == 0
        ):
            state = self.update_factors(state, stats)
        if spilled:
            pass
        elif self._async_mode == 'sliced':
            state = async_sliced.dense_async_step(self, state)
        elif self._async_mode == 'host':
            state = async_host.dense_host_step(self, state)
        elif step % resolve(self.inv_update_steps, step) == 0:
            state = self.update_inverses(state)
        if self.metrics is not None and state.metrics is not None:
            families: dict[str, torch.Tensor] = {}
            new_grads = self.precondition(
                state, grads, metrics_out=families, vg_reduce=vg_reduce
            )
            ms = metrics_lib.set_families(state.metrics, families)
            state = dataclasses.replace(
                state, metrics=metrics_lib.finalize(ms, self.metrics, step)
            )
        else:
            new_grads = self.precondition(state, grads, vg_reduce=vg_reduce)
        if self.flight is not None and state.flight is not None:
            state = dataclasses.replace(state, flight=flight_lib.record(
                state.flight, step, state.metrics.scalars, loss=loss,
                grad_norm=flight_lib.global_grad_norm(grads),
            ))
        return dataclasses.replace(state, step=step + 1), new_grads

    # ------------------------------------------------------------- utilities

    def extract_factors(self, state: KFACState) -> dict[str, dict[str, torch.Tensor]]:
        """Each layer's factors, ``{name: {'a': A, 'g': G}}``."""
        return {n: {'a': state.a[n], 'g': state.g[n]} for n in state.a}

    def insert_factors(
        self, state: KFACState, factors: dict[str, dict[str, Any]]
    ) -> KFACState:
        """Inverse of :meth:`extract_factors`: each registered layer named in
        ``factors`` takes its ``'a'`` and ``'g'`` (tensors or arrays) in
        ``factor_dtype`` on ``device``; others keep theirs. Call :meth:`rematerialize`
        afterwards."""
        new_a, new_g = dict(state.a), dict(state.g)
        for name, fg in factors.items():
            if name in new_a:
                new_a[name] = torch.as_tensor(fg['a']).to(self.device, self.factor_dtype)
                new_g[name] = torch.as_tensor(fg['g']).to(self.device, self.factor_dtype)
        return dataclasses.replace(state, a=new_a, g=new_g)

    def rematerialize(self, state: KFACState) -> KFACState:
        """Recompute the decompositions from the current factors, as after
        a checkpoint load: :meth:`update_inverses`, with health and metrics
        as a refresh ticks them. A restored state starts from
        :meth:`init`'s all-zeros decompositions, so Newton-Schulz starts
        cold there (no ``x0`` survives a restart); on a live state it
        warm-starts, and a non-finite result rolls back under health, as
        in the JAX engine. Under async refresh the shadow (sliced) or the
        worker (host) is reset too: the first boundary after a mid-window
        restore then skips its swap. The offload manager forgets its host
        copies: the state handed in is resident."""
        if self._offload_manager is not None:
            self._offload_manager.reset()
        state = self.update_inverses(state)
        if self._async_mode == 'sliced':
            state = dataclasses.replace(state, shadow=async_sliced.dense_shadow(self, state))
        elif self._async_mode == 'host':
            async_host.reset_worker(self)
        return state

    def topology(self) -> dict[str, Any]:
        """Process and device counts, recorded (for information only) in
        checkpoint layout manifests, as the JAX engine's."""
        from kfac_tpu_torch.parallel import multihost

        cuda = self.device.type == 'cuda'
        return {
            'process_count': multihost.process_count(),
            'device_count': torch.cuda.device_count() if cuda else 1,
            'backend': self.device.type,
        }

    def describe(self) -> str:
        """The registration and the options, one line each."""
        lines = [
            f'KFACPreconditioner: {len(self.registry.layers)} registered '
            f'layers, compute_method={self.compute_method.name}, '
            f'inverse_solver={self.inverse_solver}',
        ]
        if self.mask is not None:
            lines.append(
                '  mask: trainability mask active — frozen layers are '
                'unregistered (no factors, gradients pass through)'
            )
        if self.health is not None:
            hc = self.health
            lines.append(
                f'  health: skip_nonfinite={hc.skip_nonfinite} '
                f'quarantine_threshold={hc.quarantine_threshold} '
                f'damping_escalation={hc.damping_escalation} '
                f'degrade_after={hc.degrade_after}'
            )
        if self.metrics is not None:
            mc = self.metrics
            lines.append(
                f'  metrics: grad_norms={mc.grad_norms} '
                f'factor_bounds={mc.factor_bounds} staleness={mc.staleness}'
            )
        for name, h in self.registry.layers.items():
            lines.append(
                f'  {name}: {type(h).__name__} '
                f'A={h.a_factor_shape[0]}x{h.a_factor_shape[0]} '
                f'G={h.g_factor_shape[0]}x{h.g_factor_shape[0]}'
                f'{" +bias" if h.has_bias else ""}'
            )
        return '\n'.join(lines)

    def memory_usage(self, state: KFACState) -> dict[str, int]:
        """Bytes of the factors and of their decompositions or inverses."""

        def nbytes(d: dict[str, torch.Tensor]) -> int:
            return int(sum(v.numel() * v.element_size() for v in d.values()))

        sizes = {
            'a_factors': nbytes(state.a),
            'g_factors': nbytes(state.g),
            'a_inverses': nbytes(state.qa) + nbytes(state.da) + nbytes(state.a_inv),
            'g_inverses': (
                nbytes(state.qg) + nbytes(state.dg) + nbytes(state.dgda) + nbytes(state.g_inv)
            ),
        }
        sizes['total'] = sum(sizes.values())
        return sizes


def set_grads(model: torch.nn.Module, grads: dict[str, torch.Tensor]) -> None:
    """Write a ``named_parameters``-keyed grads dict into ``param.grad``,
    ready for a ``torch.optim`` step."""
    for n, p in model.named_parameters():
        if n in grads:
            p.grad = grads[n].contiguous()
