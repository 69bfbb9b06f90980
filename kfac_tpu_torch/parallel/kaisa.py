"""KAISA distributed K-FAC over ``torch.distributed`` (counterpart of
``kfac_tpu/parallel/kaisa.py``).

The JAX engine expresses KAISA as data layout on a device mesh and lets
XLA insert the collectives; here one process runs each rank of a
:class:`~kfac_tpu_torch.parallel.mesh.KaisaGrid` and the collectives are
explicit. The layout is the JAX engine's:

- Layers are grouped by factor size class into buckets, and each side's
  factors are stacked into stores ``(L, d, d)``, padded with identity
  slots to a multiple of the world (exact: a padding slot's gradient is
  zero).
- Factors are sharded over every rank: each rank holds one block of
  ``L / world`` slots of each store, and decomposes that block.
- Decompositions are resident in the strategy's layout: the slots of a
  column's block on every rank of that column (COMM-OPT: one column, so
  every rank holds every slot; MEM-OPT: one rank a column). The
  all-gather within the column after a refresh is KAISA's inverse
  broadcast.
- Each column preconditions the gradients of its slots, and the
  all-gather within each row is KAISA's gradient broadcast.

Which rank decomposes which block is ordered so that the reshard is one
all-gather within each column: rank ``(row, col)`` holds factor block
``col * grad_workers + row``. Under COMM-OPT and MEM-OPT that is block
``rank``, the JAX engine's placement; under HYBRID the blocks of a column
are spread over its rows where the JAX mesh places them on consecutive
devices. The resident decompositions, which ``memory_usage`` counts and
``convert`` moves, lie where the JAX engine's do on every strategy.

The steps take this rank's statistics, from a mean loss over its own row
block of the global batch, and the global mean gradients (the
``Trainer`` reduces them, :meth:`DistributedKFAC.average_grads`).

The health sentinel, the metrics and the flight recorder ride in the state
as the JAX engine's do, replicated: bitwise equal on every rank. Each rank
judges only the slots of its own factor block (a factor update's
quarantine verdict, a refresh's finiteness, the factor phase's Gershgorin
bounds), and the verdicts reach every rank through one ``all_reduce`` of
an (L,)-sized vector that is zero outside the rank's block, so the sum is
exact and no value is read on the host.

The async refresh (``async_inverse``: sliced, or a host worker a rank),
the compressed stat transport (``stat_compression``) and the cold-factor
offload (``offload``) are the JAX engine's; its compile watch and
``auto_layout`` raise ``NotImplementedError``.

On a :class:`~kfac_tpu_torch.parallel.mesh.TrainGrid` with ``model`` or
``seq`` axes (tensor and sequence parallelism), the strategy, ``world``
and ``grad_workers`` come from the data-parallel grid, and, as in the JAX
engine, the factor stores are padded to and sharded over every rank
(``total_devices``): rank ``(row, col, m, s)`` holds factor block ``col *
(grad_workers * model * seq) + (row * model + m) * seq + s``, so the
reshard after a refresh is still one all-gather within each column (now
every rank of the column, over its model and seq ranks), which leaves the
decompositions in the strategy's layout, replicated over model and seq.
The statistics are reduced over the data and sequence ranks
(``stat_group``), each rank's A and G being from its own tokens, and
every model rank of a group holds the same. A tensor-parallel layer's
gradient is gathered over its model group, preconditioned and kl-clipped
whole (the same on every model rank), and each rank keeps its shard.
There the async refresh, the compressed transport, the offload, health,
metrics, flight and checkpoints raise ``NotImplementedError``.

The compressed transport quantizes what crosses the wire. For each packed
chunk of factor triangles, a ``reduce_scatter`` of the f32 partials gives
each rank a block-aligned slice of the global sum; the rank adds its slice
of the error-feedback residual, quantizes the slice (int8 or fp8,
blockwise scales) and keeps its slice of the new residual; an
``all_gather`` of the payload and the scales then gives every rank the
whole chunk to dequantize. That is the JAX engine's ``deq(quant(sum +
ef))`` with ``ef <- (sum + ef) - deq``, quantized after the sum, as there.
The residual is sharded by rank (``comp_ef``: each rank's slice of each
chunk), where the JAX engine replicates it; ``convert`` and the
checkpoints map between the two.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from kfac_tpu_torch import assignment as assignment_lib
from kfac_tpu_torch import enums
from kfac_tpu_torch import health as health_lib
from kfac_tpu_torch.async_inverse import host as async_host
from kfac_tpu_torch.async_inverse import sliced as async_sliced
from kfac_tpu_torch.async_inverse import slots as async_slots
from kfac_tpu_torch.compression import offload as offload_lib
from kfac_tpu_torch.compression import quant as quant_lib
from kfac_tpu_torch.hyperparams import resolve
from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.observability import comms as comms_lib
from kfac_tpu_torch.observability import flight_recorder as flight_lib
from kfac_tpu_torch.observability import metrics as metrics_lib
from kfac_tpu_torch.ops import factors as factors_lib
from kfac_tpu_torch.ops import klclip
from kfac_tpu_torch.parallel import collectives
from kfac_tpu_torch.parallel import mesh as mesh_lib
from kfac_tpu_torch.parallel import tensor_parallel as tp_lib


def size_class(d: int, granularity: int) -> int:
    """A factor dimension rounded up to its size class: ``granularity <=
    1`` keeps it; dims below the granularity round to the next power of
    two (>= 8), capped at the granularity; larger dims to the next
    multiple of the granularity."""
    if granularity <= 1 or d == 0:
        return d
    if d >= granularity:
        return -(-d // granularity) * granularity
    c = 8
    while c < d:
        c *= 2
    return min(c, granularity)


def pad_factor(m: torch.Tensor, c: int) -> torch.Tensor:
    """A (d, d) factor in its (c, c) class slot, an identity block in the
    padding (a decoupled unit eigenspace, so preconditioning the real
    block is unchanged)."""
    d = m.shape[0]
    if d == c:
        return m
    out = torch.zeros((c, c), dtype=m.dtype, device=m.device)
    out[:d, :d] = m
    idx = torch.arange(d, c, device=m.device)
    out[idx, idx] = 1.0
    return out


def pad_grad(m: torch.Tensor, cg: int, ca: int) -> torch.Tensor:
    """A (dg, da) gradient matrix zero-padded into its (cg, ca) slot."""
    if tuple(m.shape) == (cg, ca):
        return m
    out = torch.zeros((cg, ca), dtype=m.dtype, device=m.device)
    out[:m.shape[0], :m.shape[1]] = m
    return out


class Bucket(NamedTuple):
    """Layers sharing factor size classes, stacked along a slot axis.
    ``da``/``dg`` are class dims; ``dims`` each layer's true (da, dg)."""

    key: str
    layers: tuple[str, ...]
    da: int
    dg: int
    padded: int  # slots, padding to a multiple of the world included
    dims: tuple[tuple[int, int], ...]


def build_buckets(
    registry: registry_lib.Registry, world: int, granularity: int = 128
) -> list[Bucket]:
    """Group registered layers by (A class, G class), padded to the
    world."""
    groups: dict[tuple[int, int], list[tuple[str, int, int]]] = {}
    for name, h in registry.layers.items():
        da, dg = h.a_factor_shape[0], h.g_factor_shape[0]
        key = (size_class(da, granularity), size_class(dg, granularity))
        groups.setdefault(key, []).append((name, da, dg))
    return [
        Bucket(
            key=f'{ca}x{cg}',
            layers=tuple(r[0] for r in rows),
            da=ca,
            dg=cg,
            padded=-(-len(rows) // world) * world,
            dims=tuple((r[1], r[2]) for r in rows),
        )
        for (ca, cg), rows in sorted(groups.items())
    ]


class StorageBucket(NamedTuple):
    """One side's (A or G) factor store: layers stacked along slots. With
    ``colocate_factors`` the stores mirror the pair buckets, so a layer's
    A and G share a slot; without, each side groups by its own dim."""

    key: str
    layers: tuple[str, ...]
    d: int  # class dim
    padded: int
    dims: tuple[int, ...]  # true per-layer dims


def build_side_buckets(
    registry: registry_lib.Registry,
    world: int,
    side: str,
    granularity: int = 128,
) -> list[StorageBucket]:
    """Group layers by one side's size class (non-colocated stores)."""
    groups: dict[int, list[tuple[str, int]]] = {}
    for name, h in registry.layers.items():
        d = h.a_factor_shape[0] if side == 'a' else h.g_factor_shape[0]
        groups.setdefault(size_class(d, granularity), []).append((name, d))
    return [
        StorageBucket(
            key=f'{side}{c}',
            layers=tuple(r[0] for r in rows),
            d=c,
            padded=-(-len(rows) // world) * world,
            dims=tuple(r[1] for r in rows),
        )
        for c, rows in sorted(groups.items())
    ]


def build_stores(
    registry: registry_lib.Registry,
    world: int,
    granularity: int,
    colocate: bool,
    buckets: list[Bucket],
) -> tuple[list[StorageBucket], list[StorageBucket]]:
    """The (A stores, G stores) of a configuration: the pair buckets'
    sides when colocated, else each side bucketed by its own dim."""
    if colocate:
        return (
            [StorageBucket(b.key, b.layers, b.da, b.padded, tuple(d[0] for d in b.dims))
             for b in buckets],
            [StorageBucket(b.key, b.layers, b.dg, b.padded, tuple(d[1] for d in b.dims))
             for b in buckets],
        )
    return (
        build_side_buckets(registry, world, 'a', granularity),
        build_side_buckets(registry, world, 'g', granularity),
    )


@dataclasses.dataclass
class DistKFACState:
    """This rank's shards of the stacked state: store key -> tensor.

    ``a``/``g``: the rank's factor block of each store, (L / world, d, d).
    ``qa``/``qg``/``da``/``dg`` (EIGEN), ``dgda`` (prediv) and
    ``a_inv``/``g_inv`` (INVERSE): the resident block of the rank's column,
    (L / n_cols, ...); unused fields hold empty dicts. ``inv_damping``: the
    damping the resident decompositions were built with (read by
    :meth:`DistributedKFAC.inverse_residuals`). ``shadow``: the sliced
    async refresh's :class:`~kfac_tpu_torch.async_inverse.ShadowSlots` of
    the resident fields (ephemeral, as in the dense engine). ``comp_ef``:
    with ``stat_compression`` and error feedback, the rank's slice of each
    chunk's residual (``'c0'``, ``'c1'``, ...; f32, durable), else None.
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
    inv_damping: float
    health: health_lib.HealthState | None = None
    metrics: metrics_lib.MetricsState | None = None
    flight: flight_lib.FlightRecorderState | None = None
    shadow: async_slots.ShadowSlots | None = None
    comp_ef: dict[str, torch.Tensor] | None = None


_LATER_SLICE_KNOBS = ('compile_watch',)
# not ported yet on a grid with model or seq axes
_TP_LATER_KNOBS = (
    'async_inverse', 'stat_compression', 'offload', 'health', 'metrics', 'flight',
)


@dataclasses.dataclass
class DistributedKFAC:
    """KAISA preconditioning over a :class:`~kfac_tpu_torch.parallel.mesh.
    KaisaGrid`.

    Args:
        config: the :class:`~kfac_tpu_torch.KFACPreconditioner` carrying
            the cadences, damping, decay, kl-clip, lr, compute method,
            solver and the distributed fields (``bucket_granularity``,
            ``colocate_factors``, ``allreduce_method``,
            ``allreduce_bucket_cap_mb``) and the knobs ``async_inverse``,
            ``stat_compression`` and ``offload``.
        mesh: the grid from :func:`~kfac_tpu_torch.parallel.mesh.
            kaisa_mesh` or :func:`~kfac_tpu_torch.parallel.mesh.
            train_mesh`; its data-parallel shape is the gradient worker
            fraction. None builds the COMM-OPT grid over the default group.
        auto_layout: not ported yet (raises).

    The state lives on ``mesh.device``. Every method that moves data
    between ranks (``init`` does not) must be called by every rank.
    """

    config: Any  # a KFACPreconditioner
    mesh: Any = None
    auto_layout: Any = None

    def __post_init__(self) -> None:
        if self.auto_layout is not None:
            raise NotImplementedError(
                'DistributedKFAC(auto_layout=...) is not ported to kfac_tpu_torch yet'
            )
        for knob in _LATER_SLICE_KNOBS:
            if getattr(self.config, knob) not in (None, False):
                raise NotImplementedError(
                    f'{knob} on DistributedKFAC is not ported to kfac_tpu_torch yet'
                )
        if self.mesh is None:
            self.mesh = mesh_lib.kaisa_mesh(device=self.config.device)
        self.device = self.mesh.device
        self.registry = self.config.registry
        self.grad_workers = self.mesh.grad_workers
        # the KAISA strategy is the data-parallel grid's; the factor stores
        # and their decompositions shard over every rank
        self.world = self.mesh.world_size
        self.total_devices = self.mesh.total_devices
        if self.total_devices != self.world:
            for knob in _TP_LATER_KNOBS:
                if getattr(self.config, knob) not in (None, False):
                    raise NotImplementedError(
                        f'{knob} on DistributedKFAC over a grid with model or seq axes '
                        'is not ported to kfac_tpu_torch yet'
                    )
        if self.config.reduced_precision and (
            self.total_devices != self.world
            or any(h.weighted for h in self.config.registry.layers.values())
        ):
            raise NotImplementedError(
                f'DistributedKFAC with factor_dtype={self.config.factor_dtype}, '
                f'inv_dtype={self.config.inv_dtype} over a grid with model or seq axes, '
                'or with routed layers, is not ported to kfac_tpu_torch yet'
            )
        self.strategy = assignment_lib.strategy_for_fraction(
            self.world, self.grad_workers / self.world
        )
        self.granularity = int(self.config.bucket_granularity)
        self.buckets = build_buckets(self.registry, self.total_devices, self.granularity)
        self.colocate = bool(self.config.colocate_factors)
        # the reference's query surface (and its MEM-OPT => colocated rule)
        self.assignment = assignment_lib.KAISAAssignment(
            assignment_lib.compute_work_costs(self.registry.layers),
            world_size=self.world,
            grad_worker_fraction=self.grad_workers / self.world,
            colocate_factors=self.colocate,
        )
        self.a_store, self.g_store = build_stores(
            self.registry, self.total_devices, self.granularity, self.colocate, self.buckets
        )
        self._a_slot = {n: (sb.key, i) for sb in self.a_store for i, n in enumerate(sb.layers)}
        self._g_slot = {n: (sb.key, i) for sb in self.g_store for i, n in enumerate(sb.layers)}
        self._eigen = self.config.compute_method == enums.ComputeMethod.EIGEN
        self._prediv = self._eigen and self.config.prediv_eigenvalues
        if self._prediv and not self.colocate:
            raise NotImplementedError(
                'prediv_eigenvalues stores the fused per-layer eigenvalue '
                'grid, which requires colocate_factors=True'
            )
        if self.config.prediv_eigenvalues and not self._eigen:
            warnings.warn(
                'prediv_eigenvalues has no effect with the INVERSE compute method; ignoring',
                stacklevel=2,
            )
        # factor block k lives on rank _block_owner[k]; a column's blocks
        # are contiguous
        self._block = self.mesh.factor_block
        self._block_owner = [self.mesh.block_owner(k) for k in range(self.total_devices)]
        # tensor-parallel layers: name -> their parallel module
        self._tp_layers = {
            n: m for n, m in self.registry.modules.items() if tp_lib.layer_kind(m)
        }
        self._sharded_params = set(tp_lib.sharded_param_names(self.registry.model))
        # positions in registry order (the health and metrics vectors' order)
        names = list(self.registry.layers)
        pos = {n: i for i, n in enumerate(names)}

        def index(layers):
            return torch.tensor([pos[n] for n in layers], dtype=torch.long, device=self.device)

        self._index = {
            (side, sb.key): index(sb.layers)
            for side, store in (('a', self.a_store), ('g', self.g_store)) for sb in store
        }
        self._bucket_index = {b.key: index(b.layers) for b in self.buckets}
        order = [n for b in self.buckets for n in b.layers]
        # a bucket-ordered per-layer vector, taken in registry order
        self._to_registry = torch.tensor(
            [order.index(n) for n in names], dtype=torch.long, device=self.device
        )
        self._stores = {
            (side, sb.key): sb
            for side, store in (('a', self.a_store), ('g', self.g_store)) for sb in store
        }
        self._plan_async()
        self._plan_compression()
        self._plan_offload()

    def _plan_compression(self) -> None:
        """The compressed transport's chunk plan, the JAX engine's: the
        upper triangles of every layer's class-dim row, A stores then G
        stores, through ``plan_chunks`` at the byte cap. Each chunk's
        ``padded`` length is a multiple of ``world * block_size``, so each
        rank's slice of it is whole blocks. ``transport_counter`` adds up
        the collectives the stat transport runs and the bytes they move
        (host ints, from the buffers' sizes)."""
        ccfg = self.config.stat_compression
        self._compression = ccfg
        self._comp_plan = None
        self.transport_counter = {'collectives': 0, 'buffer_bytes': 0, 'ring_bytes': 0}
        if ccfg is None:
            return
        specs = [
            (sb.d * (sb.d + 1) // 2, 'float32')
            for store in (self.a_store, self.g_store) for sb in store for _ in sb.layers
        ]
        cap = self.config.allreduce_bucket_cap_mb
        quantum = self.world * ccfg.block_size
        self._comp_plan = [
            dict(c, padded=-(-c['elements'] // quantum) * quantum)
            for c in collectives.plan_chunks(specs, None if cap is None else cap * 1e6)
        ]

    def ef_slice(self, key: str, full: Any) -> torch.Tensor:
        """This rank's slice of chunk ``key``'s residual from the whole one
        (the JAX engine's replicated ``(elements,)`` vector, or a longer one
        whose tail past ``elements`` is zero): zero-padded to the chunk's
        ``padded`` length, then rank r's ``[r * per, (r + 1) * per)``."""
        plan = self._comp_plan[int(key[1:])]
        n, padded = plan['elements'], plan['padded']
        full = torch.as_tensor(full).to(self.device, torch.float32)[:n]
        per = padded // self.world
        full = torch.nn.functional.pad(full, (0, padded - n))
        return full[self.mesh.rank * per:(self.mesh.rank + 1) * per].clone()

    def _plan_offload(self) -> None:
        """This rank's offload manager (host state only; the config checks
        are the dense engine's)."""
        self._offload_manager = (
            None if self.config.offload is None else offload_lib.OffloadManager(self)
        )

    def _plan_async(self) -> None:
        """The async refresh's plan over the stacked stores, with the dense
        engine's attributes: units are storage buckets (a pair bucket under
        prediv), one batched decomposition a unit."""
        acfg = self.config.async_inverse
        self._async_mode = None if acfg is None else acfg.mode
        self._async_worker = None
        if acfg is None:
            return
        self._async_n_steps = int(self.config.inv_update_steps)
        if acfg.mode == 'sliced':
            units = async_sliced.kaisa_units(self)
            n = min(self._async_n_steps, acfg.max_slices or len(units))
            self._async_slices = async_slots.plan_slices(units, n)
            self._async_n_slices = len(self._async_slices)

    @property
    def health(self) -> health_lib.HealthConfig | None:
        return self.config.health

    @property
    def metrics(self) -> metrics_lib.MetricsConfig | None:
        return self.config.metrics

    @property
    def flight(self) -> flight_lib.FlightRecorderConfig | None:
        return self.config.flight

    # ------------------------------------------------------------- layout

    @property
    def factor_update_steps(self):
        return self.config.factor_update_steps

    def _factor_range(self, padded: int) -> tuple[int, int]:
        """Slots ``[lo, hi)`` of this rank's factor block of a stack."""
        per = padded // self.total_devices
        return self._block * per, (self._block + 1) * per

    def _column_range(self, padded: int) -> tuple[int, int]:
        """Slots ``[lo, hi)`` of this rank's column block: its resident
        decompositions and the gradients it preconditions."""
        per = padded // self.mesh.n_cols
        return self.mesh.col * per, (self.mesh.col + 1) * per

    def _live(self, layers: tuple[str, ...], lo: int, hi: int) -> torch.Tensor:
        """(hi - lo,) bool: which slots of ``[lo, hi)`` hold a layer (the
        rest are padding)."""
        return torch.arange(lo, hi, device=self.device) < len(layers)

    def _gather_blocks(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's factor block of a stack, gathered and put in slot
        order: the global stack."""
        parts = collectives.all_gather_cat(block, self.mesh.group).chunk(self.total_devices)
        return torch.cat([parts[self._block_owner[k]] for k in range(self.total_devices)])

    # --------------------------------------------------------------- init

    def init(self) -> DistKFACState:
        """This rank's shards: identity factors, zero decompositions; fresh
        health counters, metrics and flight ring where they are on."""
        dev = self.device
        state = DistKFACState(
            0, {}, {}, {}, {}, {}, {}, {}, {}, {},
            inv_damping=float(resolve(self.config.damping, 0)),
        )
        for store, fac, q, dvec, inv in (
            (self.a_store, state.a, state.qa, state.da, state.a_inv),
            (self.g_store, state.g, state.qg, state.dg, state.g_inv),
        ):
            fdt, idt = self.config.factor_dtype, self.config.inv_dtype
            for sb in store:
                lo, hi = self._factor_range(sb.padded)
                fac[sb.key] = torch.eye(sb.d, device=dev, dtype=fdt).repeat(hi - lo, 1, 1)
                clo, chi = self._column_range(sb.padded)
                if self._eigen:
                    q[sb.key] = torch.zeros((chi - clo, sb.d, sb.d), device=dev, dtype=idt)
                    if not self._prediv:
                        dvec[sb.key] = torch.zeros((chi - clo, sb.d), device=dev, dtype=idt)
                else:
                    inv[sb.key] = torch.zeros((chi - clo, sb.d, sb.d), device=dev, dtype=idt)
        if self._prediv:
            for b in self.buckets:
                clo, chi = self._column_range(b.padded)
                state.dgda[b.key] = torch.zeros(
                    (chi - clo, b.dg, b.da), device=dev, dtype=self.config.inv_dtype
                )
        names = list(self.registry.layers)
        if self.health is not None:
            state.health = health_lib.init_health(names, dev)
        if self.metrics is not None:
            state.metrics = metrics_lib.init_metrics(self.metrics, names, dev)
        if self.flight is not None:
            state.flight = flight_lib.init_flight(
                self.flight, metrics_lib.metric_keys(self.metrics, names), dev
            )
        if self._compression is not None and self._compression.error_feedback:
            state.comp_ef = {
                f'c{i}': torch.zeros((ch['padded'] // self.world,), device=dev)
                for i, ch in enumerate(self._comp_plan)
            }
        if self._async_mode == 'sliced':
            state.shadow = async_sliced.kaisa_shadow(self, state)
        return state

    # ------------------------------------------------------------- health

    def _block_mults(self, state: DistKFACState, side: str, sb: StorageBucket) -> torch.Tensor:
        """(L / world,) damping multipliers of this rank's factor block of a
        side store (padding slots at 1)."""
        lo, hi = self._factor_range(sb.padded)
        return health_lib.slot_mults(
            state.health.damping_mult, self._index[side, sb.key], sb.padded
        )[lo:hi]

    def _exchange(self, parts: list[tuple[int, str, StorageBucket, torch.Tensor]], width: int) -> torch.Tensor:
        """Per-layer values judged on the ranks that own them, on every
        rank: each part ``(offset, side, store, values)`` gives the (L /
        world,) values of this rank's factor block of a store, which land at
        ``offset`` + the layer positions of its live slots in a zero vector
        of ``width`` (parts that share positions add up); one
        ``all_reduce`` sums the ranks' vectors. Every position has one
        owner, so the sum is the owner's bits exactly."""
        out = torch.zeros((width,), dtype=torch.float32, device=self.device)
        for offset, side, sb, values in parts:
            lo, hi = self._factor_range(sb.padded)
            live = max(0, min(hi, len(sb.layers)) - lo)
            if live:
                out.index_add_(
                    0, offset + self._index[side, sb.key][lo:lo + live], values[:live].float()
                )
        return collectives.all_reduce_sum([out], self.mesh.group)[0]

    # ------------------------------------------------------------ factors

    def _weights(self, stats: capture_lib.CapturedStats) -> tuple[list[str], torch.Tensor | None]:
        """The captured routed layers, in registry order, and this rank's
        (2 n,) weight vector: their A weights, then their G weights (``wg``,
        else ``w``); None when no captured layer carries a weight."""
        names = [n for n in self.registry.layers if n in stats.w and n in stats.a]
        if not names:
            return names, None
        return names, torch.stack(
            [stats.w[n].float() for n in names]
            + [stats.wg.get(n, stats.w[n]).float() for n in names]
        )

    def _reduce_stats(
        self, state: DistKFACState, stats: capture_lib.CapturedStats
    ) -> tuple[
        dict[str, torch.Tensor], dict[str, torch.Tensor], dict[str, torch.Tensor] | None,
        dict[str, torch.Tensor],
    ]:
        """The world's statistics from this rank's: ``(a, g, comp_ef, w)``,
        name -> class-dim factor for every captured layer (every layer
        with ``stat_compression``), the new error-feedback residual (the
        state's, unchanged, without compression), and name -> the global
        evidence weight of each captured routed layer.

        ``ALLREDUCE`` sums each true-dim factor in its own all-reduce;
        ``ALLREDUCE_BUCKETED`` packs the upper triangles of the class-dim
        factors, A stores then G stores, into flat buffers of at most
        ``allreduce_bucket_cap_mb`` and all-reduces each buffer. With
        ``stat_compression`` the buffers hold every layer, as the JAX
        engine's do (:meth:`_compressed_rows`).

        Scale: each rank's A is its rows' ``a^T a / rows``, so the mean
        over equal row blocks is the global one (sum / W). Its G comes
        from the cotangents of the mean loss over its own rows, ``W``
        times the global mean loss's, so its ``g^T g / rows`` is ``W^2``
        times what the global batch's rows give, and the global G is the
        sum / W^3. (Under pjit the JAX capture sees the global
        cotangents.) W is the number of ranks of ``stat_group``, over
        which the sums run: the data-parallel ranks times the sequence
        shards (a sequence shard's loss is the mean over its own tokens,
        whose cotangents reach the other shards' layers through the ring,
        so the same count holds). The model ranks of a group hold the same
        statistics and reduce within their own ``stat_group``.

        Routed layers: the ranks route different numbers of tokens to an
        expert, so the mean of their live-normalized factors is not the
        global one. A rank sends ``w_r F_r`` (its rows' ``a^T a`` over its
        row count) and ``w_r`` (its live fraction); the global factor is
        ``sum_r w_r F_r / sum_r w_r`` in the world's scale, the global
        weight the mean of the ``w_r``, and G likewise with its G-side
        weights. The weights ride as one (2 n,) f32 vector in the same
        collectives: the last tensor of the bucketed buffers, or one more
        tensor of the per-layer all-reduces. The compressed transport
        reduces them first (:meth:`_compressed_rows`).
        """
        cfg = self.config
        if self._compression is not None:
            return self._compressed_rows(state, stats)
        routed, w_vec = self._weights(stats)
        order = [
            (side, n, sb.d)
            for side, store, side_stats in (('a', self.a_store, stats.a), ('g', self.g_store, stats.g))
            for sb in store for n in sb.layers if n in side_stats
        ]
        k = len(routed)
        pos = {n: i for i, n in enumerate(routed)}

        def sent(side, n):
            # in factor_dtype, as the JAX engine reduces them
            m = (stats.a if side == 'a' else stats.g)[n].to(cfg.factor_dtype)
            if n in pos:
                m = m * w_vec[pos[n] + (k if side == 'g' else 0)]
            return m

        raw = [sent(side, n) for side, n, _ in order]
        if cfg.allreduce_method == enums.AllreduceMethod.ALLREDUCE_BUCKETED:
            cap = cfg.allreduce_bucket_cap_mb
            tris = [collectives.get_triu(pad_factor(m, d)) for m, (_, _, d) in zip(raw, order)]
            if w_vec is not None:
                tris.append(w_vec)
            chunks = collectives.concat_flat_chunked(tris, None if cap is None else cap * 1e6)
            for flat, _ in chunks:
                self._count('all_reduce', flat)
                dist.all_reduce(flat, group=self.mesh.stat_group)
            flat_out = collectives.split_flat_chunked(chunks)
            summed = [collectives.fill_triu((d, d), t) for t, (_, _, d) in zip(flat_out, order)]
        else:
            if w_vec is not None:
                raw.append(w_vec)
            flat_out = collectives.all_reduce_sum(raw, self.mesh.stat_group)
            summed = [pad_factor(m, d) for m, (_, _, d) in zip(flat_out, order)]
        w_stat = self.mesh.stat_world
        scale = {'a': float(w_stat), 'g': float(w_stat) ** 3}
        out: dict[str, dict[str, torch.Tensor]] = {'a': {}, 'g': {}}
        for (side, n, _), m in zip(order, summed):
            out[side][n] = m / scale[side]
        weights: dict[str, torch.Tensor] = {}
        if w_vec is not None:
            mean_w = flat_out[-1] / w_stat
            divisor = torch.clamp(mean_w, min=capture_lib.WEIGHT_FLOOR)
            for i, n in enumerate(routed):
                out['a'][n] = out['a'][n] / divisor[i]
                out['g'][n] = out['g'][n] / divisor[k + i]
                weights[n] = mean_w[i]
        return out['a'], out['g'], state.comp_ef, weights

    def _count(self, op: str, buffer: torch.Tensor) -> None:
        """Add one stat-transport collective to ``transport_counter``: its
        buffer's bytes (the input of an all-reduce or reduce-scatter, the
        output of an all-gather) and the bytes a rank sends under ring
        algorithms (2 (W-1)/W of the buffer for an all-reduce, (W-1)/W for
        the others)."""
        b = buffer.numel() * buffer.element_size()
        w = self.mesh.stat_world
        ring = (2 if op == 'all_reduce' else 1) * b * (w - 1) // w
        c = self.transport_counter
        c['collectives'] += 1
        c['buffer_bytes'] += b
        c['ring_bytes'] += ring

    def _compressed_rows(
        self, state: DistKFACState, stats: capture_lib.CapturedStats
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
        """The compressed transport: every layer's class-dim row in the
        global scale, ``deq(quant(sum + ef))`` chunk by chunk.

        A rank's contribution to a captured layer's row is its statistic
        over its ``scale`` (a power of two for the usual worlds, so exact),
        with the identity of the class-dim padding from rank 0 alone; to a
        layer without statistics, the factor itself from the rank that holds
        its slot (zeros from the others), as the JAX engine packs the
        state's row. Sums with zeros are exact, so the global row is the
        JAX engine's.

        Each chunk, zero-padded to ``padded`` (zeros move no block's
        scale), is reduce-scattered: rank r holds elements ``[r * per, (r +
        1) * per)`` of the sum, whole blocks. It adds its residual slice,
        quantizes, keeps ``carried - deq`` as its new residual slice, and
        the payload (fp8 as its ``uint8`` bits) and the scales are
        all-gathered, so every rank dequantizes the same chunk. With one
        rank no collective runs. The quantization and the dequantization
        run under the profiler scopes ``kfac.stat_quantize`` and
        ``kfac.stat_dequantize``.

        Routed layers: the ranks' weights are all-reduced first, in f32
        outside the quantized payload (one small collective), and a rank
        sends ``w_r F_r / (scale * max(mean w, WEIGHT_FLOOR))``, so the
        chunk's sum is the global normalized factor, the value the JAX
        engine quantizes.
        """
        ccfg = self._compression
        w, bs = self.world, ccfg.block_size
        scale = {'a': float(w), 'g': float(w) ** 3}
        routed, w_vec = self._weights(stats)
        weights: dict[str, torch.Tensor] = {}
        factor = {}  # side, name -> what multiplies a routed statistic
        if w_vec is not None:
            mean_w = w_vec
            if w > 1:
                self._count('all_reduce', w_vec)
                mean_w = collectives.all_reduce_sum([w_vec], self.mesh.group)[0] / w
            divisor = torch.clamp(mean_w, min=capture_lib.WEIGHT_FLOOR)
            k = len(routed)
            for i, n in enumerate(routed):
                factor['a', n] = w_vec[i] / divisor[i]
                factor['g', n] = w_vec[k + i] / divisor[k + i]
                weights[n] = mean_w[i]
        rows = []
        for side, store, side_stats, fac in (
            ('a', self.a_store, stats.a, state.a), ('g', self.g_store, stats.g, state.g),
        ):
            for sb in store:
                lo, hi = self._factor_range(sb.padded)
                for i, n in enumerate(sb.layers):
                    if n in side_stats:
                        m = side_stats[n].float() / scale[side]
                        if (side, n) in factor:
                            m = m * factor[side, n]
                        m = pad_factor(m, sb.d) if self.mesh.rank == 0 else pad_grad(m, sb.d, sb.d)
                    elif lo <= i < hi:
                        m = fac[sb.key][i - lo]
                    else:
                        m = torch.zeros((sb.d, sb.d), device=self.device)
                    rows.append((side, n, sb.d, collectives.get_triu(m)))
        cap = self.config.allreduce_bucket_cap_mb
        chunks = collectives.concat_flat_chunked(
            [r[3] for r in rows], None if cap is None else cap * 1e6
        )
        ef_in = state.comp_ef
        ef_out: dict[str, torch.Tensor] = {}
        deqs = []
        for i, ((flat, specs), plan) in enumerate(zip(chunks, self._comp_plan)):
            key = f'c{i}'
            n, padded = flat.shape[0], plan['padded']
            per = padded // w
            full = torch.nn.functional.pad(flat, (0, padded - n))
            if w == 1:
                part = full
            else:
                part = torch.empty((per,), device=self.device)
                self._count('reduce_scatter', full)
                collectives.reduce_scatter(part, full, self.mesh.group)
            with torch.profiler.record_function('kfac.stat_quantize'):
                carried = part if ef_in is None else part + ef_in[key]
                payload, scales = quant_lib.quantize_blockwise(carried, ccfg.dtype, bs)
                if ef_in is not None:
                    ef_out[key] = carried - quant_lib.dequantize_blockwise(payload, scales, per, bs)
            if w > 1:
                wire = payload.view(torch.uint8) if ccfg.dtype == 'fp8' else payload
                wire = collectives.all_gather_cat(wire, self.mesh.group)
                self._count('all_gather', wire)
                payload = wire.view(payload.dtype)
                scales = collectives.all_gather_cat(scales, self.mesh.group)
                self._count('all_gather', scales)
            with torch.profiler.record_function('kfac.stat_dequantize'):
                deqs.append((quant_lib.dequantize_blockwise(payload, scales, n, bs), specs))
        out: dict[str, dict[str, torch.Tensor]] = {'a': {}, 'g': {}}
        for (side, n, d, _), t in zip(rows, collectives.split_flat_chunked(deqs)):
            out[side][n] = collectives.fill_triu((d, d), t)
        return out['a'], out['g'], (ef_out if ef_in is not None else None), weights

    def update_factors(
        self, state: DistKFACState, stats: capture_lib.CapturedStats
    ) -> DistKFACState:
        """EMA update of this rank's factor blocks from the world's
        statistics (:meth:`_reduce_stats`: every rank passes its own, from
        the mean loss over its own equal row block). Registered layers
        absent from ``stats`` keep their factors, as in the JAX engine.

        With health, each rank judges its block's slots (finite, and the
        Gershgorin condition bound at the slot's effective damping), the
        verdicts reach every rank in one ``all_reduce``, and a layer whose A
        or G slot failed rolls both back (``torch.where`` per slot) and
        escalates its damping, as the JAX engine's stacked sentinel does.

        A store that holds a captured routed layer decays slot by slot: a
        (slots, 1, 1) ``effective_alpha`` with the layer's global weight
        (:meth:`_reduce_stats`) and w = 1 for the other slots and the
        padding; the other stores keep the scalar decay.
        """
        alpha = resolve(self.config.factor_decay, state.step)
        red_a, red_g, comp_ef, red_w = self._reduce_stats(state, stats)
        new = {}
        for side, store, fac, red in (
            ('a', self.a_store, state.a, red_a), ('g', self.g_store, state.g, red_g),
        ):
            new[side] = {}
            for sb in store:
                lo, hi = self._factor_range(sb.padded)
                rows = []
                fdt = self.config.factor_dtype
                for s in range(lo, hi):
                    if s >= len(sb.layers):
                        rows.append(torch.eye(sb.d, device=self.device, dtype=fdt))
                    else:
                        rows.append(red.get(sb.layers[s], fac[sb.key][s - lo]))
                decay = alpha
                if any(n in red_w for n in sb.layers[lo:hi]):
                    one = torch.ones((), device=self.device)
                    w = torch.stack([
                        red_w.get(sb.layers[s], one) if s < len(sb.layers) else one
                        for s in range(lo, hi)
                    ])
                    decay = factors_lib.effective_alpha(alpha, w)[:, None, None]
                new[side][sb.key] = (
                    decay * fac[sb.key] + (1 - decay) * torch.stack(rows)
                ).to(fdt)
        names = list(self.registry.layers)
        touched = [i for i, n in enumerate(names) if n in stats.a or n in stats.g]
        ok = None  # (L,) layer verdicts, with health
        health = state.health
        if self.health is not None and touched:
            hc = self.health
            damping = resolve(self.config.damping, state.step)
            n = len(names)
            bad = self._exchange([
                (k * n, side, sb, ~health_lib.factor_ok(
                    new[side][sb.key], damping * self._block_mults(state, side, sb),
                    hc.quarantine_threshold,
                ))
                for k, (side, store) in enumerate((('a', self.a_store), ('g', self.g_store)))
                for sb in store
            ], 2 * n)
            ok = (bad[:n] + bad[n:]) == 0
            idx = health_lib.positions(touched, n, self.device)
            roll = ~ok
            if idx is not None:  # only the touched layers roll back
                roll = roll & torch.zeros_like(roll).index_fill_(0, idx, True)
            for side, store, old in (('a', self.a_store, state.a), ('g', self.g_store, state.g)):
                for sb in store:
                    lo, hi = self._factor_range(sb.padded)
                    mask = health_lib.slot_mask(roll, self._index[side, sb.key], sb.padded)[lo:hi]
                    new[side][sb.key] = torch.where(
                        mask[:, None, None], old[sb.key], new[side][sb.key]
                    )
            fields = (health.damping_mult, health.quarantined, health.quarantine_events)
            moved = health_lib.quarantine_update(
                hc, ok if idx is None else ok[idx], *(f if idx is None else f[idx] for f in fields)
            )
            mult, quarantined, events = (
                m if idx is None else f.index_copy(0, idx, m) for f, m in zip(fields, moved)
            )
            health = dataclasses.replace(
                health, damping_mult=mult, quarantined=quarantined, quarantine_events=events
            )
        state = dataclasses.replace(state, a=new['a'], g=new['g'], health=health, comp_ef=comp_ef)
        if self.metrics is not None and state.metrics is not None and touched:
            state = dataclasses.replace(
                state, metrics=self._record_factor_metrics(state, touched, ok)
            )
        return state

    def _record_factor_metrics(
        self, state: DistKFACState, touched: list[int], ok: torch.Tensor | None
    ) -> metrics_lib.MetricsState:
        """The factor phase's metrics on the factors after any rollback:
        the Gershgorin bounds of each layer's true-dim block, computed by
        the rank that owns its slot and exchanged in one ``all_reduce``,
        and ``last_factor_step`` advanced for the ``touched`` layers where
        ``ok`` (None: every one)."""
        ms = state.metrics
        names = list(self.registry.layers)
        n = len(names)
        if self.metrics.factor_bounds:
            parts = []
            for k, (side, store, fac) in enumerate(
                (('a', self.a_store, state.a), ('g', self.g_store, state.g))
            ):
                for sb in store:
                    lo, hi = self._factor_range(sb.padded)
                    live = range(lo, min(hi, len(sb.layers)))
                    if not live:
                        continue
                    block = fac[sb.key]
                    lmin, lmax = metrics_lib.gershgorin_bounds_each(
                        [block[s - lo, :sb.dims[s], :sb.dims[s]] for s in live]
                    )
                    parts += [(2 * k * n, side, sb, lmin), ((2 * k + 1) * n, side, sb, lmax)]
            bounds = self._exchange(parts, 4 * n)
            values = dict(zip(
                ('factor_lmin/a', 'factor_lmax/a', 'factor_lmin/g', 'factor_lmax/g'),
                bounds.view(4, n),
            ))
            if len(touched) == n:
                ms = metrics_lib.set_families(ms, values)
            else:
                ms = metrics_lib.update_scalars(ms, {
                    f'{f}/{names[i]}': v[i] for f, v in values.items() for i in touched
                })
        if len(touched) == n:
            last = metrics_lib.advance_all(ms.last_factor_step, ok, state.step)
        else:
            last = metrics_lib.advance_last(
                ms.last_factor_step, ms.names,
                {names[i]: None if ok is None else ok[i] for i in touched}, state.step,
            )
        return dataclasses.replace(ms, last_factor_step=last)

    # ----------------------------------------------------------- inverses

    def _sharded_inv(
        self, block: torch.Tensor, damping: float, prev: torch.Tensor, live: torch.Tensor
    ) -> torch.Tensor:
        """Damped inverses of this rank's factor block; ``prev`` (the
        resident inverses of the same slots) warm-starts Newton-Schulz per
        slot behind its safeguard; the padding slots (``live`` False) never
        iterate."""
        cfg = self.config
        if cfg.inverse_solver == 'auto':
            return factors_lib.batched_damped_inverse_auto(
                block, damping, cfg.newton_schulz_iters, x0=prev, live=live
            )
        if cfg.inverse_solver == 'newton_schulz':
            return factors_lib.newton_schulz_inverse_stacked(
                block, damping, cfg.newton_schulz_iters, x0=prev, live=live
            ).inverse
        return factors_lib.compute_inverse(block, damping)

    def update_inverses(self, state: DistKFACState) -> DistKFACState:
        """Decompose (EIGEN) or invert (INVERSE) this rank's factor blocks,
        then gather each column's blocks on every rank of the column (the
        inverse broadcast: one all-gather a stack and field).

        With health, the INVERSE and prediv refreshes run at each slot's
        effective damping; each rank judges its block's outputs (a slot
        that is not finite keeps its previous decomposition) and the
        verdicts reach every rank in one ``all_reduce``, so ``bad_inv``
        counts a layer up when its A or G refresh failed or ran from a
        quarantined factor, as in the JAX engine."""
        hc = self.health
        damping = float(resolve(self.config.damping, state.step))
        sub = self.mesh.col_index  # this rank's block within its column's
        verdicts = []  # with health: (offset, side, store, bad slots)
        n = len(self.registry.layers)

        def checked(side, sb, cand, judged=()):
            """``cand`` (this block's outputs, field -> tensor) with health:
            each slot kept where its outputs (and ``judged``) are finite,
            else the resident decomposition of the same slot."""
            if hc is None:
                return cand
            ok = torch.stack([
                torch.isfinite(v).flatten(1).all(dim=1) for v in (*cand.values(), *judged)
            ]).all(dim=0)
            verdicts.append((0 if side == 'a' else n, side, sb, ~ok))
            lo, hi = self._factor_range(sb.padded)
            per = hi - lo
            return {
                f: torch.where(
                    ok.view((-1,) + (1,) * (v.ndim - 1)), v,
                    getattr(state, f)[sb.key][sub * per:(sub + 1) * per],
                )
                for f, v in cand.items()
            }

        units = [u for u, _ in async_sliced.kaisa_units(self)]
        updates = self.refresh_units(state, units, damping, checked)
        state = dataclasses.replace(state, **updates, inv_damping=damping)
        ok = None
        if hc is not None:
            bad = self._exchange(verdicts, 2 * n)
            ok = (bad[:n] + bad[n:]) == 0
            h = state.health
            state = dataclasses.replace(state, health=dataclasses.replace(
                h, bad_inv=health_lib.inversion_update(hc, ok, h.quarantined, h.bad_inv)
            ))
        if self.metrics is not None and state.metrics is not None:
            ms = state.metrics
            state = dataclasses.replace(state, metrics=dataclasses.replace(
                ms, last_inv_step=metrics_lib.advance_all(ms.last_inv_step, ok, state.step)
            ))
        return state

    def refresh_units(self, state: DistKFACState, units, damping: float, checked=None):
        """The refresh of some storage buckets: ``units`` are ``(side,
        key)`` (``'a'``, ``'g'``, or ``'ag'`` for a pair bucket under
        prediv), in an order every rank shares. This rank decomposes its
        factor block of each, and each field is all-gathered within the
        column. Returns ``{field: {key: column block}}``.

        ``checked(side, store, cand, judged)`` filters this rank's
        outputs before the gather (the synchronous refresh's health); the
        sliced refresh passes none. With health the INVERSE and prediv
        outputs are at each slot's effective damping."""
        cfg = self.config
        col = self.mesh.col_group
        sub = self.mesh.col_index
        updates: dict[str, dict[str, torch.Tensor]] = {}

        def keep(side, sb, cand, judged=()):
            return cand if checked is None else checked(side, sb, cand, judged)

        def gather(field, key, v):
            updates.setdefault(field, {})[key] = collectives.all_gather_cat(v, col)

        def damping_of(side, sb):
            return damping if self.health is None else damping * self._block_mults(state, side, sb)

        for side, key in units:
            if self._eigen:
                eig = {}
                for s in (('a', 'g') if side == 'ag' else (side,)):
                    sb = self._stores[s, key]
                    d_, q_ = factors_lib.batched_eigh(getattr(state, s)[key], cfg.eigh_impl)
                    d_ = torch.clamp(d_, min=0.0)
                    cand = {'q' + s: q_.to(cfg.inv_dtype)}
                    if not self._prediv:
                        cand['d' + s] = d_.to(cfg.inv_dtype)
                    for f, v in keep(s, sb, cand, (d_,) if self._prediv else ()).items():
                        gather(f, key, v)
                    eig[s] = d_
                if side == 'ag':
                    sb = self._stores['a', key]
                    fused = factors_lib.prediv_eigenvalues(
                        factors_lib.EigenDecomp(None, eig['a']),
                        factors_lib.EigenDecomp(None, eig['g']),
                        damping_of('a', sb),
                    )
                    gather('dgda', key, keep('a', sb, {'dgda': fused.to(cfg.inv_dtype)})['dgda'])
            else:
                sb = self._stores[side, key]
                field = side + '_inv'
                lo, hi = self._factor_range(sb.padded)
                per = hi - lo
                cand = self._sharded_inv(
                    getattr(state, side)[key], damping_of(side, sb),
                    getattr(state, field)[key][sub * per:(sub + 1) * per],
                    self._live(sb.layers, lo, hi),
                ).to(cfg.inv_dtype)
                gather(field, key, keep(side, sb, {field: cand})[field])
        return updates

    def inverse_residuals(self, state: DistKFACState) -> dict[str, dict[str, torch.Tensor]]:
        """Per slot, the relative identity residual ``||I - (F + damping I)
        F_inv||_F / sqrt(d)`` of the resident inverses, at the damping they
        were built with: ``{'a': {key: (L,)}, 'g': {...}}`` over the global
        stacks (each rank computes its factor block's, then they are
        gathered). INVERSE only."""
        if self._eigen:
            raise ValueError(
                'inverse_residuals applies to the INVERSE compute method; '
                'the EIGEN path reconstructs from eigendecompositions '
                'whose quality is a property of eigh, not an iteration'
            )
        out: dict[str, dict[str, torch.Tensor]] = {}
        for side, store, fac, inv in (
            ('a', self.a_store, state.a, state.a_inv), ('g', self.g_store, state.g, state.g_inv),
        ):
            out[side] = {}
            for sb in store:
                lo, hi = self._factor_range(sb.padded)
                per = hi - lo
                sub = self.mesh.col_index
                finv = inv[sb.key][sub * per:(sub + 1) * per]
                eye = torch.eye(sb.d, device=self.device)
                r = eye - (fac[sb.key] + state.inv_damping * eye) @ finv
                res = torch.sqrt(torch.sum(r * r, dim=(-2, -1)) / sb.d)
                out[side][sb.key] = self._gather_blocks(res)
        return out

    # ------------------------------------------------------- precondition

    def precondition(
        self,
        state: DistKFACState,
        grads: dict[str, torch.Tensor],
        metrics_out: dict[str, torch.Tensor] | None = None,
    ) -> dict[str, torch.Tensor]:
        """Precondition the global mean grads (a ``named_parameters``-keyed
        dict, the same on every rank): each rank preconditions its
        column's slots with its resident decompositions (batched
        products), the row all-gathers the stacks (the gradient
        broadcast), and the kl-clip scale of every layer's true-dim matrix
        comes from one launch of the grouped kl-clip dot and is applied in
        one launch of its scale, as in the dense engine.

        With ``colocate_factors=False`` a pair bucket's rows of the side
        stores are assembled from the full side stacks, gathered within
        the row first (the decomposition exchange non-colocation pays
        for).

        A tensor-parallel layer's gradient is gathered over the model group
        first (one all-gather of every such layer's shards), preconditioned
        and kl-clipped whole, the same on every model rank, and the rank's
        shard of the result is returned.

        With health, the EIGEN path preconditions each slot at its
        effective damping (INVERSE and prediv bake it into the refresh),
        and a degraded layer's slot carries its raw gradient (still
        kl-clipped with the rest). ``metrics_out``, when given, gets the
        dense engine's metric families in registry order: ``damping_eff``,
        ``kl_clip_scale`` and, with ``grad_norms``, ``grad_norm`` and
        ``precond_grad_norm`` from the norm instantiation of the kl-clip
        dot (still one launch).
        """
        cfg = self.config
        damping = resolve(cfg.damping, state.step)
        row = self.mesh.row_group
        layer_grads = self._gather_tp_grads(registry_lib.slice_layer_grads(grads, self.registry))
        idt = cfg.inv_dtype  # the preconditioning's; the kl-clip runs in f32
        gmats = {
            n: h.grads_to_matrix(layer_grads[n]).float()
            for n, h in self.registry.layers.items()
        }
        degraded = (
            None if self.health is None
            else health_lib.is_degraded(self.health, state.health.bad_inv)
        )
        full: dict[str, dict[str, torch.Tensor]] = {}
        if not self.colocate:
            # every side stack, gathered within the row in one order on
            # every rank (the decomposition exchange)
            fields = ('qa', 'da', 'qg', 'dg') if self._eigen else ('a_inv', 'g_inv')
            full = {
                f: {k: collectives.all_gather_cat(v, row) for k, v in getattr(state, f).items()}
                for f in fields
            }

        def side_rows(field, slot_map, names, shape):
            """Rows of the full side stacks' ``field`` for ``names`` (zeros
            for padding)."""
            return torch.stack([
                torch.zeros(shape, device=self.device, dtype=idt) if n is None
                else full[field][slot_map[n][0]][slot_map[n][1]]
                for n in names
            ])

        pmats: dict[str, torch.Tensor] = {}
        for b in self.buckets:
            lo, hi = self._column_range(b.padded)
            names = [b.layers[s] if s < len(b.layers) else None for s in range(lo, hi)]
            gstack = torch.stack([
                torch.zeros((b.dg, b.da), device=self.device, dtype=idt) if n is None
                else pad_grad(gmats[n].to(idt), b.dg, b.da)
                for n in names
            ])

            def dec(field, side_key_map, shape):
                if self.colocate:
                    return getattr(state, field)[b.key]
                return side_rows(field, side_key_map, names, shape)

            if self._prediv:
                qa, qg = state.qa[b.key], state.qg[b.key]
                pstack = qg @ ((qg.mT @ gstack @ qa) * state.dgda[b.key]) @ qa.mT
            elif self._eigen:
                dmp = damping if self.health is None else damping * health_lib.slot_mults(
                    state.health.damping_mult, self._bucket_index[b.key], b.padded
                )[lo:hi]
                pstack = factors_lib.eigen_preconditioned_grad(
                    gstack,
                    factors_lib.EigenDecomp(
                        dec('qa', self._a_slot, (b.da, b.da)), dec('da', self._a_slot, (b.da,))
                    ),
                    factors_lib.EigenDecomp(
                        dec('qg', self._g_slot, (b.dg, b.dg)), dec('dg', self._g_slot, (b.dg,))
                    ),
                    dmp,
                )
            else:
                pstack = factors_lib.inverse_preconditioned_grad(
                    gstack,
                    dec('a_inv', self._a_slot, (b.da, b.da)),
                    dec('g_inv', self._g_slot, (b.dg, b.dg)),
                )
            if degraded is not None:
                # graceful degradation: the slot's raw gradient (its
                # padding is zero, so the true-dim block is the gradient)
                mask = health_lib.slot_mask(degraded, self._bucket_index[b.key], b.padded)[lo:hi]
                pstack = torch.where(mask[:, None, None], gstack, pstack)
            # the gradient broadcast: every column's block on every rank
            pfull = collectives.all_gather_cat(pstack, row)
            for i, name in enumerate(b.layers):
                dag, dgg = b.dims[i]
                pmats[name] = pfull[i, :dgg, :dag].float().contiguous()

        names = [n for b in self.buckets for n in b.layers]
        pm = [pmats[n] for n in names]
        norms = metrics_out is not None and self.metrics.grad_norms and bool(pm)
        scale = None
        if pm and (cfg.kl_clip is not None or norms):
            lr = resolve(cfg.lr, state.step)
            kl_clip = 1.0 if cfg.kl_clip is None else resolve(cfg.kl_clip, state.step)
            gm = [gmats[n] for n in names]
            if norms:
                _, _, scale, g_sq, p_sq = klclip.klclip_dot_norms_many(pm, gm, lr, kl_clip)
            else:
                _, _, scale = klclip.klclip_dot_many(pm, gm, lr, kl_clip)
            if cfg.kl_clip is None:
                scale = None
            else:
                pm = factors_lib.kl_clip_apply_many_(pm, scale)
        if metrics_out is not None:
            dev = self.device
            metrics_out['kl_clip_scale'] = torch.ones((), device=dev) if scale is None else scale
            if norms:
                # the kernel's order is the buckets'; the families' the registry's
                p_norm = torch.sqrt(p_sq)[self._to_registry]
                metrics_out['grad_norm'] = torch.sqrt(g_sq)[self._to_registry]
                metrics_out['precond_grad_norm'] = (
                    p_norm if scale is None else p_norm * torch.abs(scale)
                )
            metrics_out['damping_eff'] = (
                damping * state.health.damping_mult if self.health is not None
                else torch.full((len(names),), damping, device=dev)
            )
        out = {
            n: self.registry.layers[n].matrix_to_grads(p.to(layer_grads[n]['weight'].dtype))
            for n, p in zip(names, pm)
        }
        for n, mod in self._tp_layers.items():  # this rank's shards
            for leaf, dim in mod.shard_dims.items():
                if leaf in out.get(n, {}):
                    out[n][leaf] = tp_lib.shard_of(out[n][leaf], dim, mod.index, mod.size).contiguous()
        return registry_lib.merge_layer_grads(grads, out, self.registry)

    def _gather_tp_grads(
        self, layer_grads: dict[str, dict[str, torch.Tensor]]
    ) -> dict[str, dict[str, torch.Tensor]]:
        """The tensor-parallel layers' sharded grads made whole: every such
        shard in one flat buffer, one all-gather over the model group, each
        parameter's shards concatenated along its sharded axis."""
        parts = [
            (n, leaf, dim) for n, mod in self._tp_layers.items()
            for leaf, dim in mod.shard_dims.items() if leaf in layer_grads[n]
        ]
        if not parts:
            return layer_grads
        flat, specs = collectives.concat_flat([layer_grads[n][leaf] for n, leaf, _ in parts])
        ranks = collectives.all_gather_cat(flat, self.mesh.model_group).chunk(self.mesh.model)
        by_rank = [collectives.split_flat(r, specs) for r in ranks]
        out = {n: dict(v) for n, v in layer_grads.items()}
        for i, (n, leaf, dim) in enumerate(parts):
            out[n][leaf] = torch.cat([r[i] for r in by_rank], dim=dim)
        return out

    # --------------------------------------------------------------- step

    def average_grads(
        self, grads: dict[str, torch.Tensor], loss: torch.Tensor
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """The mean over the ranks of each rank's grads and loss (from its
        own row block), in flat buffers of at most
        ``allreduce_bucket_cap_mb``: the global mean grads and loss that
        pjit hands the JAX engine.

        On a grid with a ``model`` axis the shards of tensor-parallel
        parameters are averaged over the ranks that hold the same shard
        (``stat_group``: the data and sequence ranks); the replicated
        parameters and the loss, the same on every model rank, over every
        rank, so that they are bitwise equal on every rank."""
        cap = None if self.config.allreduce_bucket_cap_mb is None else (
            self.config.allreduce_bucket_cap_mb * 1e6
        )
        replicated = {n: g for n, g in grads.items() if n not in self._sharded_params}
        mean, (loss,) = collectives.mean_grads(
            replicated, self.mesh.group, cap, extra=[loss.detach().float().reshape(1)],
        )
        sharded = {n: g for n, g in grads.items() if n in self._sharded_params}
        if sharded:
            mean.update(collectives.mean_grads(sharded, self.mesh.stat_group, cap)[0])
        return {n: mean[n] for n in grads}, loss[0]

    def step(
        self,
        state: DistKFACState,
        grads: dict[str, torch.Tensor],
        stats: capture_lib.CapturedStats | None,
        loss: torch.Tensor | None = None,
    ) -> tuple[DistKFACState, dict[str, torch.Tensor]]:
        """One KAISA step, the dense engine's pipeline: the factor update on
        its cadence (``stats`` this rank's, None to skip), the refresh on
        its cadence, then preconditioning of the global mean ``grads``.
        With metrics, the step's scalars and staleness go into
        ``state.metrics``; with the flight recorder, one ring row then
        records them beside ``loss`` (when given) and the grads' global
        norm, the same row on every rank.

        Under ``async_inverse`` the sliced or host stage takes the place of
        the refresh cadence. A spilled state (cold-factor offload) skips
        the factor and refresh work: the pump restores the factors before
        every step that would do it, on every rank alike."""
        cfg = self.config
        step = state.step
        spilled = offload_lib.is_spilled(state)
        if (
            stats is not None and not spilled
            and step % resolve(cfg.factor_update_steps, step) == 0
        ):
            state = self.update_factors(state, stats)
        if spilled:
            pass
        elif self._async_mode == 'sliced':
            state = async_sliced.kaisa_async_step(self, state)
        elif self._async_mode == 'host':
            state = async_host.kaisa_host_step(self, state)
        elif step % resolve(cfg.inv_update_steps, step) == 0:
            state = self.update_inverses(state)
        if self.metrics is not None and state.metrics is not None:
            families: dict[str, torch.Tensor] = {}
            new_grads = self.precondition(state, grads, metrics_out=families)
            ms = metrics_lib.set_families(state.metrics, families)
            state = dataclasses.replace(
                state, metrics=metrics_lib.finalize(ms, self.metrics, step)
            )
        else:
            new_grads = self.precondition(state, grads)
        if self.flight is not None and state.flight is not None:
            state = dataclasses.replace(state, flight=flight_lib.record(
                state.flight, step, state.metrics.scalars, loss=loss,
                grad_norm=flight_lib.global_grad_norm(grads),
            ))
        return dataclasses.replace(state, step=step + 1), new_grads

    def rematerialize(self, state: DistKFACState) -> DistKFACState:
        """Recompute the decompositions from the factors, as after a
        checkpoint load: :meth:`update_inverses`, with health and metrics as
        a refresh ticks them (a restore then puts the loaded health
        counters back: they are the run's durable truth). The offload
        manager forgets its host copies, and under async refresh the
        shadow (sliced) or the worker (host) is reset: the first boundary
        after a mid-window restore skips its swap."""
        if self._offload_manager is not None:
            self._offload_manager.reset()
        state = self.update_inverses(state)
        if self._async_mode == 'sliced':
            state = dataclasses.replace(state, shadow=async_sliced.kaisa_shadow(self, state))
        elif self._async_mode == 'host':
            async_host.reset_worker(self)
        return state

    # ---------------------------------------------------------- utilities

    def extract_factors(self, state: DistKFACState) -> dict[str, dict[str, torch.Tensor]]:
        """Every layer's true-dim factors, ``{name: {'a': A, 'g': G}}``,
        gathered from every rank's factor blocks."""
        out: dict[str, dict[str, torch.Tensor]] = {}
        for side, store, fac in (('a', self.a_store, state.a), ('g', self.g_store, state.g)):
            for sb in store:
                stack = self._gather_blocks(fac[sb.key])
                for i, name in enumerate(sb.layers):
                    d = sb.dims[i]
                    out.setdefault(name, {})[side] = stack[i, :d, :d]
        return out

    def insert_factors(
        self, state: DistKFACState, factors: dict[str, dict[str, Any]]
    ) -> DistKFACState:
        """Write per-layer factors (tensors or arrays, true dims) into this
        rank's factor blocks; layers absent from ``factors`` keep theirs.
        Call :meth:`rematerialize` afterwards."""
        new = {}
        for side, store, fac in (('a', self.a_store, state.a), ('g', self.g_store, state.g)):
            new[side] = {}
            for sb in store:
                lo, hi = self._factor_range(sb.padded)
                block = fac[sb.key].clone()
                for s in range(lo, min(hi, len(sb.layers))):
                    name = sb.layers[s]
                    if name in factors:
                        m = torch.as_tensor(factors[name][side]).to(self.device, torch.float32)
                        block[s - lo] = pad_factor(m, sb.d)
                new[side][sb.key] = block
        return dataclasses.replace(state, a=new['a'], g=new['g'])

    def slot_device(self, side: str, name: str) -> int:
        """The rank that stores and decomposes ``name``'s A or G factor."""
        slot_map, store = (self._a_slot, self.a_store) if side == 'a' else (self._g_slot, self.g_store)
        key, i = slot_map[name]
        padded = next(sb.padded for sb in store if sb.key == key)
        return self._block_owner[i // (padded // self.total_devices)]

    def describe(self) -> str:
        """Registration and placement: strategy, buckets, each store's
        padding, the rank of each layer's factor slots, and the KAISA
        greedy assignment (the cost model's view)."""
        grid = f'{self.grad_workers}x{self.mesh.n_cols}'
        if self.total_devices != self.world:
            grid += f', model {self.mesh.model} x seq {self.mesh.seq}'
        lines = [
            f'DistributedKFAC: {len(self.registry.layers)} layers over '
            f'{self.total_devices} ranks '
            f'(grid {grid}), '
            f'strategy={self.strategy.name}, colocate={self.colocate}, '
            f'method={self.config.compute_method.name}',
            self.config.describe(),
            'stat transport buckets (stacked batched decompositions):',
        ]
        for b in self.buckets:
            lines.append(
                f'  bucket da={b.da} dg={b.dg}: {len(b.layers)} layers, {b.padded} padded slots'
            )
        lines.append('factor storage fill (resident vs padding bytes per size class):')
        for key, p in comms_lib.padding_report(self).items():
            lines.append(
                f'  {key}: {p["layers"]} layers in {p["slots"]} slots, '
                f'resident {p["resident_bytes"]} B, '
                f'identity-pad {p["identity_pad_bytes"]} B, '
                f'slot-pad {p["slot_pad_bytes"]} B, '
                f'fill {p["fill"]:.0%}'
            )
        lines.append(
            'executed placement (a rank stores and decomposes one block of '
            'each stack; the decompositions then live on its column):'
        )
        for name in self.registry.names():
            a_key, a_i = self._a_slot[name]
            g_key, g_i = self._g_slot[name]
            a_rank = self.slot_device('a', name)
            g_rank = self.slot_device('g', name)
            lines.append(
                f'  {name}: A slot {a_key}[{a_i}] -> rank {a_rank} '
                f'({self.mesh.device_at(a_rank)}), '
                f'G slot {g_key}[{g_i}] -> rank {g_rank} ({self.mesh.device_at(g_rank)})'
            )
        lines.append(
            'inverse workers, cost-model view (KAISA greedy assignment — '
            'reference-parity diagnostic, NOT the executed placement above):'
        )
        for layer in self.assignment.get_layers():
            workers = {
                f: self.assignment.inv_worker(layer, f) for f in self.assignment.get_factors(layer)
            }
            lines.append(f'  {layer}: {workers}')
        return '\n'.join(lines)

    def topology(self) -> dict[str, Any]:
        """The process group's size and backend and the grid's shape (with
        a :class:`~kfac_tpu_torch.parallel.mesh.TrainGrid`, its four
        axes)."""
        axes, shape = ['kfac_gw', 'kfac_col'], [self.grad_workers, self.mesh.n_cols]
        if isinstance(self.mesh, mesh_lib.TrainGrid):
            axes, shape = axes + ['model', 'seq'], shape + [self.mesh.model, self.mesh.seq]
        return {
            'process_count': self.total_devices,
            'device_count': self.total_devices,
            'backend': dist.get_backend(self.mesh.group),
            'mesh_axes': axes,
            'mesh_shape': shape,
        }

    def comms_report(self) -> dict[str, Any]:
        """Host-side bytes of each flow and each store's padding
        (:func:`kfac_tpu_torch.observability.comms.comms_summary`), with the
        offload manager's live counters merged into ``offload``."""
        out = comms_lib.comms_summary(self)
        if self._offload_manager is not None:
            out['offload'] = dict(out['offload'], **self._offload_manager.stats)
        return out

    def memory_usage(self, state: DistKFACState) -> dict[str, Any]:
        """This rank's bytes by category, read from the tensors it holds;
        ``total`` sums the four; ``padding_waste`` (global bytes) splits
        the resident factor bytes from the size-class and slot padding."""

        def nbytes(d: dict[str, torch.Tensor]) -> int:
            return int(sum(v.numel() * v.element_size() for v in d.values()))

        sizes: dict[str, Any] = {
            'a_factors': nbytes(state.a),
            'g_factors': nbytes(state.g),
            'a_inverses': nbytes(state.qa) + nbytes(state.da) + nbytes(state.a_inv),
            'g_inverses': (
                nbytes(state.qg) + nbytes(state.dg) + nbytes(state.dgda) + nbytes(state.g_inv)
            ),
        }
        sizes['total'] = sum(sizes.values())
        padding = comms_lib.padding_report(self)
        sizes['padding_waste'] = {
            'per_class': padding,
            **{
                key: sum(p[key] for p in padding.values())
                for key in ('resident_bytes', 'identity_pad_bytes', 'slot_pad_bytes')
            },
        }
        return sizes
