"""The KAISA grid over ``torch.distributed`` process groups (counterpart
of ``kaisa_mesh`` in ``kfac_tpu/parallel/mesh.py``).

The JAX mesh's two axes, ``kfac_gw`` (rows) and ``kfac_col`` (columns),
become process groups: one for each column of the grid (the ranks that
share a layer's decompositions) and one for each row (the ranks among
which a preconditioned gradient is shared). Rank ``d`` sits at ``(row,
col) = divmod(d, n_cols)``, as device ``d`` of the JAX mesh does, and the
batch is split into row blocks by rank, as ``batch_sharding`` shards rows
over both axes jointly. One process runs each rank; on the card, rank
``d`` drives ``cuda:<local rank>``.

:func:`train_mesh` adds the JAX mesh's ``model``, ``seq`` and ``expert``
axes (:class:`TrainGrid`): tensor-parallel shards of the Megatron layers
(``parallel/tensor_parallel.py``), sequence shards for ring attention
(``models/attention.py``) and the expert axis of expert parallelism
(``parallel/expert_parallel.py``), over which the rows shard jointly with
the data axes. :func:`pipeline_mesh` is the pipeline's (pipe, data,
model) grid (:class:`PipelineGrid`, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from kfac_tpu_torch import assignment as assignment_lib
from kfac_tpu_torch.device import resolve_device


@dataclasses.dataclass(eq=False)
class KaisaGrid:
    """The (grad_workers x n_cols) KAISA grid this process is a rank of.

    ``rank`` is this process's index in the grid (its rank in ``group``,
    the default group when None); ``device`` is where its tensors live. ``col_groups[c]`` and ``row_groups[r]`` are the process groups
    of column ``c`` (ranks ordered by row) and row ``r`` (ordered by
    column).
    """

    grad_workers: int
    n_cols: int
    rank: int
    device: torch.device
    group: Any
    col_groups: list[Any]
    row_groups: list[Any]

    @property
    def world_size(self) -> int:
        """The data-parallel ranks: the KAISA grid's size."""
        return self.grad_workers * self.n_cols

    @property
    def total_devices(self) -> int:
        """Every rank: the factor stores are padded to and sharded over
        them."""
        return self.world_size

    @property
    def dp_rank(self) -> int:
        """This rank's index in the KAISA grid (its row block)."""
        return self.rank

    @property
    def row(self) -> int:
        return self.dp_rank // self.n_cols

    @property
    def col(self) -> int:
        return self.dp_rank % self.n_cols

    @property
    def col_index(self) -> int:
        """This rank's position in its column group: the block of its
        column's slots it stores and decomposes."""
        return self.row

    @property
    def factor_block(self) -> int:
        """The factor block this rank stores and decomposes: ``col *
        grad_workers + row``, so each column's blocks are contiguous and the
        reshard is one all-gather within the column."""
        return self.col * (self.total_devices // self.n_cols) + self.col_index

    def block_owner(self, block: int) -> int:
        """The rank (in ``group``) that holds factor block ``block``."""
        row, col = block % self.grad_workers, block // self.grad_workers
        return row * self.n_cols + col

    @property
    def stat_group(self) -> Any:
        """The ranks whose statistics and gradients are averaged: the
        data-parallel world."""
        return self.group

    @property
    def stat_world(self) -> int:
        return self.world_size

    @property
    def col_group(self) -> Any:
        """This rank's column: the ranks that share its decompositions."""
        return self.col_groups[self.col]

    @property
    def row_group(self) -> Any:
        """This rank's row: the ranks among which it shares preconditioned
        gradients."""
        return self.row_groups[self.row]

    def device_at(self, index: int) -> torch.device:
        """The device grid index ``index`` drives: ``cuda:<its local
        rank>`` on the card (one host: its rank modulo the cards), else the
        CPU."""
        if self.device.type != 'cuda':
            return self.device
        return torch.device('cuda', index % torch.cuda.device_count())

    def local_rows(self, batch: Any) -> Any:
        """This rank's row block of a global batch: every tensor in nested
        tuples, lists and dicts split along its leading axis into
        ``world_size`` equal blocks, block ``dp_rank`` kept (the JAX
        package's ``batch_sharding``)."""
        return _map_tensors(batch, lambda x: _block(x, 0, self.world_size, self.dp_rank, 'row'))

    def local_tokens(self, batch: Any) -> Any:
        """This rank's part of a global (batch, sequence, ...) batch (the
        JAX package's ``token_sharding``): without a ``seq`` axis, its row
        block."""
        return self.local_rows(batch)


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    raise TypeError(f'batches hold tensors in tuples, lists and dicts, not {type(tree)}')


def _block(x: torch.Tensor, dim: int, parts: int, index: int, what: str) -> torch.Tensor:
    """Block ``index`` of ``x`` split into ``parts`` equal blocks along
    ``dim``."""
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f'a batch of {n} {what}s does not split into {parts} equal {what} blocks')
    per = n // parts
    return x.narrow(dim, index * per, per)


def shard_chunks(
    seq_len: int, n_shards: int, shard: int, zigzag: bool = False
) -> list[tuple[int, int]]:
    """The global position ranges ``[start, stop)`` that sequence shard
    ``shard`` of ``n_shards`` holds, in its local order: its contiguous
    block, or in the zigzag layout chunks ``shard`` and ``2 n - 1 - shard``
    of ``seq_len / (2 n)`` positions (``models.attention.zigzag_indices``)."""
    if zigzag:
        if seq_len % (2 * n_shards):
            raise ValueError(f'{seq_len=} not divisible by 2*{n_shards=}')
        c = seq_len // (2 * n_shards)
        mirror = 2 * n_shards - 1 - shard
        return [(shard * c, (shard + 1) * c), (mirror * c, (mirror + 1) * c)]
    if seq_len % n_shards:
        raise ValueError(f'{seq_len=} does not split into {n_shards} sequence shards')
    per = seq_len // n_shards
    return [(shard * per, (shard + 1) * per)]


def shard_positions(seq_len: int, n_shards: int, shard: int, zigzag: bool = False) -> torch.Tensor:
    """:func:`shard_chunks` as a (CPU) tensor of positions."""
    return torch.cat([torch.arange(a, b) for a, b in shard_chunks(seq_len, n_shards, shard, zigzag)])


@dataclasses.dataclass(eq=False)
class TrainGrid(KaisaGrid):
    """The (grad_workers, n_cols, model, seq, expert) training grid (the
    JAX package's ``train_mesh``): the KAISA grid over the data-parallel
    ranks, each of which is a (model x seq x expert) block of ranks.

    Rank ``d`` (its index in ``group``) sits at ``(row, col, m, s, e)``,
    the row-major order of the JAX mesh's devices, so a world of N ranks
    and a mesh over N devices put each shard on the same index. Its groups:
    ``model_group`` (the ranks that share its (row, col, s, e), ordered by
    m: the tensor-parallel shards of its layers), ``seq_group`` (its (row,
    col, m, e), ordered by s: the ring), ``dp_group`` (its (m, s, e): the
    data axes, over which an expert's statistics and gradients reduce),
    ``expert_group`` (its (row, col, m, s), ordered by e: the all-to-all
    of expert parallelism; only with ``expert > 1``), ``stat_group`` (its
    m: the data, sequence and expert ranks, over which the statistics and
    the sharded gradients of the other layers are averaged), ``col_group``
    (its col: the factor blocks gathered into the column's decompositions)
    and ``row_group`` (its (row, m, s, e): the gradient broadcast).
    ``zigzag`` lays the sequence out in zigzag chunks (:func:`shard_chunks`)
    for load-balanced causal ring attention.

    The rows shard over the data and expert axes jointly, the expert axis
    innermost (the JAX package's ``token_sharding``): for the layers
    outside the experts it is more data parallelism, and the K-FAC
    placement treats each (seq, expert) pair as the sequence shards alone
    are treated.
    """

    model: int = 1
    seq: int = 1
    zigzag: bool = False
    groups: dict[str, Any] = dataclasses.field(default_factory=dict)
    expert: int = 1

    @property
    def _inner(self) -> int:
        """The ranks of a (model) shard's block that hold other tokens:
        seq x expert."""
        return self.seq * self.expert

    @property
    def total_devices(self) -> int:
        return self.world_size * self.model * self._inner

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.model * self._inner)

    @property
    def m(self) -> int:
        """This rank's index on the ``model`` axis."""
        return (self.rank // self._inner) % self.model

    @property
    def s(self) -> int:
        """This rank's index on the ``seq`` axis."""
        return (self.rank // self.expert) % self.seq

    @property
    def e(self) -> int:
        """This rank's index on the ``expert`` axis."""
        return self.rank % self.expert

    @property
    def col_index(self) -> int:
        return (self.row * self.model + self.m) * self._inner + self.s * self.expert + self.e

    def block_owner(self, block: int) -> int:
        inner = self.model * self._inner
        col, sub = divmod(block, self.grad_workers * inner)
        row, mse = divmod(sub, inner)
        return (row * self.n_cols + col) * inner + mse

    @property
    def model_group(self) -> Any:
        return self.groups['model']

    @property
    def seq_group(self) -> Any:
        return self.groups['seq']

    @property
    def dp_group(self) -> Any:
        return self.groups['dp']

    @property
    def expert_group(self) -> Any:
        if self.expert == 1:
            raise ValueError('the grid has no expert axis: build it with train_mesh(expert=N), N > 1')
        return self.groups['expert']

    @property
    def col_group(self) -> Any:
        return self.groups['col']

    @property
    def row_group(self) -> Any:
        return self.groups['row']

    @property
    def stat_group(self) -> Any:
        return self.groups['stat']

    @property
    def stat_world(self) -> int:
        return self.world_size * self._inner

    @property
    def token_rows(self) -> tuple[int, int]:
        """``(blocks, index)``: the global batch's rows split into
        ``blocks`` equal row blocks over the data and expert axes, this
        rank's block ``index``."""
        return self.world_size * self.expert, self.dp_rank * self.expert + self.e

    def seq_positions(self, seq_len: int) -> torch.Tensor:
        """The global positions (a CPU tensor) of this rank's ``seq_len /
        seq`` tokens of a ``seq_len`` sequence: its contiguous block, or its
        zigzag chunks."""
        return shard_positions(seq_len, self.seq, self.s, self.zigzag)

    def take_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's positions of ``x``'s (global) sequence axis ``dim``,
        by slices (no index tensor, so nothing crosses to the device)."""
        chunks = shard_chunks(x.shape[dim], self.seq, self.s, self.zigzag)
        parts = [x.narrow(dim, a, b - a) for a, b in chunks]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    def local_rows(self, batch: Any) -> Any:
        """This rank's row block of a global batch: split over the data
        and expert axes jointly (:attr:`token_rows`)."""
        blocks, index = self.token_rows
        return _map_tensors(batch, lambda x: _block(x, 0, blocks, index, 'row'))

    def local_tokens(self, batch: Any) -> Any:
        """This rank's part of a global (batch, sequence, ...) batch: its
        row block (:meth:`local_rows`) and, along the second axis, its
        sequence positions (:meth:`take_seq`)."""
        blocks, index = self.token_rows

        def take(x):
            x = _block(x, 0, blocks, index, 'row')
            if self.seq == 1 and not self.zigzag:
                return x
            if x.ndim < 2:
                raise ValueError(f'a batch of shape {tuple(x.shape)} has no sequence axis')
            return self.take_seq(x)

        return _map_tensors(batch, take)


@dataclasses.dataclass(eq=False)
class PipelineGrid:
    """The (pipe, data, model) grid of a pipeline (the JAX package's
    ``pipeline_mesh``, whose data axes are ``kfac_gw = 1`` by ``kfac_col =
    dp``): rank ``d`` (its index in ``group``) sits at ``(stage, data, m)``
    = the row-major order of the JAX reshape ``(n_stages, 1, dp, model)``.

    Its groups: ``pipe_group`` (the ranks that share its (data, m), ordered
    by stage: the point-to-point sends of the schedule and the kl-clip
    sum), ``dp_group`` (its (stage, m), ordered by data: the statistics,
    the stage's gradients and the decompositions' round-robin) and
    ``model_group`` (its (stage, data), ordered by m: the tensor-parallel
    shards of its stage's Megatron layers) and ``groups['shard']`` (its m:
    the ranks of one shard of the vocab-parallel head). There is no
    grad-worker fraction: the pipeline's K-FAC state is stage-local.
    """

    n_stages: int
    dp: int
    model: int
    rank: int
    device: torch.device
    group: Any
    groups: dict[str, Any]

    @property
    def total_devices(self) -> int:
        return self.n_stages * self.dp * self.model

    @property
    def stage(self) -> int:
        return self.rank // (self.dp * self.model)

    @property
    def data(self) -> int:
        """This rank's index on the data axis."""
        return (self.rank // self.model) % self.dp

    @property
    def m(self) -> int:
        """This rank's index on the ``model`` axis."""
        return self.rank % self.model

    @property
    def pipe_group(self) -> Any:
        return self.groups['pipe']

    @property
    def dp_group(self) -> Any:
        return self.groups['dp']

    @property
    def model_group(self) -> Any:
        return self.groups['model']

    def rank_of(self, stage: int, data: int | None = None, m: int | None = None) -> int:
        """The global rank (in the default group) at ``(stage, data, m)``;
        ``data`` and ``m`` default to this rank's."""
        data = self.data if data is None else data
        m = self.m if m is None else m
        index = (stage * self.dp + data) * self.model + m
        ranks = dist.get_process_group_ranks(self.group) if self.group is not None else None
        return ranks[index] if ranks is not None else index


def _grouped_groups(coords: list[tuple], ranks: tuple[int, ...], me: int | None, keys: dict) -> dict:
    """One process group for each value of each ``key(coord)``, ranks in
    rank order (every rank creates every group, in one order); returns
    this rank's of each key."""
    out = {}
    for name, key in keys.items():
        mine = None
        for value in dict.fromkeys(key(c) for c in coords):
            g = dist.new_group([ranks[i] for i, c in enumerate(coords) if key(c) == value])
            if me is not None and key(coords[me]) == value:
                mine = g
        out[name] = mine
    return out


def _local_rank(rank: int) -> int:
    local = os.environ.get('LOCAL_RANK')
    return int(local) if local is not None else rank % max(1, torch.cuda.device_count())


def kaisa_mesh(
    grad_worker_fraction: float = 1.0,
    group: Any = None,
    device: str | torch.device = 'cuda',
) -> KaisaGrid | None:
    """The KAISA grid over ``group`` (None: the default process group,
    which must be initialized), ``grad_workers = world *
    grad_worker_fraction`` rows. Every rank must call it, in the same
    order as its other ``new_group`` calls: it creates one process group
    for each column and each row. A process outside ``group`` calls too
    and gets None. ``device='cuda'`` places this rank on
    ``cuda:<local rank>`` (``LOCAL_RANK``, else its rank modulo the cards);
    ``'cpu'`` on the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            'kaisa_mesh needs torch.distributed initialized: call '
            'init_process_group first (kfac_tpu_torch.parallel.launch.spawn_world does)'
        )
    ranks = tuple(dist.get_process_group_ranks(group)) if group is not None else tuple(
        range(dist.get_world_size())
    )
    world = len(ranks)
    workers = assignment_lib.grad_worker_count(world, grad_worker_fraction)
    n_cols = world // workers
    col_groups = [
        dist.new_group([ranks[i] for i in cols])
        for cols in assignment_lib.partition_grad_workers(world, workers)
    ]
    row_groups = [
        dist.new_group([ranks[i] for i in rows])
        for rows in assignment_lib.partition_grad_receivers(world, workers)
    ]
    if dist.get_rank() not in ranks:
        return None
    rank = ranks.index(dist.get_rank())
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', _local_rank(dist.get_rank()))
    return KaisaGrid(
        grad_workers=workers, n_cols=n_cols, rank=rank, device=dev,
        group=group, col_groups=col_groups, row_groups=row_groups,
    )



def _world_ranks(group: Any, what: str) -> tuple[int, ...]:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f'{what} needs torch.distributed initialized: call '
            'init_process_group first (kfac_tpu_torch.parallel.launch.spawn_world does)'
        )
    return tuple(dist.get_process_group_ranks(group)) if group is not None else tuple(
        range(dist.get_world_size())
    )


def _rank_device(device: str | torch.device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', _local_rank(dist.get_rank()))
    return dev


def train_mesh(
    grad_worker_fraction: float = 1.0,
    model: int = 1,
    seq: int = 1,
    expert: int = 1,
    group: Any = None,
    device: str | torch.device = 'cuda',
    zigzag: bool = False,
) -> TrainGrid | None:
    """The (kfac_gw, kfac_col, model, seq[, expert]) training grid over
    ``group`` (None: the default process group): ``world / (model * seq *
    expert)`` data-parallel ranks in a KAISA grid of
    ``grad_worker_fraction``, each a block of ``model`` tensor-parallel by
    ``seq`` sequence-parallel by ``expert`` expert-parallel ranks
    (:class:`TrainGrid`). Every rank must call it, in the same order as its
    other ``new_group`` calls (it creates the grid's process groups); a
    process outside ``group`` gets None. ``zigzag`` lays the sequence out
    for zigzag ring attention. ``expert > 1`` adds the expert axis (and
    its groups); ``expert=1`` leaves the grid as it was."""
    ranks = _world_ranks(group, 'train_mesh')
    world = len(ranks)
    if model < 1 or seq < 1 or expert < 1 or world % (model * seq * expert):
        raise ValueError(
            f'{world} devices not divisible by model*seq*expert = {model * seq * expert}'
        )
    dp = world // (model * seq * expert)
    workers = assignment_lib.grad_worker_count(dp, grad_worker_fraction)
    n_cols = dp // workers
    # rank d = (((row * n_cols + col) * model + m) * seq + s) * expert + e
    coords = [
        (r, c, m, s, e) for r in range(workers) for c in range(n_cols)
        for m in range(model) for s in range(seq) for e in range(expert)
    ]
    me = ranks.index(dist.get_rank()) if dist.get_rank() in ranks else None
    keys = {
        'col': lambda c: c[1],
        'row': lambda c: (c[0], c[2], c[3], c[4]),
        'model': lambda c: (c[0], c[1], c[3], c[4]),
        'seq': lambda c: (c[0], c[1], c[2], c[4]),
        'dp': lambda c: (c[2], c[3], c[4]),
        'stat': lambda c: c[2],
    }
    if expert > 1:
        keys['expert'] = lambda c: c[:4]
    groups = _grouped_groups(coords, ranks, me, keys)
    if me is None:
        return None
    return TrainGrid(
        grad_workers=workers, n_cols=n_cols, rank=me, device=_rank_device(device), group=group,
        col_groups=[], row_groups=[], model=model, seq=seq, zigzag=zigzag, groups=groups,
        expert=expert,
    )


def pipeline_mesh(
    n_stages: int,
    model: int = 1,
    group: Any = None,
    device: str | torch.device = 'cuda',
) -> PipelineGrid | None:
    """The (pipe, data, model) grid of ``n_stages`` pipeline stages over
    ``group`` (None: the default process group), ``world / (n_stages *
    model)`` data-parallel ranks a stage, each a block of ``model``
    tensor-parallel ranks (:class:`PipelineGrid`; the JAX package's
    ``pipeline_mesh``). Every rank must call it, in one order with its
    other ``new_group`` calls; a process outside ``group`` gets None."""
    ranks = _world_ranks(group, 'pipeline_mesh')
    world = len(ranks)
    if n_stages < 1 or model < 1 or world % (n_stages * model):
        raise ValueError(
            f'{world} devices not divisible by {n_stages} stages x {model} model shards'
        )
    dp = world // (n_stages * model)
    coords = [(p, d, m) for p in range(n_stages) for d in range(dp) for m in range(model)]
    me = ranks.index(dist.get_rank()) if dist.get_rank() in ranks else None
    groups = _grouped_groups(coords, ranks, me, {
        'pipe': lambda c: (c[1], c[2]),
        'dp': lambda c: (c[0], c[2]),
        'model': lambda c: (c[0], c[1]),
        'shard': lambda c: c[2],
    })
    if me is None:
        return None
    return PipelineGrid(
        n_stages=n_stages, dp=dp, model=model, rank=me, device=_rank_device(device),
        group=group, groups=groups,
    )
