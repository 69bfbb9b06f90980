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

``train_mesh`` and ``pipeline_mesh`` (model, seq, expert and pipeline
axes) come in a later slice.
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
        return self.grad_workers * self.n_cols

    @property
    def row(self) -> int:
        return self.rank // self.n_cols

    @property
    def col(self) -> int:
        return self.rank % self.n_cols

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
        ``world_size`` equal blocks, block ``rank`` kept (the JAX
        package's ``batch_sharding``)."""
        world = self.world_size

        def take(x):
            if isinstance(x, torch.Tensor):
                n = x.shape[0]
                if n % world:
                    raise ValueError(
                        f'a batch of {n} rows does not split into {world} equal row blocks'
                    )
                per = n // world
                return x[self.rank * per:(self.rank + 1) * per]
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(take(v) for v in x)
            raise TypeError(f'batches hold tensors in tuples, lists and dicts, not {type(x)}')

        return take(batch)


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

