"""Start a ``torch.distributed`` world of local processes.

:func:`spawn_world` runs ``fn`` in ``world`` fresh processes (the
``spawn`` start method, never ``fork``: a parent may hold threads, as a
test process with JAX loaded does), joined by a ``file://`` rendezvous in a
temporary directory, so concurrent worlds never race for a TCP port.
Shared by the tests (gloo on the CPU) and ``chip_smoke.py`` (NCCL, one
rank a card).
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _run_rank(
    rank: int,
    fn: Callable[..., Any],
    world: int,
    backend: str,
    device: str,
    init: str,
    out_dir: str,
    timeout_s: float,
    args: tuple,
) -> None:
    if device == 'cuda':
        dev = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        # the world's ranks share the host's cores: one intra-op thread each
        dev = torch.device(device)
        torch.set_num_threads(1)
    os.environ['LOCAL_RANK'] = str(dev.index if dev.type == 'cuda' else rank)
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn_world(
    fn: Callable[..., Any],
    world: int,
    backend: str = 'nccl',
    device: str = 'cuda',
    args: tuple = (),
    timeout_s: float = 600.0,
) -> list[Any]:
    """Run ``fn(rank, world, device, *args)`` on each of ``world`` ranks of
    a new process group and return each rank's result, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    result loadable by ``torch.load(weights_only=False)``; ``args`` are
    pickled into each process. ``device`` is ``'cuda'`` (rank ``r`` on
    ``cuda:r`` modulo the cards) or ``'cpu'``; ``backend`` is ``'nccl'``
    or ``'gloo'``. A rank that raises makes this raise once every process
    has ended; a collective that waits longer than ``timeout_s`` fails.
    """
    with tempfile.TemporaryDirectory(prefix='kfac_world_') as tmp:
        init = 'file://' + os.path.join(tmp, 'rendezvous')
        mp.start_processes(
            _run_rank,
            args=(fn, world, backend, device, init, tmp, timeout_s, args),
            nprocs=world, join=True, start_method='spawn',
        )
        return [
            torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
            for r in range(world)
        ]
