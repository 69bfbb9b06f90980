"""Cross-process helpers (counterpart of the host-side part of
``kfac_tpu/parallel/multihost.py``).

With one process every helper is the JAX package's single-process no-op
or identity. A run over several ``torch.distributed`` processes raises:
the port's multi-process engine and its agreement come in a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.distributed as dist


def process_count() -> int:
    """Processes of the run: the ``torch.distributed`` world, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank, 0 without ``torch.distributed``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def allgather_scalars(values: np.ndarray | Sequence[float]) -> np.ndarray:
    """A small host array of every process, ``(process_count, *shape)``
    f32, ordered by rank; with one process a reshape."""
    _one_process('allgather_scalars')
    return np.asarray(values, np.float32)[None, ...]


def _one_process(what: str) -> None:
    if process_count() > 1:
        raise NotImplementedError(
            f'{what} over several torch.distributed processes is not ported '
            'to kfac_tpu_torch yet'
        )


def barrier(name: str) -> None:
    """Block until every process reaches this point; with one process a
    no-op. ``name`` labels the call site."""
    _one_process(f'barrier({name!r})')


def agree_emergency(code: int, step: int) -> tuple[int, int]:
    """The pod-wide ``(max code, max step)`` of an emergency-checkpoint
    request; with one process the identity."""
    _one_process('agree_emergency')
    return int(code), int(step)


def agree_decision(ok: bool) -> bool:
    """True only when every process voted True; with one process ``ok``."""
    _one_process('agree_decision')
    return bool(ok)


def assert_same_step(step: int, what: str = 'restored checkpoint') -> None:
    """Check that every process agrees on ``step``; with one process there
    is nothing to check."""
    _one_process(f'assert_same_step ({what})')
