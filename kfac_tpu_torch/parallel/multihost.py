"""Cross-process helpers (counterpart of the host-side part of
``kfac_tpu/parallel/multihost.py``).

Each helper reads the default ``torch.distributed`` group when one is up
(its world is the run's processes) and is the JAX package's
single-process identity otherwise. The agreement helpers move small host
values with ``all_gather_object``, which NCCL and gloo both provide.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch.distributed as dist


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes of the run: the ``torch.distributed`` world, else 1."""
    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    """This process's rank, 0 without ``torch.distributed``."""
    return dist.get_rank() if _group_up() else 0


def _gather(value: Any) -> list[Any]:
    """``value`` of every process, ordered by rank."""
    if not _group_up():
        return [value]
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def allgather_scalars(values: np.ndarray | Sequence[float]) -> np.ndarray:
    """A small host array of every process, ``(process_count, *shape)``
    f32, ordered by rank."""
    return np.stack([np.asarray(v, np.float32) for v in _gather(np.asarray(values, np.float32))])


def barrier(name: str) -> None:
    """Block until every process reaches this point; with one process a
    no-op. ``name`` labels the call site."""
    del name
    if _group_up():
        dist.barrier()


def agree_emergency(code: int, step: int) -> tuple[int, int]:
    """The pod-wide ``(max code, max step)`` of an emergency-checkpoint
    request."""
    votes = _gather((int(code), int(step)))
    return max(c for c, _ in votes), max(s for _, s in votes)


def agree_decision(ok: bool) -> bool:
    """True only when every process voted True."""
    return all(_gather(bool(ok)))


def assert_same_step(step: int, what: str = 'restored checkpoint') -> None:
    """Raise unless every process holds the same ``step``."""
    steps = _gather(int(step))
    if len(set(steps)) > 1:
        raise RuntimeError(f'processes disagree on the step of the {what}: {steps}')
