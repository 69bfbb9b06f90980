"""Cross-process helpers (counterpart of the host-side part of
``kfac_tpu/parallel/multihost.py``).

Each helper reads the default ``torch.distributed`` group when one is up
(its world is the run's processes) and is the JAX package's
single-process identity otherwise. The agreement helpers and the barrier
move small host values over gloo: the default group itself when it is
gloo, else a gloo group over the same ranks, made once by every process at
its first such call (NCCL's object collectives go through the card and
wait on it, a host sync the checkpoint manager's cadence must not pay).
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


_HOST_GROUPS: dict[Any, Any] = {}


def _host_group(group: Any = None) -> Any:
    """The gloo group for host values among ``group``'s processes (None:
    the default group): ``group`` itself when it is gloo; for the default
    group over NCCL a gloo group over the same ranks, made at the first
    call, which every process makes at the same point."""
    if dist.get_backend(group) == 'gloo':
        return group
    if group is not None:
        raise NotImplementedError(
            'host agreement over a subgroup of an NCCL world: pass a gloo group'
        )
    world = dist.group.WORLD
    if world not in _HOST_GROUPS:
        _HOST_GROUPS.clear()  # a group of an earlier, destroyed world
        _HOST_GROUPS[world] = dist.new_group(backend='gloo')
    return _HOST_GROUPS[world]


def _gather(value: Any, group: Any = None) -> list[Any]:
    """``value`` of every process of ``group`` (None: the default group),
    ordered by rank."""
    if not _group_up():
        return [value]
    out: list[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=_host_group(group))
    return out


def allgather_scalars(values: np.ndarray | Sequence[float]) -> np.ndarray:
    """A small host array of every process, ``(process_count, *shape)``
    f32, ordered by rank."""
    return np.stack([np.asarray(v, np.float32) for v in _gather(np.asarray(values, np.float32))])


def from_process_zero(value: Any, group: Any = None) -> Any:
    """The ``value`` of ``group``'s first process, on each of them (each
    passes its own)."""
    return _gather(value, group)[0]


def barrier(name: str, group: Any = None) -> None:
    """Block until every process of ``group`` (None: all) reaches this
    point; with one process a no-op. ``name`` labels the call site."""
    del name
    if _group_up():
        dist.barrier(group=_host_group(group))


def agree_emergency(code: int, step: int) -> tuple[int, int]:
    """The pod-wide ``(max code, max step)`` of an emergency-checkpoint
    request."""
    votes = _gather((int(code), int(step)))
    return max(c for c, _ in votes), max(s for _, s in votes)


def agree_decision(ok: bool, group: Any = None) -> bool:
    """True only when every process of ``group`` (None: all) voted True."""
    return all(_gather(bool(ok), group))


def assert_same_step(step: int, what: str = 'restored checkpoint') -> None:
    """Raise unless every process holds the same ``step``."""
    steps = _gather(int(step))
    if len(set(steps)) > 1:
        raise RuntimeError(f'processes disagree on the step of the {what}: {steps}')
