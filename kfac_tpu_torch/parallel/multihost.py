"""Cross-process helpers (counterpart of the host-side part of
``kfac_tpu/parallel/multihost.py``).

With one process every helper is the JAX package's single-process no-op.
A run over several ``torch.distributed`` processes raises: the port's
multi-process engine comes in a later slice.
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
    arr = np.asarray(values, np.float32)
    if process_count() == 1:
        return arr[None, ...]
    raise NotImplementedError(
        'allgather_scalars over several torch.distributed processes is not '
        'ported to kfac_tpu_torch yet'
    )
