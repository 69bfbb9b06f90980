"""Distributed execution of the PyTorch port: the KAISA grid over
``torch.distributed`` process groups, its collectives, the KAISA engine,
the cross-process helpers and a launcher for local worlds."""

from kfac_tpu_torch.parallel import collectives, launch, mesh, multihost
from kfac_tpu_torch.parallel.kaisa import (
    DistKFACState,
    DistributedKFAC,
    build_buckets,
    build_stores,
)
from kfac_tpu_torch.parallel.launch import spawn_world
from kfac_tpu_torch.parallel.mesh import KaisaGrid, kaisa_mesh

__all__ = [
    'DistKFACState',
    'DistributedKFAC',
    'KaisaGrid',
    'build_buckets',
    'build_stores',
    'collectives',
    'kaisa_mesh',
    'launch',
    'mesh',
    'multihost',
    'spawn_world',
]
