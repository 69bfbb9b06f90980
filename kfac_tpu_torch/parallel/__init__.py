"""Distributed execution of the PyTorch port: the KAISA grid over
``torch.distributed`` process groups, its collectives, the KAISA engine,
the training grid's model and seq axes with the tensor-parallel layers,
the cross-process helpers and a launcher for local worlds."""

from kfac_tpu_torch.parallel import collectives, launch, mesh, multihost, tensor_parallel
from kfac_tpu_torch.parallel.kaisa import (
    DistKFACState,
    DistributedKFAC,
    build_buckets,
    build_stores,
)
from kfac_tpu_torch.parallel.launch import spawn_world
from kfac_tpu_torch.parallel.mesh import KaisaGrid, TrainGrid, kaisa_mesh, train_mesh

__all__ = [
    'DistKFACState',
    'DistributedKFAC',
    'KaisaGrid',
    'TrainGrid',
    'build_buckets',
    'build_stores',
    'collectives',
    'kaisa_mesh',
    'launch',
    'mesh',
    'multihost',
    'spawn_world',
    'tensor_parallel',
    'train_mesh',
]
