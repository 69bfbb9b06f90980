"""Distributed execution of the PyTorch port: the KAISA grid over
``torch.distributed`` process groups, its collectives, the KAISA engine,
the training grid's model, seq and expert axes with the tensor-parallel
layers and the expert-parallel FFN, the pipeline grid with the pipelined
LM (GPipe, 1F1B and the interleaved schedule) and its K-FAC engine, the cross-process helpers and a launcher for
local worlds."""

from kfac_tpu_torch.parallel import (
    collectives,
    expert_parallel,
    interleaved,
    interleaved_scan,
    launch,
    mesh,
    multihost,
    pipeline,
    tensor_parallel,
)
from kfac_tpu_torch.parallel.expert_parallel import (
    EPSwitchFFN,
    ExpertParallelKFAC,
    combined_value_stats_and_grad,
)
from kfac_tpu_torch.parallel.kaisa import (
    DistKFACState,
    DistributedKFAC,
    build_buckets,
    build_stores,
)
from kfac_tpu_torch.parallel.interleaved_scan import InterleavedPipelinedLM, logical_to_stack
from kfac_tpu_torch.parallel.launch import spawn_world
from kfac_tpu_torch.parallel.mesh import (
    KaisaGrid,
    PipelineGrid,
    TrainGrid,
    kaisa_mesh,
    pipeline_mesh,
    train_mesh,
)
from kfac_tpu_torch.parallel.pipeline import PipelinedLM, PipelineKFAC, StageBlocks

__all__ = [
    'DistKFACState',
    'DistributedKFAC',
    'EPSwitchFFN',
    'ExpertParallelKFAC',
    'InterleavedPipelinedLM',
    'KaisaGrid',
    'PipelineGrid',
    'PipelineKFAC',
    'PipelinedLM',
    'StageBlocks',
    'TrainGrid',
    'combined_value_stats_and_grad',
    'expert_parallel',
    'interleaved',
    'interleaved_scan',
    'logical_to_stack',
    'pipeline',
    'pipeline_mesh',
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
