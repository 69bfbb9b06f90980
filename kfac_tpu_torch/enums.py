"""Enum types for the PyTorch port (counterpart of ``kfac_tpu/enums.py``).

Values match the JAX package's.
"""

from __future__ import annotations

import enum


class AllreduceMethod(enum.Enum):
    """How the distributed engine reduces the factor statistics.

    ``ALLREDUCE`` is one all-reduce per factor; ``ALLREDUCE_BUCKETED``
    packs the upper triangles of every factor into byte-capped flat
    buffers first, fewer and larger collectives carrying half the bytes.
    """

    ALLREDUCE = 1
    ALLREDUCE_BUCKETED = 2


class AssignmentStrategy(enum.Enum):
    """Cost model of the KAISA work assignment: COMPUTE weights a factor by
    n^3 (its eigendecomposition), MEMORY by n^2 (its bytes)."""

    COMPUTE = 1
    MEMORY = 2


class ComputeMethod(enum.Enum):
    """Second-order representation: eigendecomposition or explicit inverse."""

    EIGEN = 1
    INVERSE = 2


class DistributedStrategy(enum.Enum):
    """KAISA gradient-worker strategy.

    - COMM_OPT: grad_worker_fraction = 1. Every rank holds every
      decomposition and preconditions every gradient itself.
    - MEM_OPT: grad_worker_fraction = 1/world. Each decomposition lives on
      one rank, and the preconditioned gradients are broadcast from it.
    - HYBRID_OPT: fractions between; decompositions are shared within a
      column of the grid.
    """

    COMM_OPT = 1
    MEM_OPT = 2
    HYBRID_OPT = 3
