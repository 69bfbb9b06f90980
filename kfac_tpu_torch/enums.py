"""Enum types for the PyTorch port (counterpart of ``kfac_tpu/enums.py``).

Only the compute method is ported so far; the distributed engine's enums
come with it. Values match the JAX package's.
"""

from __future__ import annotations

import enum


class ComputeMethod(enum.Enum):
    """Second-order representation: eigendecomposition or explicit inverse."""

    EIGEN = 1
    INVERSE = 2
