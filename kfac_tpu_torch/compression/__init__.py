"""Compressed stat transport and cold-factor host offload (counterpart of
``kfac_tpu/compression``).

- The low-precision stat transport (:mod:`.quant`): int8 or fp8
  blockwise-scaled quantization of the packed factor triangles on the
  ``ALLREDUCE_BUCKETED`` transport, with a per-chunk error-feedback
  residual carried as durable engine state.
- The cold-factor host offload (:mod:`.offload`): the factors go to host
  memory between cadence boundaries and are prefetched back ahead of the
  next one.
"""

from kfac_tpu_torch.compression.config import (
    CompressionConfig,
    OffloadConfig,
    as_compression_config,
    as_offload_config,
)
from kfac_tpu_torch.compression.offload import OffloadManager, is_spilled, pump
from kfac_tpu_torch.compression.quant import (
    dequantize_blockwise,
    error_bound,
    quantize_blockwise,
    wire_bytes,
)

__all__ = [
    'CompressionConfig',
    'OffloadConfig',
    'OffloadManager',
    'as_compression_config',
    'as_offload_config',
    'dequantize_blockwise',
    'error_bound',
    'is_spilled',
    'pump',
    'quantize_blockwise',
    'wire_bytes',
]
