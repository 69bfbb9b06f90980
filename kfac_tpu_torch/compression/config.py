"""Configuration of the compressed stat transport and the cold-factor
offload (counterpart of ``kfac_tpu/compression/config.py``).

Both knobs take the ``async_inverse`` idiom on the engine:
``None``/``False`` disables, ``True`` selects the defaults, a shorthand
scalar sets the main knob, or pass the dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: the transport's quantization dtypes: 'int8' (symmetric round to
#: nearest at scale amax/127) and 'fp8' (a float8_e4m3fn cast at scale
#: amax/448)
QUANT_DTYPES = ('int8', 'fp8')


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Knobs of the low-precision stat transport.

    Args:
        dtype: wire dtype of the quantized triangle payload, ``'int8'``
            or ``'fp8'`` (``torch.float8_e4m3fn``).
        block_size: elements per scaling block; each block carries one
            float32 scale, so the wire adds ``4 / block_size`` bytes an
            element and the error bound is per block.
        error_feedback: carry the quantization residual of each chunk
            across factor updates as durable engine state (``comp_ef``)
            and add it back before the next quantization, so the noise
            averages out of the factor EMA instead of biasing it.
    """

    dtype: str = 'int8'
    block_size: int = 256
    error_feedback: bool = True

    def __post_init__(self) -> None:
        if self.dtype not in QUANT_DTYPES:
            raise ValueError(
                f'unknown compression dtype {self.dtype!r}; expected one '
                f'of {QUANT_DTYPES}'
            )
        if self.dtype == 'fp8' and not hasattr(torch, 'float8_e4m3fn'):
            raise ValueError(
                "stat_compression dtype 'fp8' requires a PyTorch build with "
                "float8_e4m3fn; use dtype='int8' on this installation"
            )
        if self.block_size < 1:
            raise ValueError(f'block_size must be >= 1, got {self.block_size}')


def as_compression_config(value: Any) -> CompressionConfig | None:
    """Normalize ``stat_compression=``: ``None``/``False`` (off), ``True``
    (int8 defaults), a dtype string, or a :class:`CompressionConfig`."""
    if value is None or value is False:
        return None
    if value is True:
        return CompressionConfig()
    if isinstance(value, str):
        return CompressionConfig(dtype=value)
    if isinstance(value, CompressionConfig):
        return value
    raise TypeError(
        'stat_compression must be a CompressionConfig, a dtype string '
        f'({QUANT_DTYPES}), True, False, or None; got {value!r}'
    )


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Knobs of the cold-factor host offload.

    Args:
        min_cold_steps: spill the factors to host memory only when the
            next factor or inverse cadence boundary is at least this many
            steps away.
        prefetch_lead: start the copy back to the device this many steps
            before the boundary that reads the factors, so that boundary
            finds them resident (a prefetch hit).
    """

    min_cold_steps: int = 4
    prefetch_lead: int = 1

    def __post_init__(self) -> None:
        if self.min_cold_steps < 1:
            raise ValueError(f'min_cold_steps must be >= 1, got {self.min_cold_steps}')
        if self.prefetch_lead < 0:
            raise ValueError(f'prefetch_lead must be >= 0, got {self.prefetch_lead}')


def as_offload_config(value: Any) -> OffloadConfig | None:
    """Normalize ``offload=``: ``None``/``False`` (off), ``True``
    (defaults), an int (``min_cold_steps``), or an :class:`OffloadConfig`."""
    if value is None or value is False:
        return None
    if value is True:
        return OffloadConfig()
    if isinstance(value, int) and not isinstance(value, bool):
        return OffloadConfig(min_cold_steps=value)
    if isinstance(value, OffloadConfig):
        return value
    raise TypeError(
        'offload must be an OffloadConfig, an int min_cold_steps, True, '
        f'False, or None; got {value!r}'
    )
