"""Blockwise-scaled low-precision quantization of flat transport buffers
(counterpart of ``kfac_tpu/compression/quant.py``).

A buffer is split into ``block_size`` blocks; each block is scaled by its
own float32 scale from its largest magnitude and cast to the wire dtype.
The round trip's error bound per block:

- int8: ``|x - deq(x)| <= amax_block / 254`` (round half to even at
  scale ``amax / 127``, as ``jnp.round`` and ``torch.round`` both do);
- fp8 (e4m3): ``|x - deq(x)| <= amax_block / 16`` (3 mantissa bits).

Plain torch ops, as the JAX package's are plain ``jnp``: there is no
kernel of the JAX package to port here.
"""

from __future__ import annotations

import numpy as np
import torch

#: largest representable magnitude of each wire dtype
_QMAX = {'int8': 127.0, 'fp8': 448.0}


def wire_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a wire dtype name."""
    if dtype == 'int8':
        return torch.int8
    if dtype == 'fp8':
        return torch.float8_e4m3fn
    raise ValueError(f'unknown quantization dtype {dtype!r}')


def _blocks(n: int, block_size: int) -> int:
    return max(1, -(-n // block_size))


def quantize_blockwise(
    x: torch.Tensor, dtype: str, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 1-D float buffer to ``(payload, scales)``: ``payload``
    of shape ``(x.numel(),)`` at the wire dtype (trimmed to the true
    element count), ``scales`` ``(n_blocks,)`` float32. An all-zero block
    gets scale 1, so the division is always finite."""
    if x.ndim != 1:
        raise ValueError(f'expected a flat buffer, got shape {tuple(x.shape)}')
    n = x.shape[0]
    nb = _blocks(n, block_size)
    xb = torch.nn.functional.pad(x.float(), (0, nb * block_size - n)).view(nb, block_size)
    amax = xb.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / _QMAX[dtype], torch.ones_like(amax))
    scaled = xb / scales[:, None]
    if dtype == 'int8':
        q = torch.clamp(torch.round(scaled), -127.0, 127.0)
    else:
        q = scaled  # within +-448 by construction
    return q.to(wire_dtype(dtype)).reshape(-1)[:n], scales


def dequantize_blockwise(
    payload: torch.Tensor, scales: torch.Tensor, n: int, block_size: int
) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: the first ``n`` elements of
    the rescaled payload, as float32."""
    nb = scales.shape[0]
    pp = payload.float()
    pp = torch.nn.functional.pad(pp, (0, nb * block_size - pp.shape[0]))
    return (pp.view(nb, block_size) * scales[:, None]).reshape(-1)[:n]


def error_bound(amax: float, dtype: str, *, slack: float = 1.001) -> float:
    """Worst-case absolute round-trip error of a block with largest
    magnitude ``amax`` (``slack`` absorbs the f32 arithmetic of the
    scale)."""
    if dtype == 'int8':
        return slack * amax / 254.0
    return slack * amax / 16.0


def wire_bytes(elements: int, dtype: str, block_size: int) -> dict[str, int]:
    """Wire accounting of one flat chunk of ``elements``:
    ``{'payload_bytes', 'scale_bytes', 'wire_bytes'}``, the quantized
    buffer (one byte an element, trimmed) and its float32 scales."""
    nb = _blocks(int(elements), int(block_size))
    payload = int(elements)
    scale = nb * np.dtype(np.float32).itemsize
    return {'payload_bytes': payload, 'scale_bytes': scale, 'wire_bytes': payload + scale}
