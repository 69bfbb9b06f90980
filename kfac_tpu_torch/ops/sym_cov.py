"""Symmetric second moment ``a^T a / scale`` (counterpart of
``kfac_tpu/ops/pallas_cov.py``).

On a CUDA tensor :func:`sym_cov` launches the hand-written kernel in
``kfac_tpu_torch/csrc/sym_cov.cu`` (which replaces the TPU kernel
``_sym_cov_kernel``, ``kfac_tpu/ops/pallas_cov.py:40``): tensor cores at f32
accuracy (3xTF32), over the upper tile pairs and, where those cannot fill
the card, over slices of N (:func:`plan`). On a CPU tensor it runs
:func:`sym_cov_plain`. Both compute the upper triangle and mirror it, so
the result is exactly symmetric.

A bfloat16 or float16 ``a`` takes the kernel's 16-bit form (the tensor
cores' m16n8k16 product of the values themselves, each product exact in
f32) and gives the TPU kernel's function at that dtype: the sum in f32,
divided by ``scale`` in f32, rounded once to ``a.dtype``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from kfac_tpu_torch.ops import build

# rows of `a` per pipeline stage: kSlab in csrc/sym_cov.cu
SLAB_ROWS = 32
# output tile edge, and the kernel's CTAs an SM holds at once (119
# registers x 128 threads and 55 KB of shared memory each, by ptxas)
TILE = 64
CTAS_PER_SM = 4
# the least share of the last wave of CTAs that wave_plan() accepts full
MIN_WAVE_FILL = 0.9
# plan() leaves N in one slice up to this many slabs (512 rows)
MAX_UNSPLIT_SLABS = 16


# the dtypes the kernel is built for, and its C entry point for each
ENTRY = {
    torch.float32: 'sym_cov_f32',
    torch.bfloat16: 'sym_cov_bf16',
    torch.float16: 'sym_cov_f16',
}


def sym_cov_plain(a: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: upper triangle of ``a^T a`` mirrored, then
    divided by ``scale`` (default: the row count); for a 16-bit ``a`` the
    product and the divide in f32, then one rounding to ``a.dtype``."""
    if scale is None:
        scale = a.shape[0]
    x = a.float()
    full = x.T @ x
    upper = torch.triu(full)
    return ((upper + torch.triu(full, diagonal=1).T) / scale).to(a.dtype)


class CovPlan(NamedTuple):
    """How the kernel cuts an (n, d) product: one CTA per upper pair of
    ``TILE``-wide tiles and row slice; ``splits`` slices of
    ``rows_per_split`` rows (the last one shorter) cover the n rows."""

    n: int
    d: int
    splits: int
    rows_per_split: int

    @property
    def nblk(self) -> int:
        return -(-self.d // TILE)

    @property
    def pairs(self) -> int:
        """Upper tile pairs, bi <= bj: the grid's x extent."""
        return self.nblk * (self.nblk + 1) // 2

    @property
    def scratch_bytes(self) -> int:
        """Device memory of the partial tiles (0 when unsplit)."""
        if self.splits == 1:
            return 0
        return 4 * self.splits * self.pairs * TILE**2


def wave_fill(ctas: int, sms: int) -> float:
    """Share of the card's CTA slots that ``ctas`` CTAs keep busy over the
    waves they take."""
    slots = CTAS_PER_SM * sms
    return ctas / (-(-ctas // slots) * slots)


def wave_plan(n: int, d: int, sms: int) -> CovPlan:
    """The fewest slices of N, each a whole number of 32-row slabs, that
    make the (tile pair, slice) CTAs of an (n, d) product fill their waves
    to ``MIN_WAVE_FILL`` on a card with ``sms`` SMs; one slice per slab
    where none does. On an H100 at N = 8192: d = 2048 (528 pairs, one full
    wave) is not split, d = 2049 (561) is cut 6 ways, d = 512 (36) 14 ways
    and d = 513 (45) 11 ways."""
    nblk = -(-d // TILE)
    pairs = nblk * (nblk + 1) // 2
    slabs = max(1, -(-n // SLAB_ROWS))
    splits = next(
        (s for s in range(1, slabs + 1) if wave_fill(pairs * s, sms) >= MIN_WAVE_FILL), slabs
    )
    per_split = -(-slabs // splits)
    splits = -(-slabs // per_split)  # at most as many, none empty
    return CovPlan(n, d, splits, per_split * SLAB_ROWS)


@functools.cache
def plan(n: int, d: int, sms: int) -> CovPlan:
    """Split of an (n, d) ``sym_cov`` or ``sym_cov_ema`` on a card with
    ``sms`` SMs: :func:`wave_plan`'s, but one slice where N is at most
    ``MAX_UNSPLIT_SLABS`` slabs.

    Every slice ends a partial tile that a second pass adds in order, so a
    split costs that pass: a second launch and a scratch allocation, host
    work that sets the time of a small product. The wrapper's call took
    longer split than whole at N = 77 and 512 on an H100, and shorter
    split at N = 1024 and 8192 (``chip_smoke.py``'s kernel phase, which
    times the plan against the other form; readings in PERF.md, Findings).
    """
    slabs = max(1, -(-n // SLAB_ROWS))
    if slabs <= MAX_UNSPLIT_SLABS:
        return CovPlan(n, d, 1, slabs * SLAB_ROWS)
    return wave_plan(n, d, sms)


@functools.cache
def _launcher(dtype: torch.dtype):
    fn = getattr(build.library('sym_cov'), ENTRY[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(p: CovPlan, device: torch.device) -> torch.Tensor | None:
    """The partial tiles of plan ``p`` (None when it is not split)."""
    if p.splits == 1:
        return None
    return torch.empty(p.scratch_bytes // 4, dtype=torch.float32, device=device)


def launch(a: torch.Tensor, out: torch.Tensor, scale: float, p: CovPlan) -> None:
    """Run the kernel on ``a`` into ``out`` by plan ``p`` (checked
    arguments; no launch count)."""
    part = scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher(a.dtype)(
            a.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(),
            p.n, p.d, float(scale), p.splits, p.rows_per_split,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def sym_cov(a: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """``a^T a / scale`` for a 2-D ``a`` of shape (N, D); (D, D) in
    ``a.dtype``.

    CUDA tensors go through the kernel (f32, bf16 or f16, contiguous, else
    raises); the split plan's scratch is allocated here. CPU tensors go
    through :func:`sym_cov_plain`. Each launch adds one to
    ``sym_cov.launches`` and to ``sym_cov.launches_by_dtype[dtype]``.
    """
    if a.ndim != 2:
        raise ValueError(f'expected a 2D tensor, got shape {tuple(a.shape)}')
    if scale is None:
        scale = a.shape[0]
    if a.device.type == 'cpu':
        return sym_cov_plain(a, scale)
    if a.device.type != 'cuda':
        raise ValueError(f'sym_cov runs on cuda or cpu, not {a.device}')
    if a.dtype not in ENTRY or not a.is_contiguous():
        raise ValueError(
            'the sym_cov kernel takes a contiguous float32, bfloat16 or float16 '
            f'tensor; got {a.dtype}, contiguous={a.is_contiguous()}'
        )
    n, d = a.shape
    out = torch.empty((d, d), dtype=a.dtype, device=a.device)
    if d == 0:
        return out
    launch(a, out, scale, plan(n, d, sm_count(a.device.index)))
    build.count(sym_cov, a.dtype)
    return out


build.reset_counts(sym_cov)
