"""Symmetric second moment ``a^T a / scale`` (counterpart of
``kfac_tpu/ops/pallas_cov.py``).

On a CUDA tensor :func:`sym_cov` launches the hand-written kernel in
``kfac_tpu_torch/csrc/sym_cov.cu`` (which replaces the TPU kernel
``_sym_cov_kernel``, ``kfac_tpu/ops/pallas_cov.py:40``): tensor cores at f32
accuracy (3xTF32), over the upper tile pairs and, where those cannot fill
the card, over slices of N (:func:`plan`). On a CPU tensor it runs
:func:`sym_cov_plain`. Both compute the upper triangle and mirror it, so
the result is exactly symmetric.

A bfloat16 or float16 ``a`` takes the kernel's 16-bit form and gives the
TPU kernel's function at that dtype: the sum in f32, divided by ``scale``
in f32, rounded once to ``a.dtype``. It runs ``wgmma`` on operands that TMA
loads, in 128-wide tiles, by :func:`plan16`'s walk. TMA reads rows that
start on 16 bytes, so the wrapper takes any 2-D layout whose rows are a
multiple of 8 values apart (:func:`tma_ready`) as it is, and copies any
other into such rows (:func:`kernel_rows`); ``ops/cov.py``'s A builders
write their bias-augmented rows into such rows from the start.
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
# the 16-bit forms (sym_cov_wgmma_kernel): output tile edge, rows of `a` a
# stage (kTile16, kSlab16 in csrc/sym_cov.cu), the values a row of `a`
# must be a multiple of apart (TMA's 16 bytes), the values the rows of a
# padded buffer are a multiple of apart (128 bytes: a TMA box row then
# lies in one L2 line; 8 values apart, the (8192, 2049) product took 0.128
# ms on an H100 against 0.084 at 64, ``half_probe``), and the slabs under
# which N is never split
HALF = (torch.bfloat16, torch.float16)
TILE16 = 128
SLAB16_ROWS = 64
ROW_ALIGN16 = 8
ROW_PAD16 = 64
MAX_UNSPLIT16_SLABS = 8


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


class HalfPlan(NamedTuple):
    """How the 16-bit kernel walks an (n, d) product on a card with ``sms``
    SMs, one persistent CTA an SM at most: items ``[0, whole)`` are upper
    pairs of ``TILE16``-wide tiles over all n rows; the last ``split``
    pairs are cut into ``slices`` row slices of ``rows_per_slice`` rows
    (slice-major items after them), whose partial tiles a second pass adds
    in slice order. CTA c takes items c, c + ctas, ... (``Walk`` in
    csrc/sym_cov.cu)."""

    n: int
    d: int
    sms: int
    whole: int
    split: int
    slices: int
    rows_per_slice: int

    @property
    def nblk(self) -> int:
        return -(-self.d // TILE16)

    @property
    def pairs(self) -> int:
        return self.nblk * (self.nblk + 1) // 2

    @property
    def items(self) -> int:
        return self.whole + self.split * self.slices

    @property
    def ctas(self) -> int:
        return max(1, min(self.sms, self.items))

    @property
    def scratch_bytes(self) -> int:
        """Device memory of the slices' partial tiles (0 when none)."""
        return 4 * self.split * self.slices * TILE16**2

    @property
    def fill(self) -> float:
        """The share of the card's SM time over the walk that its slabs
        keep busy: all the slabs over ``sms`` times the longest CTA's."""
        slabs = -(-self.n // SLAB16_ROWS)
        rounds = -(-self.whole // self.ctas)
        longest = rounds * slabs + (self.rows_per_slice // SLAB16_ROWS if self.split else 0)
        return (self.pairs * slabs) / (self.sms * longest) if longest else 1.0

    def walk(self) -> list[tuple[int, int, int, int]]:
        """``(cta, pair, first row, end row)`` of every item, each CTA's in
        the order it takes them: the kernel's ``item_of``."""
        out = []
        for cta in range(self.ctas):
            for item in range(cta, self.items, self.ctas):
                if item < self.whole:
                    out.append((cta, item, 0, self.n))
                    continue
                idx = item - self.whole
                r0 = idx // self.split * self.rows_per_slice
                out.append((cta, self.whole + idx % self.split, r0,
                            min(self.n, r0 + self.rows_per_slice)))
        return out


@functools.cache
def plan16(n: int, d: int, sms: int) -> HalfPlan:
    """The 16-bit kernel's walk of an (n, d) product on ``sms`` SMs.

    The pairs in whole waves of ``sms`` CTAs go whole; the rest, if N has
    more than ``MAX_UNSPLIT16_SLABS`` slabs, are cut into as many slices
    as fit one more wave, so every CTA takes the same whole pairs and at
    most one slice. On an H100 (132 SMs) at N = 8192: d = 2048 (136
    pairs) takes 132 whole and 4 in 32 slices of 256 rows (fill 0.999);
    d = 2049 (153) 132 whole and 21 in 6 slices of 1408 rows (0.989);
    d = 512 (10) 13 slices of 640 rows each (0.970); d = 513 (15) 8 of
    1024 (0.909)."""
    nblk = -(-d // TILE16)
    pairs = nblk * (nblk + 1) // 2
    slabs = -(-n // SLAB16_ROWS)
    rest = pairs % sms
    whole = HalfPlan(n, d, sms, pairs, 0, 1, max(1, slabs) * SLAB16_ROWS)
    if slabs <= MAX_UNSPLIT16_SLABS or rest == 0:
        return whole
    slices = min(slabs, sms // rest)
    if slices <= 1:
        return whole
    per = -(-slabs // slices)
    return HalfPlan(n, d, sms, pairs - rest, rest, -(-slabs // per), per * SLAB16_ROWS)


def tma_ready(a: torch.Tensor) -> bool:
    """Whether the 16-bit kernel reads 2-D ``a`` as it lies: unit column
    stride, rows a multiple of ``ROW_ALIGN16`` values apart, the first on a
    16-byte boundary."""
    return (
        a.stride(1) == 1 and a.stride(0) >= a.shape[1] and a.stride(0) % ROW_ALIGN16 == 0
        and a.data_ptr() % 16 == 0
    )


def kernel_rows(n: int, d: int, dtype: torch.dtype, device, padded: bool) -> torch.Tensor:
    """An uninitialised (n, d) tensor; with ``padded`` the (n, d) view of an
    (n, d rounded up to ``ROW_PAD16``) buffer, whose rows the 16-bit kernel
    reads as they lie, else a contiguous one."""
    if not padded:
        return torch.empty(n, d, dtype=dtype, device=device)
    width = -(-d // ROW_PAD16) * ROW_PAD16
    return torch.empty(n, width, dtype=dtype, device=device)[:, :d]


def half_input(a: torch.Tensor) -> torch.Tensor:
    """``a`` if :func:`tma_ready`, else a copy in padded rows."""
    if tma_ready(a):
        return a
    return kernel_rows(*a.shape, a.dtype, a.device, True).copy_(a)


@functools.cache
def _launcher(dtype: torch.dtype):
    fn = getattr(build.library('sym_cov'), ENTRY[dtype])
    if dtype in HALF:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, *[ctypes.c_int] * 5, ctypes.c_void_p,
        ]
    else:
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
    """Run the f32 kernel on ``a`` into ``out`` by plan ``p`` (checked
    arguments; no launch count)."""
    part = scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher(a.dtype)(
            a.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(),
            p.n, p.d, float(scale), p.splits, p.rows_per_split,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def half_scratch(p: HalfPlan, device: torch.device) -> torch.Tensor | None:
    """The slices' partial tiles of plan ``p`` (None when none)."""
    if not p.split:
        return None
    return torch.empty(p.scratch_bytes // 4, dtype=torch.float32, device=device)


def walk_args(p: HalfPlan) -> tuple[int, ...]:
    """Plan ``p`` as the 16-bit entry points take it."""
    return p.whole, p.split, p.slices, p.rows_per_slice, p.ctas


def launch16(a: torch.Tensor, out: torch.Tensor, scale: float, p: HalfPlan) -> None:
    """Run the 16-bit kernel on a :func:`tma_ready` ``a`` into ``out`` by
    plan ``p`` (checked arguments; no launch count)."""
    part = half_scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher(a.dtype)(
            a.data_ptr(), a.stride(0), out.data_ptr(), 0 if part is None else part.data_ptr(),
            p.n, p.d, float(scale), *walk_args(p),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def sym_cov(a: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """``a^T a / scale`` for a 2-D ``a`` of shape (N, D); (D, D) in
    ``a.dtype``.

    CUDA tensors go through the kernel: f32 contiguous; bf16 or f16 in any
    layout (:func:`half_input` copies what TMA cannot read); anything else
    raises. The plan's scratch is allocated here. CPU tensors go through
    :func:`sym_cov_plain`. Each launch adds one to ``sym_cov.launches`` and
    to ``sym_cov.launches_by_dtype[dtype]``.
    """
    if a.ndim != 2:
        raise ValueError(f'expected a 2D tensor, got shape {tuple(a.shape)}')
    if scale is None:
        scale = a.shape[0]
    if a.device.type == 'cpu':
        return sym_cov_plain(a, scale)
    if a.device.type != 'cuda':
        raise ValueError(f'sym_cov runs on cuda or cpu, not {a.device}')
    if a.dtype not in ENTRY or (a.dtype not in HALF and not a.is_contiguous()):
        raise ValueError(
            'the sym_cov kernel takes a float32, bfloat16 or float16 tensor, a float32 '
            f'one contiguous; got {a.dtype}, contiguous={a.is_contiguous()}'
        )
    n, d = a.shape
    out = torch.empty((d, d), dtype=a.dtype, device=a.device)
    if d == 0:
        return out
    if a.dtype in HALF:
        launch16(half_input(a), out, scale, plan16(n, d, sm_count(a.device.index)))
    else:
        launch(a, out, scale, plan(n, d, sm_count(a.device.index)))
    build.count(sym_cov, a.dtype)
    return out


build.reset_counts(sym_cov)
