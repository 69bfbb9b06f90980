"""One Newton-Schulz iteration of the damped inverse (counterpart of the NS
half of ``kfac_tpu/ops/pallas_ns.py``).

On a CUDA tensor :func:`fused_ns_step` launches the hand-written kernels in
``kfac_tpu_torch/csrc/newton_schulz.cu`` (which replace the TPU kernels
``_ns_xupdate_kernel`` and ``_ns_mx_resid_kernel``: both products on the
tensor cores at f32 accuracy, in the output tile :func:`plan` picks); on a
CPU tensor it runs :func:`fused_ns_step_plain`, the unfused loop body of
``newton_schulz_inverse_info``. Unlike the JAX dispatch gate, the kernel
takes every size, ragged ones included.

:func:`fused_ns_step_stacked` is the same iteration over an (L, d, d)
stack of slots in one launch (the distributed engine's stores, where the
JAX package vmaps the solver): the slot is a grid axis of the kernel, each
slot gets its own residual, and an ``active`` mask on the device skips the
slots whose stopping rule has fired. :func:`fused_ns_step` is its stack of
one with every slot active, which the kernel runs as its 2-D
instantiation.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kfac_tpu_torch.ops import build


def fused_ns_step_plain(
    m: torch.Tensor, x: torch.Tensor, mx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version, for (d, d) matrices or (L, d, d) stacks: ``x_new =
    x (2I - mx)``, ``mx_new = m x_new`` and the residual ``||I -
    mx_new||_F / sqrt(d)`` of each matrix (0-d, or (L,))."""
    d = m.shape[-1]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    x_new = x @ (2.0 * eye - mx)
    mx_new = m @ x_new
    return x_new, mx_new, torch.linalg.matrix_norm(eye - mx_new) / math.sqrt(d)


# output tiles the kernel is built for, (rows, columns): two warpgroups of
# 64 rows, or one (the last)
TILES = ((128, 128), (128, 144), (64, 32))


@functools.cache
def _launcher():
    fn = build.library('newton_schulz').ns_step_stacked_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid(d: int, tile: tuple[int, int]) -> tuple[int, int]:
    """CTAs (over rows, over columns) of a (d, d) product in ``tile``s."""
    return -(-d // tile[0]), -(-d // tile[1])


def plan(d: int, sms: int, slots: int = 1) -> tuple[int, int]:
    """Output tile of the kernel at width ``d`` on a card of ``sms`` SMs,
    for a stack of ``slots`` matrices (``slots`` times the grid's CTAs).
    Of the two-warpgroup tiles whose CTAs give every SM one, the one that
    takes the fewest waves of tile area (``ceil(CTAs / sms)`` times its
    rows times its columns), the first of :data:`TILES` on a tie; where
    neither fills the card, the one-warpgroup tile (one d ~ 512 factor:
    128 CTAs of 64 x 32 against 16 of 128 x 128). At d = 2049, 128 x 144
    takes 255 CTAs, two waves, where 128 x 128 takes 289, three."""
    def ctas(t):
        return slots * math.prod(grid(d, t))

    filling = [t for t in TILES[:-1] if ctas(t) >= sms]
    if not filling:
        return TILES[-1]
    return min(filling, key=lambda t: -(-ctas(t) // sms) * t[0] * t[1])


def _check(m, x, mx, active, ndim):
    """Shapes and devices of a step's operands; raises ValueError."""
    if m.ndim != ndim or m.shape[-1] != m.shape[-2] or 0 in m.shape:
        want = 'square matrix' if ndim == 2 else '(L, d, d) stack'
        raise ValueError(f'expected a non-empty {want}, got {tuple(m.shape)}')
    if x.shape != m.shape or mx.shape != m.shape:
        raise ValueError(
            f'shape mismatch: m {tuple(m.shape)}, x {tuple(x.shape)}, mx {tuple(mx.shape)}'
        )
    if active is not None and (active.shape != m.shape[:1] or active.dtype != torch.bool):
        raise ValueError(f'active must be an (L,) bool tensor, got {active.dtype} {tuple(active.shape)}')
    tensors = (m, x, mx) if active is None else (m, x, mx, active)
    if {t.device for t in tensors} != {m.device}:
        raise ValueError('m, x, mx and active must lie on one device')
    if m.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the Newton-Schulz step runs on cuda or cpu, not {m.device}')
    if m.device.type == 'cuda':
        for t in (m, x, mx):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    'the Newton-Schulz kernel takes contiguous float32 tensors; '
                    f'got {t.dtype}, contiguous={t.is_contiguous()}'
                )


def _launch(m, x, mx, active, tile):
    """One launch of the kernel over (d, d) matrices or (L, d, d) stacks
    (``active`` None: every slot); ``(x_new, mx_new, resid)``, resid 0-d
    or (L,)."""
    slots, d = m.shape[:-2].numel(), m.shape[-1]
    rows, cols = grid(d, tile)
    x_new = torch.empty_like(m)
    mx_new = torch.empty_like(m)
    partials = torch.empty(slots * rows * cols, dtype=torch.float32, device=m.device)
    resid = torch.empty(m.shape[:-2], dtype=torch.float32, device=m.device)
    mask = None if active is None else active.contiguous().view(torch.uint8)
    with torch.cuda.device(m.device):
        code = _launcher()(
            m.data_ptr(), x.data_ptr(), mx.data_ptr(), x_new.data_ptr(),
            mx_new.data_ptr(), partials.data_ptr(), resid.data_ptr(),
            None if mask is None else mask.data_ptr(), slots, d, *tile,
            torch.cuda.current_stream(m.device).cuda_stream,
        )
    build.check('newton_schulz', code)
    return x_new, mx_new, resid


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_ns_step(
    m: torch.Tensor, x: torch.Tensor, mx: torch.Tensor,
    tile: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x_new, mx_new, resid)`` of one iteration for square ``m``, ``x``,
    ``mx`` of one shape; ``resid`` is a 0-d f32 tensor on their device.

    CUDA tensors go through the kernels (f32, contiguous, else raises), in
    ``tile`` (one of :data:`TILES`; None: :func:`plan`'s); CPU tensors
    through :func:`fused_ns_step_plain`.
    """
    _check(m, x, mx, None, 2)
    if m.device.type == 'cpu':
        return fused_ns_step_plain(m, x, mx)
    tile = tile or plan(m.shape[0], _sms(m.device))
    out = _launch(m, x, mx, None, tile)
    fused_ns_step.launches += 1
    return out


fused_ns_step.launches = 0


def fused_ns_step_stacked(
    m: torch.Tensor,
    x: torch.Tensor,
    mx: torch.Tensor,
    active: torch.Tensor | None = None,
    tile: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x_new, mx_new, resid)`` of one iteration for each slot of (L, d,
    d) stacks ``m``, ``x``, ``mx``; ``resid`` is (L,) f32 on their device.

    ``active``, an (L,) bool tensor on the same device (None: every slot),
    names the slots to iterate: on the card the other slots' CTAs return
    at once and their outputs are left unwritten, so a caller keeps its own
    values there (``torch.where``). CUDA tensors go through one launch of
    the kernels for the whole stack (f32, contiguous, else raises), in
    ``tile`` (None: :func:`plan`'s for the stack); CPU tensors through
    :func:`fused_ns_step_plain`, every slot.
    """
    _check(m, x, mx, active, 3)
    if m.device.type == 'cpu':
        return fused_ns_step_plain(m, x, mx)
    tile = tile or plan(m.shape[-1], _sms(m.device), m.shape[0])
    out = _launch(m, x, mx, active, tile)
    fused_ns_step_stacked.launches += 1
    return out


fused_ns_step_stacked.launches = 0
