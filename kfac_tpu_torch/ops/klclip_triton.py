"""Triton kernels of the kl-clip multiply-reduce and scale.

Imported only by the launchers in :mod:`kfac_tpu_torch.ops.klclip`, on a
CUDA tensor: the module imports ``triton`` at the top, and the CPU has
none.

Replaces ``_klclip_dot_kernel`` and ``_klclip_scale_kernel``
(``kfac_tpu/ops/pallas_ns.py:188`` and ``:203``). Both are bound by
bytes on an H100: the dot reads two f32 tensors once and does 2 FLOPs per
8 bytes, the scale reads one and writes one. So the design is one
coalesced pass each, with no data reuse to exploit. The dot writes one
partial sum per block and a second single-program pass adds them in a
fixed order, with no float atomics, so the scalar is the same on every
run.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def dot_partials_kernel(p_ptr, g_ptr, part_ptr, n, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    tl.store(part_ptr + pid, tl.sum(p * g, axis=0))


@triton.jit
def dot_final_kernel(part_ptr, out_ptr, n, BLOCK: tl.constexpr):
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, n, BLOCK):
        offs = start + tl.arange(0, BLOCK)
        acc += tl.load(part_ptr + offs, mask=offs < n, other=0.0)
    tl.store(out_ptr, tl.sum(acc, axis=0))


@triton.jit
def scale_kernel(p_ptr, s_ptr, out_ptr, n, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    s = tl.load(s_ptr)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    tl.store(out_ptr + offs, p * s, mask=mask)
