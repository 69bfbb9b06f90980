"""Triton kernels of the kl-clip multiply-reduce.

Imported only by the launchers in :mod:`kfac_tpu_torch.ops.klclip`, on a
CUDA tensor: the module imports ``triton`` at the top, and the CPU has
none.

Replaces ``_klclip_dot_kernel`` (``kfac_tpu/ops/pallas_ns.py:188``). It
is bound by bytes on an H100: it reads two f32 tensors once and does 2
FLOPs per 8 bytes. So the design is one coalesced pass, with no data
reuse to exploit. It writes one partial sum per block and a second
single-program pass adds them in a fixed order, with no float atomics, so
the scalar is the same on every run. (The scale is the CUDA kernel in
``csrc/klclip.cu``.)
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

