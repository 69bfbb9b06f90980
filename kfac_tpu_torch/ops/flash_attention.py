"""Blockwise-softmax attention partials (counterpart of
``kfac_tpu/ops/pallas_attention.py``).

:func:`flash_attention_partials` computes the unnormalized partials
``(acc, m, l)`` of one (Q-chunk, K-chunk) attend. Its forward on a CUDA
tensor is the hand-written kernel in ``kfac_tpu_torch/csrc/flash_attn.cu``
(replacing ``_flash_kernel``, ``kfac_tpu/ops/pallas_attention.py:42``); on
a CPU tensor it is :func:`attend_partials_einsum`. Its backward is autograd
through :func:`attend_partials_einsum`, as the JAX package's ``custom_vjp``
does: the kernel computes the same function, so the pairing is exact.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kfac_tpu_torch.ops import build

NEG_INF = -1e30
# the head dims the kernel is built for: the tiny LM, the flagship, `large`
HEAD_DIMS = (32, 128, 256)


def attend_partials_einsum(q, k, v, q_offset, k_offset, causal):
    """Plain version: partials from the full (B, H, S_q, S_k) score matrix.

    q: (B, S_q, H, D); k, v: (B, S_k, H, D). Returns acc (B, S_q, H, D),
    m and l (B, H, S_q), all f32.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', q * scale, k).float()
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    # fully masked rows: exp(NEG_INF - NEG_INF) = 1 would poison the sum
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)
    acc = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v).float()
    return acc, m, l


@functools.cache
def _launcher():
    fn = build.library('flash_attn').flash_attn_partials_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _flash_partials_kernel(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """Launch the CUDA kernel: the forward of :func:`flash_attention_partials`
    on the card. Contiguous f32 (B, S, H, D) inputs on 16-byte boundaries
    (the kernel stages them by 16-byte copies), D in ``HEAD_DIMS``."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if k.shape != (b, s_k, h, d) or v.shape != k.shape:
        raise ValueError(f'q, k, v shapes disagree: {q.shape}, {k.shape}, {v.shape}')
    if d not in HEAD_DIMS:
        raise ValueError(f'the flash attention kernel takes head dims {HEAD_DIMS}, not {d}')
    for t in (q, k, v):
        if t.device.type != 'cuda':
            raise ValueError(f'flash attention runs on cuda or cpu, not {t.device}')
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                'the flash attention kernel takes contiguous float32 '
                f'(B, S, H, D) tensors; got {t.dtype}, '
                f'contiguous={t.is_contiguous()}'
            )
        if t.data_ptr() % 16:
            raise ValueError('the flash attention kernel takes tensors on 16-byte boundaries')
    acc = torch.empty_like(q)
    m = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        code = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, h, s_q, s_k, d, int(q_offset),
            int(k_offset), int(causal), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check('flash_attn', code)
    flash_attention_partials.launches += 1
    return acc, m, l


class _FlashPartials(torch.autograd.Function):
    """Kernel forward, autograd-through-the-einsum backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal):
        ctx.save_for_backward(q, k, v)
        ctx.args = (q_offset, k_offset, causal)
        if q.device.type == 'cpu':
            return attend_partials_einsum(q, k, v, q_offset, k_offset, causal)
        return _flash_partials_kernel(q, k, v, q_offset, k_offset, causal)

    @staticmethod
    def backward(ctx, d_acc, d_m, d_l):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attend_partials_einsum(q, k, v, *ctx.args)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), (d_acc, d_m, d_l))
        return dq, dk, dv, None, None, None


def flash_attention_partials(q, k, v, q_offset=0, k_offset=0, causal=True):
    """Blockwise-softmax partials of one (Q-chunk, K-chunk) attend.

    q: (B, S_q, H, D); k, v: (B, S_k, H, D); offsets are the chunks' global
    positions. Returns ``(acc, m, l)``: (B, S_q, H, D) f32 and (B, H, S_q)
    twice, mergeable by ``models.attention._merge``. Differentiable.
    """
    return _FlashPartials.apply(q, k, v, int(q_offset), int(k_offset), bool(causal))


flash_attention_partials.launches = 0
