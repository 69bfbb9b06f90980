"""Blockwise-softmax attention partials (counterpart of
``kfac_tpu/ops/pallas_attention.py``).

:func:`flash_attention_partials` computes the unnormalized partials
``(acc, m, l)`` of one (Q-chunk, K-chunk) attend. Its forward on a CUDA
tensor is the hand-written kernel in ``kfac_tpu_torch/csrc/flash_attn.cu``
(replacing ``_flash_kernel``, ``kfac_tpu/ops/pallas_attention.py:42``); on
a CPU tensor it is :func:`attend_partials_einsum`. Its backward is autograd
through :func:`attend_partials_einsum`, as the JAX package's ``custom_vjp``
does: the kernel computes the same function, so the pairing is exact.

bfloat16 and float16 inputs take the kernel's 16-bit forms, which compute
the TPU kernel's function at that dtype (:func:`attend_partials_rounded`:
f32 logits from the 16-bit q and k, p rounded to v's dtype before P V).
The CPU path stays the JAX package's off-TPU one, the einsum form, which
rounds ``q * scale`` to q's dtype first: in 16 bits the two are different
functions (at f32 they agree to rounding), and the backward is the einsum
form's in both, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kfac_tpu_torch.ops import build

NEG_INF = -1e30
# the head dims the kernel is built for: the char_lm gate, the tiny LM, most
# public decoders (the flagship's width at 8 heads), the flagship, `large`
HEAD_DIMS = (16, 32, 64, 128, 256)
# the 16-bit forms' head dims: a 16-value row is under their TMA swizzle span
HEAD_DIMS_16 = (32, 64, 128, 256)


def attend_partials_einsum(q, k, v, q_offset, k_offset, causal):
    """Plain version: partials from the full (B, H, S_q, S_k) score matrix.

    q: (B, S_q, H, D); k, v: (B, S_k, H, D). Returns acc (B, S_q, H, D),
    m and l (B, H, S_q), all f32. In 16 bits it is the JAX package's einsum
    form: ``q * scale`` rounded to q's dtype, both products accumulated in
    f32 (``preferred_element_type``), p rounded to v's dtype.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', (q * scale).float(), k.float())
    return _partials(logits, v, q_offset, k_offset, causal)


def attend_partials_rounded(q, k, v, q_offset, k_offset, causal):
    """Plain version of the kernel's bf16 and f16 forms, the TPU kernel's
    function (``kfac_tpu/ops/pallas_attention.py:56-99``) over the whole
    key chunk: ``logit = (q . k) * D^-0.5`` in f32 from the 16-bit values
    (``q * scale`` is never rounded), f32 softmax, p rounded to v's dtype
    for P V (f32 accumulate), l the sum of the unrounded p. The kernel
    rounds p at each key tile's running max, this at the row's max: the
    two agree where the first tile holds the row's max. Shapes as
    :func:`attend_partials_einsum`."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    return _partials(logits, v, q_offset, k_offset, causal)


def _partials(logits, v, q_offset, k_offset, causal):
    """(acc, m, l) of f32 (B, H, S_q, S_k) ``logits``: the causal mask at
    global positions, then p rounded to v's dtype for P V."""
    if causal:
        q_pos = q_offset + torch.arange(logits.shape[2], device=logits.device)
        k_pos = k_offset + torch.arange(logits.shape[3], device=logits.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    # fully masked rows: exp(NEG_INF - NEG_INF) = 1 would poison the sum
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)
    acc = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype).float(), v.float())
    return acc, m, l


def exact_inputs(b, s, h, d, dtype, gen: torch.Generator):
    """q, k, v of shape (B, S, H, D) on the CPU in ``dtype`` on which the
    16-bit forms' rounding points and sums are exact, so that any
    implementation of :func:`attend_partials_rounded` agrees with it to the
    last bit of acc (m and l to f32 rounding): each query has four ones
    (the rest 0); key 0 is all ones, so every row's maximum logit is in
    the first key tile; every other key is all ones but one 0, so every p
    is 1 or ``exp(-D^-0.5)``, which lies at least 0.01 of a bf16 and an
    f16 step from a rounding boundary at D = 32, 64, 128, 256; v holds the
    integers -2..2, so P V's sums of at most 1024 in steps of 2^-11 are
    exact in f32 in any order. Rounding p, or not, then moves acc, and
    rounding ``q * scale`` to 16 bits moves m."""
    q = torch.zeros(b, s, h, d)
    ones = torch.rand(b, s, h, d, generator=gen).argsort(dim=-1)[..., :4]
    q.scatter_(-1, ones, 1.0)
    k = torch.ones(b, s, h, d)
    zero = torch.randint(0, d, (b, s, h, 1), generator=gen)
    k.scatter_(-1, zero, 0.0)
    k[:, 0] = 1.0
    v = torch.randint(-2, 3, (b, s, h, d), generator=gen).float()
    return q.to(dtype), k.to(dtype), v.to(dtype)


# the dtypes the kernel is built for, and its C entry point for each
ENTRY = {
    torch.float32: 'flash_attn_partials_f32',
    torch.bfloat16: 'flash_attn_partials_bf16',
    torch.float16: 'flash_attn_partials_f16',
}


@functools.cache
def _launcher(dtype: torch.dtype):
    fn = getattr(build.library('flash_attn'), ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _flash_partials_kernel(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """Launch the CUDA kernel: the forward of :func:`flash_attention_partials`
    on the card. Contiguous (B, S, H, D) inputs of one dtype of ``ENTRY``
    on 16-byte boundaries (the f32 kernel stages them by 16-byte copies,
    the 16-bit ones by TMA), D in ``HEAD_DIMS`` (``HEAD_DIMS_16`` in bf16
    and f16); acc, m and l are f32."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if k.shape != (b, s_k, h, d) or v.shape != k.shape:
        raise ValueError(f'q, k, v shapes disagree: {q.shape}, {k.shape}, {v.shape}')
    if d not in HEAD_DIMS:
        raise ValueError(f'the flash attention kernel takes head dims {HEAD_DIMS}, not {d}')
    if q.dtype != torch.float32 and d not in HEAD_DIMS_16:
        raise ValueError(
            f'the flash attention kernel\'s bf16 and f16 forms take head dims {HEAD_DIMS_16}, '
            f'not {d} (a {d}-value row is under their 64-byte TMA swizzle span; head dim 16 '
            'runs in float32 only)'
        )
    for t in (q, k, v):
        if t.device.type != 'cuda':
            raise ValueError(f'flash attention runs on cuda or cpu, not {t.device}')
        if t.dtype not in ENTRY or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(
                'the flash attention kernel takes contiguous float32, bfloat16 or '
                f'float16 (B, S, H, D) tensors of one dtype; got {t.dtype} (q: '
                f'{q.dtype}), contiguous={t.is_contiguous()}'
            )
        if t.data_ptr() % 16:
            raise ValueError('the flash attention kernel takes tensors on 16-byte boundaries')
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        code = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, h, s_q, s_k, d, int(q_offset),
            int(k_offset), int(causal), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check('flash_attn', code)
    build.count(flash_attention_partials, q.dtype)
    by_d = flash_attention_partials.launches_by_head_dim
    by_d[d] = by_d.get(d, 0) + 1
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
    twice, mergeable by ``models.attention._merge``. Differentiable. Each
    kernel launch adds one to ``flash_attention_partials.launches``, to
    ``launches_by_dtype[q.dtype]`` and to ``launches_by_head_dim[D]``.
    """
    return _FlashPartials.apply(q, k, v, int(q_offset), int(k_offset), bool(causal))


flash_attention_partials.launches_by_head_dim = {}
build.reset_counts(flash_attention_partials)
