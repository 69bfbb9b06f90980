"""The 16-bit ``sym_cov`` and flash kernels of this tree against other
sources of ``csrc/sym_cov.cu`` and ``csrc/flash_attn.cu``, on one card, in
one process.

Builds ``--sym-cov`` (a ``sym_cov.cu`` whose ``sym_cov_bf16`` / ``_f16``
take a, c, part, n, d, scale, splits, rows_per_split, stream, split by
``sym_cov.plan``) and ``--flash`` (a ``flash_attn.cu`` whose
``flash_attn_partials_bf16`` / ``_f16`` take this tree's arguments) with
this tree's flags, then, in bf16 and f16:

- ``sym_cov`` at the flagship's (8192, 513 / 2049 / 512 / 2048), this
  tree's ``a`` in the layout its A builders give (rows padded to 64 values
  at 513 and 2049), the other's contiguous;
- the flash partials at the flagship's (16, 512, 4, 128) on normal inputs
  and on ``flash_attention.exact_inputs``;

each with both sources' device ms from torch.profiler in turns (other,
this, this, other) and this tree's result against the other's
(``max_rel_err``: max |this - other| / max |other|; for flash, of acc).
Last, the host's cost of one launch's TMA map (``tma_encode_ns``).

Run on the card from the repository root, with the other sources
extracted first, e.g. those of the ``mma.sync`` forms::

    git show e746294:kfac_tpu_torch/csrc/sym_cov.cu > build/old_sym_cov.cu
    git show e746294:kfac_tpu_torch/csrc/flash_attn.cu > build/old_flash_attn.cu
    python -m kfac_tpu_torch.half_ab --sym-cov build/old_sym_cov.cu --flash build/old_flash_attn.cu

Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from kfac_tpu_torch.ops import build, flash_attention, sym_cov

HALF = {torch.bfloat16: 'bf16', torch.float16: 'f16'}
COVS = ((8192, 513), (8192, 2049), (8192, 512), (8192, 2048))
FLASH = (16, 512, 4, 128)
# the device kernels of each source
THIS_KERNELS = {'sym_cov': ('sym_cov_wgmma_kernel', 'sym_cov16_reduce_kernel'),
                'flash': ('flash_wgmma_kernel',)}
OTHER_KERNELS = {'sym_cov': ('sym_cov_mma16_kernel', 'sym_cov_reduce_kernel'),
                 'flash': ('flash_mma16_kernel',)}


def other_launchers(sym_cov_src: Path, flash_src: Path) -> dict:
    """``(kind, dtype) -> entry point`` of the other sources."""
    cov_lib = build.other_library('sym_cov', sym_cov_src)
    flash_lib = build.other_library('flash_attn', flash_src)
    out = {}
    for dt, tag in HALF.items():
        fn = getattr(cov_lib, f'sym_cov_{tag}')
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        out['sym_cov', dt] = fn
        fn = getattr(flash_lib, f'flash_attn_partials_{tag}')
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out['flash', dt] = fn
    return out


def other_sym_cov(fn, a: torch.Tensor) -> torch.Tensor:
    """The other source's ``a^T a / n`` of a contiguous ``a``."""
    n, d = a.shape
    p = sym_cov.plan(n, d, sym_cov.sm_count(a.device.index))
    part = sym_cov.scratch(p, a.device)
    out = torch.empty(d, d, dtype=a.dtype, device=a.device)
    code = fn(a.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(), n, d,
              float(n), p.splits, p.rows_per_split, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'the other sym_cov returned {code}')
    return out


def other_flash(fn, q, k, v):
    """The other source's causal partials (acc, m, l) at offsets 0."""
    b, s, h, d = q.shape
    acc = torch.empty(q.shape, device=q.device)
    m = torch.empty(b, h, s, device=q.device)
    l = torch.empty_like(m)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
              l.data_ptr(), b, h, s, s, d, 0, 0, 1, d ** -0.5,
              torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'the other flash kernel returned {code}')
    return acc, m, l


def device_ms(fn, names, calls: int = 20) -> float:
    """Device ms of one ``fn()``: the kernels whose names hold one of
    ``names``, from torch.profiler, after 100 lead kernels (a trace can
    lose a pass's first records)."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, device='cuda')
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            lead.add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(
        evt.self_device_time_total / 1e3 for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.count and any(n in evt.key for n in names)
    ) / calls


def turns(kind: str, this, other) -> dict:
    """Device ms of each source in turns: other, this, this, other."""
    out = {'this': [], 'other': []}
    for who in ('other', 'this', 'this', 'other'):
        fn, names = (this, THIS_KERNELS[kind]) if who == 'this' else (other, OTHER_KERNELS[kind])
        out[who].append(device_ms(fn, names))
    return {'device_ms_this': out['this'], 'device_ms_other': out['other']}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--sym-cov', required=True, type=Path, help='the other sym_cov.cu')
    p.add_argument('--flash', required=True, type=Path, help='the other flash_attn.cu')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('half_ab: no CUDA device is visible', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    others = other_launchers(args.sym_cov, args.flash)
    gen = torch.Generator('cuda').manual_seed(0)
    dev = torch.device('cuda')
    for dt, tag in HALF.items():
        for n, d in COVS:
            a = torch.randn(n, d, generator=gen, device=dev).to(dt)
            ours = sym_cov.kernel_rows(n, d, dt, dev, d % sym_cov.ROW_ALIGN16 != 0).copy_(a)
            fn = others['sym_cov', dt]
            row = dict(
                phase='half_ab', kernel='sym_cov', dtype=tag, shape=[n, d],
                max_rel_err=rel_err(sym_cov.sym_cov(ours), other_sym_cov(fn, a)),
                **turns('sym_cov', lambda: sym_cov.sym_cov(ours), lambda: other_sym_cov(fn, a)),
            )
            print(json.dumps(row), flush=True)
        b, s, h, hd = FLASH
        cpu_gen = torch.Generator().manual_seed(1)
        for inputs in ('normal', 'exact'):
            if inputs == 'exact':
                q, k, v = (x.to(dev) for x in flash_attention.exact_inputs(b, s, h, hd, dt, cpu_gen))
            else:
                q, k, v = (torch.randn(*FLASH, generator=gen, device=dev).to(dt) for _ in range(3))
            fn = others['flash', dt]

            def this():
                return flash_attention.flash_attention_partials(q, k, v, 0, 0, True)

            def other():
                return other_flash(fn, q, k, v)

            got, want = this(), other()
            row = dict(
                phase='half_ab', kernel='flash_attention_partials', dtype=tag, shape=list(FLASH),
                inputs=inputs, max_rel_err=rel_err(got[0], want[0]),
                m_l_max_rel_err=max(rel_err(x, w) for x, w in zip(got[1:], want[1:])),
                **turns('flash', this, other),
            )
            print(json.dumps(row), flush=True)
    encode = build.library('sym_cov').sym_cov_tma_encode_ns
    encode.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    encode.restype = ctypes.c_longlong
    maps = {}
    for n, d in ((8192, 2049), (100, 65), (128, 8)):
        a = sym_cov.kernel_rows(n, d, torch.bfloat16, dev, True)
        maps[f'{n}x{d}'] = encode(a.data_ptr(), a.stride(0), n, d, 10000)
    print(json.dumps(dict(phase='half_ab', tma_encode_ns=maps)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
