"""The grouped kl-clip dot of this tree against another source of
``csrc/klclip.cu``, on one card, in one process.

Builds ``--other`` (a ``klclip.cu`` whose ``klclip_dot_multi_f32`` takes
the eight arguments it took before the norm epilogue: table, count,
partials, capacity, out, lr2, kl_clip, stream) with this tree's flags, then
at the flagship's 36 preconditioned gradients and at the digits MLP's 2:

- ``bitwise``: this tree's terms, sum and scale, without norms and with,
  equal bit for bit to the other source's;
- ``device_ms``: each one's device time from torch.profiler, in turns
  (this, other, other, this), and the norm instantiation's.

Run on the card from the repository root, with the other source extracted
first (``git show <commit>:kfac_tpu_torch/csrc/klclip.cu > build/other.cu``)::

    python -m kfac_tpu_torch.klclip_ab --other build/other.cu

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import array
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from kfac_tpu_torch.ops import build, klclip

FLAGSHIP_PMATS = [(512, 513)] * 24 + [(2048, 513)] * 6 + [(512, 2049)] * 6
DIGITS_PMATS = [(64, 65), (10, 65)]
DOT_KERNELS = ('klclip_dot_multi_kernel', 'klclip_dot_final_kernel')


def other_launcher(source: Path):
    """``klclip_dot_multi_f32`` of ``source``, built like this tree's."""
    fn = build.other_library('klclip', source).klclip_dot_multi_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def other_dot_many(fn, ps, gs, lr, kl_clip):
    """``(terms, vg_sum, scale)`` of the other source, as
    :func:`klclip.klclip_dot_many` calls this tree's."""
    count = len(ps)
    capacity = sum(-(-p.numel() // klclip.BLOCK_ELEMS) + 1 for p in ps)
    out = torch.empty(count + 2 + capacity, device=ps[0].device)
    rows = array.array(
        'q', [x for p, g in zip(ps, gs) for x in (p.data_ptr(), g.data_ptr(), p.numel())]
    )
    code = fn(
        rows.buffer_info()[0], count, out[count + 2:].data_ptr(), capacity, out.data_ptr(),
        lr ** 2, kl_clip, torch.cuda.current_stream().cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f'the other klclip_dot_multi_f32 returned {code}')
    return out[:count], out[count], out[count + 1]


def device_ms(fn, calls: int = 20) -> float:
    """Device ms of one ``fn()``: the dot's two kernels from torch.profiler,
    after 100 lead kernels (a trace can lose a pass's first records)."""
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
        evt.self_device_time_total / 1e3 / evt.count for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.count
        and any(n in evt.key for n in DOT_KERNELS)
    )


def compare(fn, shapes, lr=0.1, kl_clip=0.001) -> dict:
    gen = torch.Generator('cuda').manual_seed(0)
    ps = [torch.randn(*s, generator=gen, device='cuda') for s in shapes]
    gs = [torch.randn(*s, generator=gen, device='cuda') for s in shapes]
    ours = klclip.klclip_dot_many(ps, gs, lr, kl_clip)
    theirs = other_dot_many(fn, ps, gs, lr, kl_clip)
    with_norms = klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip)
    bitwise = all(torch.equal(a, b) for a, b in zip(ours, theirs))
    bitwise_norms = all(torch.equal(a, b) for a, b in zip(with_norms[:3], theirs))
    turns = {'this': [], 'other': []}
    for who in ('this', 'other', 'other', 'this'):
        call = (
            (lambda: klclip.klclip_dot_many(ps, gs, lr, kl_clip)) if who == 'this'
            else (lambda: other_dot_many(fn, ps, gs, lr, kl_clip))
        )
        turns[who].append(device_ms(call))
    return dict(
        pairs=len(shapes), elements=sum(p.numel() for p in ps),
        bitwise_without_norms=bitwise, bitwise_with_norms=bitwise_norms,
        device_ms_this=turns['this'], device_ms_other=turns['other'],
        device_ms_norms=device_ms(lambda: klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip)),
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--other', required=True, type=Path, help='the other klclip.cu')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('klclip_ab: no CUDA device is visible', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fn = other_launcher(args.other)
    out = {
        'flagship': compare(fn, FLAGSHIP_PMATS),
        'digits': compare(fn, DIGITS_PMATS),
    }
    print(json.dumps(dict(phase='klclip_ab', other=str(args.other), **out)), flush=True)
    ok = all(v['bitwise_without_norms'] and v['bitwise_with_norms'] for v in out.values())
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
