"""The Newton-Schulz step of this tree against another source of
``csrc/newton_schulz.cu``, on one card, in one process.

Builds ``--other`` (a ``newton_schulz.cu`` whose ``ns_step_f32`` takes m,
x, mx, x_new, mx_new, partials, resid, d, tile_m, tile_n, stream) with this
tree's flags, then:

- ``two_d``: at d = 512, 513, 2048 and 2049 (the tile of ``plan``), the
  2-D launch of each source from the same inputs: ``bitwise`` (every
  output equal), and its ms from CUDA events over 100 back-to-back
  launches, three rounds in turns (other, this, this, other);
- ``stacked``: at :data:`STACKS`, this tree's ``fused_ns_step_stacked``
  against its slots' 2-D launches at the stack's tile: ``bitwise`` and
  both ms.

Run on the card from the repository root, with the other source extracted
first (``git show <commit>:kfac_tpu_torch/csrc/newton_schulz.cu >
build/other_ns.cu``)::

    python -m kfac_tpu_torch.ns_ab --other build/other_ns.cu

Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from kfac_tpu_torch.ops import build
from kfac_tpu_torch.ops import newton_schulz as ns

# (slots, d) of a rank's block of the flagship's A stores in the
# distributed engine: the (513, 512) bucket's 24 layers, fc1's 6 and fc2's
# 6 (padded to 8) at one card, (24, 6, 8) / 4 at four
STACKS = ((24, 513), (6, 513), (6, 2049), (2, 513), (2, 2049))

def other_launcher(source: Path):
    """``ns_step_f32`` of ``source``, built like this tree's."""
    fn = build.other_library('newton_schulz', source).ns_step_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def events_ms(fn, iters: int = 100) -> float:
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def start(slots: int, d: int, seed: int):
    """(m, x, mx) stacks as the solver's cold start meets them: damped
    covariances of 2048 rows and the Gershgorin starts."""
    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(seed)
    a = torch.randn(slots, 2048, d, generator=gen, device=dev)
    eye = torch.eye(d, device=dev)
    m = (a.mT @ a / 2048 + 0.003 * eye).contiguous()
    lam = m.abs().sum(-1).amax(-1)[:, None, None]
    return m, (eye / lam).contiguous(), (m / lam).contiguous()


def two_d(other) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (512, 513, 2048, 2049):
        m, x, mx = (t[0] for t in start(1, d, 0))
        tile = ns.plan(d, sms)
        rows, cols = ns.grid(d, tile)
        outs = {}

        def call_other(m=m, x=x, mx=mx, d=d, tile=tile, n=rows * cols):
            out = [torch.empty_like(m), torch.empty_like(m), torch.empty(n, device=m.device),
                   torch.empty((), device=m.device)]
            code = other(m.data_ptr(), x.data_ptr(), mx.data_ptr(), *(t.data_ptr() for t in out),
                         d, *tile, torch.cuda.current_stream().cuda_stream)
            build.check('newton_schulz', code)
            outs['other'] = (out[0], out[1], out[3])

        def call_this(m=m, x=x, mx=mx, tile=tile):
            # the launch under fused_ns_step, without its checks
            outs['this'] = ns._launch(m, x, mx, None, tile)

        calls = {'other': call_other, 'this': call_this}
        ms = {'other': [], 'this': []}
        for _ in range(3):
            for key in ('other', 'this', 'this', 'other'):
                ms[key].append(events_ms(calls[key]))
        print(json.dumps(dict(
            kind='two_d', d=d, tile=tile, other_ms=sorted(ms['other']), this_ms=sorted(ms['this']),
            bitwise=all(torch.equal(o, t) for o, t in zip(outs['other'], outs['this'])),
        )), flush=True)


def stacked() -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for slots, d in STACKS:
        m, x, mx = start(slots, d, 1)
        tile = ns.plan(d, sms, slots)

        def per_slot(m=m, x=x, mx=mx, tile=tile):
            return [ns.fused_ns_step(m[i], x[i], mx[i], tile=tile) for i in range(m.shape[0])]

        def stack(m=m, x=x, mx=mx):
            return ns.fused_ns_step_stacked(m, x, mx)

        got, ref = stack(), per_slot()
        ms = {'stacked': [], 'per_slot_2d': []}
        for _ in range(3):
            ms['stacked'].append(events_ms(stack, 30))
            ms['per_slot_2d'].append(events_ms(per_slot, 30))
        print(json.dumps(dict(
            kind='stacked', slots=slots, d=d, tile=tile,
            bitwise=all(torch.equal(got[k][i], ref[i][k]) for i in range(slots) for k in range(3)),
            **{k: sorted(v) for k, v in ms.items()},
        )), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--other', type=Path, required=True,
                        help='another source of csrc/newton_schulz.cu')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ns_ab runs on a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    two_d(other_launcher(args.other))
    stacked()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
