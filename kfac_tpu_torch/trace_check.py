"""How many device records a profiled pass of the bench's fused-kernel
probe loses, with the idle padding of ``bench_lm._profiled_pass`` and
without it, on one card, in one process.

Each pass launches ``bench_lm.PAD_KERNELS`` kernels before its first
marker and as many after its last, so a whole pass holds a known number
of device records. Passes alternate (padded, unpadded, unpadded, padded,
...); for each setting the line counts the passes that lost records,
those that lost a marker or a whole scope (``split_device_runs`` then
refuses them), and the most records one pass lost before its first
marker and after its last.

Run on the card from the repository root::

    python -m kfac_tpu_torch.trace_check --passes 200

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from kfac_tpu_torch import bench_lm
from kfac_tpu_torch.ops import build


def probe_variants(device: torch.device) -> dict:
    """The variants ``bench_lm.fused_kernel_probe`` profiles, by scope."""
    seen: dict = {}
    device_ms = bench_lm._device_ms
    bench_lm._device_ms = lambda variants, _: seen.update(variants) or {}
    try:
        bench_lm.fused_kernel_probe(device)
    finally:
        bench_lm._device_ms = device_ms
    return seen


def pass_losses(events: list, scopes: list[str]) -> dict:
    """The pass's records, those lost before its first marker and after its
    last (of ``PAD_KERNELS`` each), and whether it splits."""
    names = [name for _, _, name in sorted(events)]
    marks = [i for i, name in enumerate(names) if bench_lm.MARKER_KERNEL in name]
    pad = bench_lm.PAD_KERNELS
    return dict(
        records=len(names),
        lost_before=pad - marks[0] if marks else pad,
        lost_after=pad - (len(names) - 1 - marks[-1]) if marks else pad,
        splits='device_ms' in bench_lm.split_device_runs(events, scopes),
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--passes', type=int, default=200, help='passes of each setting')
    args = parser.parse_args()
    build.build()
    device = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = probe_variants(device)
    scopes = list(variants)
    settings = {'padded': bench_lm.PAD_SECONDS, 'unpadded': 0.0}
    rows: dict[str, list[dict]] = {k: [] for k in settings}
    t0 = time.perf_counter()
    for i in range(args.passes):
        for name in (('padded', 'unpadded') if i % 2 == 0 else ('unpadded', 'padded')):
            events = bench_lm._profiled_pass(variants, device, pad_seconds=settings[name])
            rows[name].append(pass_losses(events, scopes))
    full = max(r['records'] for v in rows.values() for r in v)
    out = {
        name: dict(
            pad_seconds=settings[name], passes=len(v),
            passes_losing_records=sum(r['records'] < full for r in v),
            passes_refused=sum(not r['splits'] for r in v),
            most_lost_before_first_marker=max(r['lost_before'] for r in v),
            most_lost_after_last_marker=max(r['lost_after'] for r in v),
        )
        for name, v in rows.items()
    }
    out.update(records_of_a_whole_pass=full, seconds=time.perf_counter() - t0)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
