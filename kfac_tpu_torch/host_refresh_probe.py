"""The host-offloaded async refresh at an LM's full width, on one card.

The bench's LM (``bench_lm``'s configs, EIGEN, weights from seed 1, one
seeded batch) at cadence 10/10 under ``async_inverse='host'``, through
``Trainer.step`` for 21 steps: each step's ms (between two synchronises), each window
boundary's wait in the Trainer's pump, and the worker's refresh of one
window timed alone on the final factors (its numpy LAPACK eighs and the
upload, nothing else running).

Run on the card from the repository root::

    python -m kfac_tpu_torch.host_refresh_probe --config flagship

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any

import torch

from kfac_tpu_torch import bench_lm, checkpoint
from kfac_tpu_torch.async_inverse import host
from kfac_tpu_torch.device import resolve_device

EVERY = 10
STEPS = 2 * EVERY + 1  # boundaries (and pumps) at steps 10 and 20


def run(config: str, device: torch.device) -> dict[str, Any]:
    cfg = bench_lm.LM_CONFIGS[config]
    trainer = bench_lm.lm_trainer(
        cfg, device, kfac=True, factor_update_steps=EVERY, inv_update_steps=EVERY,
        async_inverse='host',
    )
    batch = bench_lm.lm_batch(cfg, device)
    kfac = trainer.kfac
    state = trainer.init()
    step_ms, waits = [], []
    for i in range(STEPS):
        bench_lm._sync(device)
        t0 = time.perf_counter()
        state, loss = trainer.step(state, batch)
        bench_lm._sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:  # the worker exists from the first launch on
            worker = kfac._async_worker
            take = worker.take

            def timed_take(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return take(*args, **kwargs)
                finally:
                    waits.append((time.perf_counter() - t) * 1e3)

            worker.take = timed_take
    take(wait=True)  # the last launch's refresh, out of the way
    ks = state.kfac_state
    effs = kfac._effective_damping(ks, kfac.damping)
    (effs, a, g), ready = checkpoint.snapshot((effs, ks.a, ks.g))
    if ready is not None:
        ready.synchronize()
    t0 = time.perf_counter()
    payload = host._dense_compute(kfac)(kfac.damping, effs, a, g)
    if payload['ready'] is not None:
        payload['ready'].synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    return {
        'config': config, 'cadence': [EVERY, EVERY], 'async_inverse': 'host',
        'layers': len(kfac.registry), 'steps': STEPS, 'step_ms': step_ms,
        'boundary_wait_ms': waits, 'worker_refresh_alone_ms': refresh_ms,
        'last_loss': float(loss),
    }


def main(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', choices=sorted(bench_lm.LM_CONFIGS), default='flagship')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        print(bench_lm.nvidia_smi(), flush=True)
    record = run(args.config, device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
