"""A training process for the real-signal preemption test (counterpart of
``testing/resilience_worker.py``).

Trains the port's MLP (6 -> 8 -> 4, seeded regression data) through
``Trainer(checkpoints=CheckpointManager(...))``, resuming from the rotation
when it holds a checkpoint, and prints one JSON line per event (``start``,
``step``, ``preempted``, ``done``). A SIGTERM makes the next step boundary
save an emergency checkpoint and raise ``Preempted``; the process then
prints its ``preempted`` event and exits 0.

    python -m kfac_tpu_torch.resilience.worker CKPT_DIR MAX_STEPS SAVE_INTERVAL \
        [STEP_SLEEP_S] [--device cpu]

The device is ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def emit(**payload) -> None:
    print(json.dumps(payload), flush=True)


def main(argv: list[str] | None = None) -> int:
    from kfac_tpu_torch import KFACPreconditioner, Trainer, register_model
    from kfac_tpu_torch.models import MLP
    from kfac_tpu_torch.resilience import CheckpointManager, Preempted

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('ckpt_dir')
    p.add_argument('max_steps', type=int)
    p.add_argument('save_interval', type=int)
    p.add_argument('step_sleep', type=float, nargs='?', default=0.0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 6)).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((6, 4))).astype(np.float32)
    model = MLP(6, (8,), 4, seed=0, device=args.device)
    dev = next(model.parameters()).device
    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    kfac = KFACPreconditioner(register_model(model, device=dev), kl_clip=None, device=dev)

    def loss_fn(model_state, b):
        return torch.mean((model(b[0]) - b[1]) ** 2), model_state

    manager = CheckpointManager(
        args.ckpt_dir, engine=kfac, save_interval_steps=args.save_interval, keep=2
    )
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.05), loss_fn,
        kfac=kfac, checkpoints=manager, device=dev,
    )
    state = trainer.restore_latest()
    if state is None:
        state = trainer.init()
    emit(event='start', resumed_step=state.kfac_state.step)
    loss = None
    try:
        for _ in range(state.kfac_state.step, args.max_steps):
            state, loss = trainer.step(state, batch)
            emit(event='step', step=state.kfac_state.step, loss=float(loss))
            if args.step_sleep:
                time.sleep(args.step_sleep)
        manager.finalize()
        emit(
            event='done', final_step=state.kfac_state.step,
            loss=None if loss is None else float(loss), latest=manager.latest_step(),
        )
    except Preempted as exc:
        emit(
            event='preempted', signal=exc.signal_name, saved_step=exc.step,
            path=exc.path, latest=manager.latest_step(),
            rotation=manager.rotation_steps(),
        )
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
