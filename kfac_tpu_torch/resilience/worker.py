"""A training process for the real-signal preemption tests (counterpart of
``testing/resilience_worker.py``).

Trains the port's MLP (6 -> 8 -> 4, seeded regression data) through
``Trainer(checkpoints=CheckpointManager(...))``, resuming from the rotation
when it holds a checkpoint, and prints one JSON line per event (``start``,
``step``, ``preempted``, ``done``). A SIGTERM makes the next step boundary
save an emergency checkpoint and raise ``Preempted``; the process then
prints its ``preempted`` event and exits 0.

    python -m kfac_tpu_torch.resilience.worker CKPT_DIR MAX_STEPS SAVE_INTERVAL \
        [STEP_SLEEP_S] [--device cpu] [--world W] [--frac F]

The device is ``cuda`` unless ``--device`` names another. ``--world W``
spawns ``W`` ranks (``parallel.spawn_world``: gloo on the CPU, NCCL on the
cards) that train a :class:`~kfac_tpu_torch.parallel.DistributedKFAC` at
gradient-worker fraction ``--frac`` on the global batch, each with its own
manager over the one rotation; every rank prints its ``start`` (with its
pid, the target of a signal), rank 0 its ``step`` events, and every rank
its ``preempted`` or ``done``. A SIGTERM to any one rank preempts them all
at one agreed step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def emit(**payload) -> None:
    """One JSON line on stdout, in one write: the ranks of a world share
    the pipe, and under ``PYTHONUNBUFFERED`` ``print`` writes the text and
    its newline apart, so two ranks' lines could merge."""
    sys.stdout.write(json.dumps(payload) + '\n')
    sys.stdout.flush()


def _data(dev) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 6)).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((6, 4))).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def train(
    rank: int,
    world: int,
    dev: torch.device,
    ckpt_dir: str,
    max_steps: int,
    save_interval: int,
    step_sleep: float = 0.0,
    frac: float | None = None,
) -> dict:
    """One process's run: resume from ``ckpt_dir``'s rotation or start
    fresh, then step to ``max_steps`` (or a preemption). ``frac`` None
    trains the dense engine in one process; a fraction trains a
    ``DistributedKFAC`` over the running ``torch.distributed`` world.
    Returns the last event."""
    from kfac_tpu_torch import KFACPreconditioner, Trainer, register_model
    from kfac_tpu_torch.models import MLP
    from kfac_tpu_torch.resilience import CheckpointManager, Preempted

    model = MLP(6, (8,), 4, seed=0, device=dev)
    batch = _data(dev)
    kfac = KFACPreconditioner(register_model(model, device=dev), kl_clip=None, device=dev)
    if frac is not None:
        from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh

        kfac = DistributedKFAC(kfac, kaisa_mesh(frac, device=dev))

    def loss_fn(model_state, b):
        return torch.mean((model(b[0]) - b[1]) ** 2), model_state

    manager = CheckpointManager(ckpt_dir, engine=kfac, save_interval_steps=save_interval, keep=2)
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.05), loss_fn,
        kfac=kfac, checkpoints=manager, device=dev,
    )
    state = trainer.restore_latest()
    if state is None:
        state = trainer.init()
    emit(event='start', rank=rank, world=world, pid=os.getpid(),
         resumed_step=state.kfac_state.step)
    loss = None
    try:
        for _ in range(state.kfac_state.step, max_steps):
            state, loss = trainer.step(state, batch)
            if rank == 0:
                emit(event='step', step=state.kfac_state.step, loss=float(loss))
            if step_sleep:
                time.sleep(step_sleep)
        manager.finalize()
        last = dict(
            event='done', rank=rank, final_step=state.kfac_state.step,
            loss=None if loss is None else float(loss), latest=manager.latest_step(),
        )
    except Preempted as exc:
        last = dict(
            event='preempted', rank=rank, signal=exc.signal_name, saved_step=exc.step,
            path=exc.path, latest=manager.latest_step(), rotation=manager.rotation_steps(),
        )
    finally:
        manager.close()
    emit(**last)
    return last


def _rank(rank, world, dev, *args) -> dict:
    return train(rank, world, dev, *args)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('ckpt_dir')
    p.add_argument('max_steps', type=int)
    p.add_argument('save_interval', type=int)
    p.add_argument('step_sleep', type=float, nargs='?', default=0.0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--world', type=int, default=None)
    p.add_argument('--frac', type=float, default=1.0)
    args = p.parse_args(argv)
    run = (args.ckpt_dir, args.max_steps, args.save_interval, args.step_sleep)
    if args.world is None:
        from kfac_tpu_torch.device import resolve_device

        train(0, 1, resolve_device(args.device), *run)
        return 0
    from kfac_tpu_torch.parallel import spawn_world

    backend = 'nccl' if args.device == 'cuda' else 'gloo'
    spawn_world(_rank, args.world, backend, args.device, args=(*run, args.frac), timeout_s=300)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
