"""Preemption-safe training: the checkpoint autopilot and signal handling
(counterpart of ``kfac_tpu/resilience``: the manager and the signals).

``CheckpointManager`` owns a keep-N rotation of step-numbered checkpoint
directories with an atomically replaced ``LATEST`` pointer, drives
periodic async saves from the Trainer's step paths, flushes an emergency
blocking save when a preemption signal arrives, and restores the newest
good checkpoint with last-good fallback; across the ranks of a
``DistributedKFAC`` run it agrees on one emergency step and writes one
sharded checkpoint. ``worker`` is a training process for the real-signal
tests, in one process or a spawned world. The fleet controller and the
chaos harness are not ported.
"""

from kfac_tpu_torch.resilience import signals
from kfac_tpu_torch.resilience.manager import (
    CheckpointManager,
    Preempted,
    RestoreResult,
)

__all__ = ['CheckpointManager', 'Preempted', 'RestoreResult', 'signals']
