"""Shared glue of the port's example trainers (counterpart of
``examples/common.py``): flags, the learning-rate schedule, the optimizer
chain, losses and metrics, the K-FAC engine from the flags, the input
pipeline and the epoch checkpoints.

The flag groups are the JAX scripts' (names and defaults), plus
``--device`` (``cuda`` unless the caller names the CPU). The optimizer
chain is :class:`ChainSGD`: optax's ``add_decayed_weights`` or
``clip_by_global_norm``, then ``sgd(schedule, momentum)``, applied to the
preconditioned grads in that order, as the JAX Trainer applies its optax
chain. One process drives one card: under ``torchrun`` (or any launcher
that sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)
:func:`distributed_init` joins the world (NCCL on the card, gloo on the
CPU); without one the scripts run the dense engine in one process.
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
import tempfile
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kfac_tpu_torch import checkpoint, data as data_lib
from kfac_tpu_torch.preconditioner import KFACPreconditioner


def distributed_init(device: torch.device, need_group: bool = False) -> bool:
    """Join the launcher's world before the first collective. Under a
    launcher (``WORLD_SIZE`` in the environment) this process's rank joins
    ``env://`` with NCCL on the card (gloo on the CPU), on ``cuda:<LOCAL_RANK>``;
    a world that is already initialized (``spawn_world``) is kept. With
    ``need_group`` and no launcher (a pipeline in one process) a world of
    one is made here. Returns whether this call made the world (the caller
    destroys it at the end)."""
    if dist.is_initialized():
        return False
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if 'WORLD_SIZE' in os.environ:
        if device.type == 'cuda':
            torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', '0')))
        dist.init_process_group(backend, init_method='env://')
        return True
    if not need_group:
        return False
    os.environ.setdefault('LOCAL_RANK', '0')
    root = tempfile.mkdtemp(prefix='kfac_world_')
    dist.init_process_group(
        backend, init_method='file://' + os.path.join(root, 'rendezvous'), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=600),
    )
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def log(*args) -> None:
    """Print on rank 0 only."""
    if is_rank0():
        print(*args, flush=True)


def add_kfac_args(parser: argparse.ArgumentParser) -> None:
    """The reference's K-FAC flags (the JAX scripts' names and defaults)."""
    g = parser.add_argument_group('kfac')
    g.add_argument('--kfac', action='store_true', default=True)
    g.add_argument('--no-kfac', dest='kfac', action='store_false')
    g.add_argument('--kfac-factor-update-steps', type=int, default=10)
    g.add_argument('--kfac-inv-update-steps', type=int, default=100)
    g.add_argument('--kfac-damping', type=float, default=0.003)
    g.add_argument('--kfac-factor-decay', type=float, default=0.95)
    g.add_argument('--kfac-kl-clip', type=float, default=0.001)
    g.add_argument(
        '--kfac-compute-method', choices=('auto', 'eigen', 'inverse'), default='auto',
        help="auto picks the engine's default for the device (eigen on the card)",
    )
    g.add_argument(
        '--kfac-strategy', choices=('comm-opt', 'mem-opt', 'hybrid-opt'), default='comm-opt',
        help='maps to grad_worker_fraction 1 / 1/world / 0.5',
    )
    g.add_argument('--kfac-skip-layers', nargs='*', default=[])
    g.add_argument(
        '--kfac-bucket-granularity', type=int, default=None,
        help='size-class rounding of the distributed factor buckets (1 = exact dims)',
    )
    g.add_argument('--kfac-verbose', action='store_true',
                   help='print the registration and assignment at construction')


def add_metrics_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group('metrics')
    g.add_argument('--metrics-csv', default=None, help='append step,name,value rows here')


def add_train_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group('training')
    g.add_argument('--epochs', type=int, default=3)
    g.add_argument('--batch-size', type=int, default=128)
    g.add_argument('--lr', type=float, default=0.1)
    g.add_argument('--momentum', type=float, default=0.9)
    g.add_argument('--weight-decay', type=float, default=5e-4)
    g.add_argument('--warmup-epochs', type=float, default=1)
    g.add_argument('--lr-decay', nargs='*', type=float, default=[0.5, 0.75])
    g.add_argument('--seed', type=int, default=42)
    g.add_argument('--data-dir', default=None)
    g.add_argument('--checkpoint-dir', default=None)
    g.add_argument('--resume', action='store_true',
                   help='resume from the latest checkpoint in --checkpoint-dir')
    g.add_argument('--augment', action='store_true', default=None,
                   help='random crop + flip on training images (default: on with a real dataset)')
    g.add_argument('--no-augment', dest='augment', action='store_false')
    g.add_argument('--bf16', action='store_true')
    g.add_argument('--limit-steps', type=int, default=None, help='cap steps per epoch (smoke runs)')
    g.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")


def strategy_fraction(name: str, world: int) -> float:
    """The gradient-worker fraction of a KAISA strategy at ``world``
    data-parallel ranks."""
    if world < 1:
        raise ValueError(f'data-parallel world is {world}; model/seq shards exceed the device count')
    if name == 'mem-opt':
        return 1.0 / world
    return {'comm-opt': 1.0, 'hybrid-opt': 0.5}[name]


def make_lr_schedule(base_lr, steps_per_epoch, epochs, warmup_epochs, decay_at) -> Callable[[int], float]:
    """Warmup and step decay as a function of the step: ``base_lr`` times
    0.1 for each boundary ``int(d * epochs * steps_per_epoch)`` the step has
    reached, times ``min(1, (step + 1) / warmup)``, in float32 as the JAX
    schedule (optax's ``piecewise_constant_schedule`` times the warmup)
    computes it."""
    boundaries = sorted({int(d * epochs * steps_per_epoch) for d in decay_at})
    warmup = int(warmup_epochs * steps_per_epoch)

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for b in boundaries:
            if step >= b:
                v = np.float32(v * np.float32(0.1))
        w = np.minimum(np.float32(1.0), np.float32(step + 1) / np.float32(max(1, warmup)))
        return float(np.float32(v * w))

    return schedule


class ChainSGD(torch.optim.Optimizer):
    """optax's ``chain(add_decayed_weights(weight_decay) or
    clip_by_global_norm(clip_norm), sgd(lr, momentum))`` as a
    ``torch.optim`` optimizer: each step adds ``weight_decay * p`` to the
    grads, or scales them by ``clip_norm / norm`` where their global norm
    is at least ``clip_norm`` (on the device: no host sync), then keeps
    the momentum trace ``m = g + momentum * m`` and updates ``p -= lr(t) *
    m``, ``lr`` a constant or a schedule of the step ``t`` (0 first).

    ``norm_groups``: where a rank holds part of the model (a pipeline
    stage, a tensor-parallel shard), ``[(parameters, [process groups])]``:
    the squares of those parameters' grads are summed over each group in
    turn before they join the norm; the other parameters' grads are the
    same on every rank and count once."""

    def __init__(self, params: Iterable, lr: float | Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 0.0, clip_norm: float | None = None,
                 norm_groups: list[tuple[Iterable, list]] | None = None):
        super().__init__(params, dict(momentum=momentum))
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.norm_groups = [({id(p) for p in ps}, groups) for ps, groups in norm_groups or []]
        self.count = 0

    def _global_norm(self, params, grads) -> torch.Tensor:
        parts = [torch.zeros((), device=grads[0].device) for _ in range(len(self.norm_groups) + 1)]
        for p, g in zip(params, grads):
            i = next((i for i, (ids, _) in enumerate(self.norm_groups) if id(p) in ids),
                     len(self.norm_groups))
            parts[i] = parts[i] + torch.sum(g * g)
        for part, (_, groups) in zip(parts, self.norm_groups):
            for group in groups:
                if group is not None and dist.get_world_size(group) > 1:
                    dist.all_reduce(part, group=group)
        return torch.sqrt(sum(parts))

    def state_dict(self) -> dict:
        out = super().state_dict()
        out['count'] = self.count
        return out

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop('count'))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g['params'] if p.grad is not None]
        grads = [p.grad for p in params]
        if self.weight_decay:
            grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        if self.clip_norm is not None:
            norm = self._global_norm(params, grads)
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, g / norm * self.clip_norm) for g in grads]
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        momentum = self.param_groups[0]['momentum']
        for p, g in zip(params, grads):
            st = self.state[p]
            m = st.get('momentum_buffer')
            m = g.clone() if m is None else g + momentum * m
            st['momentum_buffer'] = m
            p.sub_(m * lr)
        self.count += 1


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean softmax cross entropy of integer labels, in f32."""
    del num_classes
    return F.cross_entropy(logits.float(), labels.long())


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                         smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross entropy (optax's ``smooth_labels``: one-hot
    times ``1 - smoothing`` plus ``smoothing / num_classes``)."""
    soft = F.one_hot(labels.long(), num_classes).float() * (1.0 - smoothing) + smoothing / num_classes
    return -(soft * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


class MetricsWriter:
    """Append-only ``step,name,value`` CSV (rank 0 writes), flushed a line
    at a time so a killed run keeps its trail."""

    def __init__(self, path: str | None) -> None:
        self._f = None
        if path and is_rank0():
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            self._f = open(path, 'a', buffering=1)
            if self._f.tell() == 0:
                self._f.write('step,name,value\n')

    def write(self, step: int, name: str, value) -> None:
        if self._f is not None:
            self._f.write(f'{step},{name},{float(value):.8g}\n')

    def write_many(self, step: int, metrics: dict) -> None:
        for name, value in metrics.items():
            self.write(step, name, value)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Metric:
    """Streaming average: ``update(value, n)`` adds ``n`` samples of
    ``value`` (a tensor is read on the host)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1) -> None:
        self.total += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.total / max(1, self.count)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    return float((torch.argmax(logits, -1) == labels).float().mean())


class Timer:
    def __init__(self) -> None:
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start


def build_kfac(args, registry, grid=None, lr=None, device='cuda', verbose_dump=True):
    """The preconditioner from the flags: a ``DistributedKFAC`` over
    ``grid`` when there is one, else the dense ``KFACPreconditioner`` (None
    with ``--no-kfac``). ``lr`` is the optimizer's schedule, so the
    kl-clip scale reads the live learning rate."""
    if not args.kfac:
        return None
    cfg = KFACPreconditioner(
        registry,
        factor_update_steps=args.kfac_factor_update_steps,
        inv_update_steps=args.kfac_inv_update_steps,
        damping=args.kfac_damping,
        factor_decay=args.kfac_factor_decay,
        kl_clip=args.kfac_kl_clip,
        lr=args.lr if lr is None else lr,
        compute_method=None if args.kfac_compute_method == 'auto' else args.kfac_compute_method,
        bucket_granularity=args.kfac_bucket_granularity,
        device=device,
    )
    engine = cfg
    if grid is not None:
        from kfac_tpu_torch.parallel import DistributedKFAC

        engine = DistributedKFAC(cfg, grid)
    if verbose_dump and getattr(args, 'kfac_verbose', False):
        log(engine.describe())
    return engine


def log_inverse_residuals(args, kfac_engine, kfac_state) -> None:
    """Under ``--kfac-verbose``, the worst damped-inverse residual of an
    INVERSE engine's state (a no-op under EIGEN or without K-FAC)."""
    if not getattr(args, 'kfac_verbose', False) or kfac_engine is None or kfac_state is None:
        return
    fn = getattr(kfac_engine, 'inverse_residuals', None)
    if fn is None:
        return
    try:
        res = fn(kfac_state)
    except ValueError:  # EIGEN: nothing to report
        return
    worst = max(float(torch.as_tensor(r).max()) for side in res.values() for r in side.values())
    from kfac_tpu_torch.ops.factors import NS_FALLBACK_RESIDUAL

    flag = '' if worst <= NS_FALLBACK_RESIDUAL else '  [ABOVE FALLBACK THRESHOLD]'
    log(f'  kfac inverse residual (worst slot): {worst:.2e}{flag}')


def make_epoch_batches(args, x_train, y_train, augment: bool, start_epoch: int = 0,
                       normalize_stats=None, rank: int = 0, world: int = 1):
    """The trainers' input pipeline: ``epoch_batches(epoch)`` yields this
    rank's rows of each global batch (numpy NHWC), augmented and then
    normalized (``normalize_stats=(mean, std)``) in the reference's order.
    ``--native-loader`` takes batches from :class:`~kfac_tpu_torch.utils.
    native_loader.PrefetchLoader` (crop and flip in its worker, its shuffle
    advanced to ``start_epoch``); a loader that cannot be built raises.
    Otherwise the seeded Python batches (``seed + epoch``) with numpy
    augmentation (``seed * 1000 + epoch``), as the JAX pipeline."""
    rows = data_lib.rank_rows(args.batch_size, rank, world)
    prefetcher = None
    if getattr(args, 'native_loader', False):
        from kfac_tpu_torch.utils import native_loader

        prefetcher = native_loader.PrefetchLoader(
            x_train, y_train, batch_size=args.batch_size, seed=args.seed,
            augment={'pad': 4, 'flip': True} if augment else None, start_epoch=start_epoch,
        )

    def epoch_batches(epoch):
        if prefetcher is not None:
            # the worker shuffles the whole dataset: each rank keeps its rows
            it = ((x[rows], y[rows]) for x, y in prefetcher.epoch_batches())
            aug_rng = None
        else:
            it = data_lib.batches(x_train, y_train, args.batch_size, args.seed + epoch,
                                  rank=rank, world=world)
            aug_rng = np.random.default_rng(args.seed * 1000 + epoch) if augment else None
        for xb, yb in it:
            if aug_rng is not None:
                if world > 1:
                    raise NotImplementedError(
                        'numpy augmentation draws for the global batch; with more than one rank '
                        'use --native-loader (augmentation in its worker)'
                    )
                xb = data_lib.augment_images(xb, aug_rng)
            if normalize_stats is not None:
                xb = data_lib.normalize(xb, *normalize_stats)
            yield xb, yb

    epoch_batches.loader = prefetcher
    return epoch_batches


# ------------------------------------------------------------- checkpoints


def _epoch_dir(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f'e{epoch:05d}')


def save_checkpoint(checkpoint_dir: str, kfac_state: Any, extra: dict[str, Any], epoch: int = 0,
                    kfac_engine: Any = None) -> str:
    """Write the training state of ``epoch`` into ``<dir>/eNNNNN``:
    ``kfac`` through :func:`kfac_tpu_torch.checkpoint.save` (the K-FAC
    state, ``extra`` beside it: parameters, optimizer, model state, the
    epoch; the engine's layout manifest), or without K-FAC ``plain.pt``
    (written, then renamed into place). Every rank of a distributed engine
    calls."""
    path = _epoch_dir(checkpoint_dir, epoch)
    extra = dict(extra, epoch=epoch)
    if kfac_state is not None:
        checkpoint.save(path + '/kfac', kfac_state, extra=extra, engine=kfac_engine, overwrite=True)
    elif is_rank0():
        os.makedirs(path, exist_ok=True)
        torch.save(extra, path + '/plain.pt.tmp')
        os.replace(path + '/plain.pt.tmp', path + '/plain.pt')
    log(f'checkpoint written to {path}')
    return path


def latest_checkpoint(checkpoint_dir: str) -> tuple[str, int] | None:
    """The newest epoch checkpoint whose payload is complete (a committed
    ``kfac`` or a ``plain.pt``), and its epoch; None if there is none."""
    root = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(root):
        return None
    epochs = [int(m.group(1)) for d in os.listdir(root) if (m := re.fullmatch(r'e(\d+)', d))]
    for e in sorted(epochs, reverse=True):
        path = _epoch_dir(checkpoint_dir, e)
        if checkpoint.is_committed(path + '/kfac') or os.path.exists(path + '/plain.pt'):
            return path, e
    return None


def restore_checkpoint(checkpoint_dir: str, kfac_engine: Any, extra_keys: Iterable[str]):
    """The latest checkpoint: ``(kfac_state, extra, next_epoch)``, the
    K-FAC state rematerialized (decompositions recomputed from the restored
    factors) and ``extra`` holding ``extra_keys``; None when there is
    none."""
    found = latest_checkpoint(checkpoint_dir)
    if found is None:
        return None
    path, epoch = found
    template = {k: None for k in (*extra_keys, 'epoch')}
    if checkpoint.is_committed(path + '/kfac'):
        kstate, extra = checkpoint.restore(path + '/kfac', kfac_engine, extra_template=template)
    else:
        kstate = None
        extra = torch.load(path + '/plain.pt', map_location='cpu', weights_only=False)
    log(f'resumed from {path} (epoch {epoch})')
    return kstate, extra, int(extra['epoch']) + 1

