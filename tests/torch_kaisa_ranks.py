"""Rank bodies of ``tests/test_torch_kaisa.py``'s gloo worlds.

Each rank of a world (``kfac_tpu_torch.parallel.spawn_world``) runs every
case of the spec in order and returns its results, numpy only. This
module imports neither JAX nor the JAX package: the ranks run the port
alone, on the CPU, and the test holds their results against the JAX
engine in the parent process.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import warnings

import numpy as np
import torch
import torch.distributed as dist

from kfac_tpu_torch import checkpoint, convert, tracing
from kfac_tpu_torch.async_inverse import host as async_host
from kfac_tpu_torch.compression import OffloadConfig
from kfac_tpu_torch.compression import offload as offload_lib
from kfac_tpu_torch.health import HealthConfig
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP, TransformerLM, lm_loss
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.observability.flight_recorder import PostmortemWriter, drain_flight
from kfac_tpu_torch.observability.metrics import MetricsCollector
from kfac_tpu_torch.ops import factors
from kfac_tpu_torch.parallel import DistributedKFAC, collectives, kaisa_mesh, multihost
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.resilience import CheckpointManager, Preempted, signals
from kfac_tpu_torch.training import Trainer

MLP_CFG = dict(in_features=6, features=(16, 12), num_classes=5)
LM_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=16)
# the engine of the one-step cases, as tests/parallel/test_kaisa_distributed.py
STEP_KW = dict(damping=0.01, kl_clip=0.001, lr=0.1)
TRAINER_KW = dict(damping=0.003, lr=0.1, factor_update_steps=1, inv_update_steps=2)
# the observed engine: the sentinel (a degrade on the first quarantined
# refresh), metrics and a flight ring of 4, as tests/test_health.py's
# stacked cases and tests/test_observability.py's distributed ones
OBS_KW = dict(damping=0.01, kl_clip=0.001, lr=0.1, metrics=True, flight=4)
OBS_HEALTH = dict(warn=False, degrade_after=1)
POISON = 'dense0'  # its A statistic is NaN on the observed run's step 1
OBS_STEPS = 3
# the checkpoint cases' engine (tests/test_aux.py's, with the sentinel)
CKPT_KW = dict(damping=0.01, kl_clip=None, lr=0.1)
# the ResNet case: CifarResNet(depth=8) at 8x8, cadence 1/2, as
# tests/test_torch_resnet.py's Trainer steps
RESNET_KW = dict(damping=0.01, lr=0.1, factor_update_steps=1, inv_update_steps=2)


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return tree


def tensors(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


class Wide(torch.nn.Module):
    """Three dense layers whose A factors share one dim and G factors two
    (the JAX test's ``Wide``): non-colocated stores then differ from the
    pair buckets."""

    def __init__(self):
        super().__init__()
        self.p, self.q, self.r = torch.nn.Linear(16, 16), torch.nn.Linear(16, 16), torch.nn.Linear(16, 4)

    def forward(self, x):
        return self.r(torch.relu(self.q(torch.relu(self.p(x)))))


class Hetero(torch.nn.Module):
    """Four dense layers of distinct widths (the JAX test's ``Hetero``)."""

    def __init__(self):
        super().__init__()
        self.l0, self.l1 = torch.nn.Linear(13, 19), torch.nn.Linear(19, 23)
        self.l2, self.l3 = torch.nn.Linear(23, 21), torch.nn.Linear(21, 5)

    def forward(self, x):
        for layer in (self.l0, self.l1, self.l2):
            x = torch.relu(layer(x))
        return self.l3(x)


class Twin(torch.nn.Module):
    """Two dense layers of one width: one store a side, two slots, so
    worlds of 1 and 2 ranks share its layout."""

    def __init__(self):
        super().__init__()
        self.u, self.v = torch.nn.Linear(8, 8), torch.nn.Linear(8, 8)

    def forward(self, x):
        return self.v(torch.relu(self.u(x)))


def build(spec, name):
    """(model, registry, loss_fn, global batch) of one of the spec's
    models, with the spec's weights."""
    if name == 'lm':
        model = TransformerLM(**LM_CFG, device='cpu')
        reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
        loss = lm_loss(model)
    else:
        model = {'mlp': lambda: MLP(**MLP_CFG, device='cpu'), 'wide': Wide, 'hetero': Hetero,
                 'twin': Twin}[name]()
        reg = registry.register_model(model, device='cpu')

        def loss(batch):
            x, y = batch
            return torch.mean((model(x) - y) ** 2)

    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in spec['weights'][name].items()})
    batch = tensors(spec['batches'][name])
    if name == 'lm':
        batch = tuple(b.long() for b in batch)
    return model, reg, loss, batch


def config(reg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return KFACPreconditioner(reg, device='cpu', **kw)


def local_grads_stats(dk, reg, loss, batch):
    """This rank's stats from its row block, and the mean grads."""
    run = capture.CurvatureCapture(reg).value_stats_and_grad(loss)
    (value, _), grads, stats = run(dk.mesh.local_rows(batch))
    grads, value = dk.average_grads(grads, value)
    return grads, stats, value


def case_step(spec, rank, frac, model='mlp', **kw):
    """One engine step from ``init``; the engine's reports; the dense
    engine's step on the global batch beside it."""
    _, reg, loss, batch = build(spec, model)
    cfg = config(reg, **kw)
    dk = DistributedKFAC(cfg, kaisa_mesh(frac, device='cpu'))
    grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
    state, pgrads = dk.step(dk.init(), grads, stats)
    out = {
        'grads': numpy_tree(pgrads),
        'state': convert.gather_dist_state(state, dk),
        'extract': numpy_tree(dk.extract_factors(state)),
        'memory': dk.memory_usage(state),
        'local_shapes': {
            f: {k: tuple(v.shape) for k, v in getattr(state, f).items()}
            for f in ('a', 'g', 'qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')
        },
        'factor_range': {sb.key: dk._factor_range(sb.padded) for sb in dk.a_store + dk.g_store},
        'column_range': {sb.key: dk._column_range(sb.padded) for sb in dk.a_store + dk.g_store},
        'slot_device': {
            side: {n: dk.slot_device(side, n) for n in reg.names()} for side in ('a', 'g')
        },
        'buckets': [tuple(b) for b in dk.buckets],
        'stores': ([tuple(sb) for sb in dk.a_store], [tuple(sb) for sb in dk.g_store]),
    }
    if dk._eigen:
        try:
            dk.inverse_residuals(state)
            out['residuals_raise'] = None
        except ValueError as err:
            out['residuals_raise'] = str(err)
    else:
        out['residuals'] = numpy_tree(dk.inverse_residuals(state))
    if rank == 0:
        run = capture.CurvatureCapture(reg).value_stats_and_grad(loss)
        _, g_all, s_all = run(batch)
        _, out['dense_grads'] = numpy_tree(cfg.step(cfg.init(), g_all, s_all))
        out['describe'] = dk.describe()
        out['comms'] = dk.comms_report()
        out['topology'] = dk.topology()
    return out


def case_convert(spec, rank, frac, jax_state, **kw):
    """A JAX state into this rank's shards and back, then one more step
    from it."""
    _, reg, loss, batch = build(spec, 'mlp')
    dk = DistributedKFAC(config(reg, **kw), kaisa_mesh(frac, device='cpu'))
    state = convert.from_jax_dist_state(jax_state, dk)
    back = convert.gather_dist_state(state, dk)
    grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
    state, pgrads = dk.step(state, grads, stats)
    return {
        'roundtrip': back,
        'grads': numpy_tree(pgrads),
        'state': convert.gather_dist_state(state, dk),
        'residuals': numpy_tree(dk.inverse_residuals(state)),
    }


def case_variants(spec, rank, frac, model, variants):
    """One step from ``init`` of each engine variant on the same grads
    and stats: {variant name: (grads, memory_usage, state fields)}."""
    _, reg, loss, batch = build(spec, model)
    out = {}
    for name, kw in variants.items():
        try:
            dk = DistributedKFAC(config(reg, **kw), kaisa_mesh(frac, device='cpu'))
        except ValueError as err:
            out[name] = {'raises': str(err)}
            continue
        fallbacks = factors.damped_inverse.cholesky_fallbacks
        grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
        state, pgrads = dk.step(dk.init(), grads, stats)
        out[name] = {
            'grads': numpy_tree(pgrads),
            'memory': dk.memory_usage(state),
            'fields': {f: sorted(getattr(state, f)) for f in ('da', 'dg', 'dgda')},
            'local_bytes': {
                f: {k: v.numel() * v.element_size() for k, v in getattr(state, f).items()}
                for f in ('qg', 'dgda')
            },
            'stores': ([sb.key for sb in dk.a_store], [sb.key for sb in dk.g_store]),
            'slots': {'a': dict(dk._a_slot), 'g': dict(dk._g_slot)},
            'buckets': len(dk.buckets),
            'cholesky_fallbacks': factors.damped_inverse.cholesky_fallbacks - fallbacks,
        }
    return out


def case_unexecuted(spec, rank, frac):
    """A factor update whose stats lack one layer."""
    _, reg, loss, batch = build(spec, 'mlp')
    dk = DistributedKFAC(config(reg, **STEP_KW), kaisa_mesh(frac, device='cpu'))
    _, stats, _ = local_grads_stats(dk, reg, loss, batch)
    partial = capture.CapturedStats(
        a={k: v for k, v in stats.a.items() if k != 'dense1'},
        g={k: v for k, v in stats.g.items() if k != 'dense1'},
    )
    state = dk.update_factors(dk.init(), partial)
    return numpy_tree(dk.extract_factors(state))


def case_train(spec, rank, frac, model, steps, kw, paths=('step',)):
    """``steps`` Trainer steps of the global batches in ``spec``: the
    losses of each path and the parameters after it (each path from the
    spec's weights)."""
    out = {}
    for path in paths:
        net, reg, loss, _ = build(spec, model)
        dk = DistributedKFAC(config(reg, **kw), kaisa_mesh(frac, device='cpu'))
        lr = 0.05 if model == 'mlp' else 0.1
        momentum = 0.0 if model == 'mlp' else 0.9
        trainer = Trainer(
            net, torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum),
            lambda ms, b: (loss(b), ms), kfac=dk, device='cpu',
        )
        state = trainer.init()
        batches = [tensors(b) for b in spec['train_batches'][model]][:steps]
        if model == 'lm':
            batches = [tuple(x.long() for x in b) for b in batches]
        losses = []
        if path == 'step':
            for b in batches:
                state, value = trainer.step(state, b)
                losses.append(float(value))
        elif path == 'scan_steps':
            state, values = trainer.scan_steps(
                state, tuple(torch.stack(x) for x in zip(*batches))
            )
            losses = values.tolist()
        else:  # step_accumulate: each batch in two micro-batches
            for b in batches:
                half = b[0].shape[0] // 2
                micro = [tuple(x[:half] for x in b), tuple(x[half:] for x in b)]
                state, value = trainer.step_accumulate(state, micro)
                losses.append(float(value))
        out[path] = {
            'losses': losses,
            'params': {n: p.detach().numpy().copy() for n, p in net.named_parameters()},
        }
    return out


def case_resnet(spec, rank, frac, steps):
    """``steps`` Trainer steps of ``CifarResNet(depth=8)`` with a
    ``DistributedKFAC`` on the global batches of ``spec['resnet']``
    (each rank its row block; BatchNorm moments over the global batch):
    the losses, the parameters and the running statistics; rank 0 also runs
    the dense engine on the global batches beside it."""
    out = {}
    for kind in ('kaisa', 'dense') if rank == 0 else ('kaisa',):
        net = resnet.CifarResNet(depth=8, device='cpu')
        net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in spec['resnet']['weights'].items()})
        reg = registry.register_model(net, device='cpu')
        engine = config(reg, **RESNET_KW)
        if kind == 'kaisa':
            engine = DistributedKFAC(engine, kaisa_mesh(frac, device='cpu'))
        trainer = Trainer(
            net, torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9),
            resnet.classification_loss(net), kfac=engine, device='cpu',
        )
        state = trainer.init(layers_lib.initial_model_state(net, 'cpu'))
        losses = []
        for x, y in spec['resnet']['batches'][:steps]:
            state, value = trainer.step(state, (torch.from_numpy(x), torch.from_numpy(y)))
            losses.append(float(value))
        out[kind] = {
            'losses': losses,
            'params': {n: p.detach().numpy().copy() for n, p in net.named_parameters()},
            'model_state': numpy_tree(state.model_state),
            'layers': len(reg),
        }
    return out


def poisoned(stats, layer=POISON, side='a'):
    """``stats`` with ``layer``'s ``side`` statistic NaN (``faults.poison_stats``)."""
    a, g = dict(stats.a), dict(stats.g)
    tgt = a if side == 'a' else g
    tgt[layer] = tgt[layer] + float('nan')
    return capture.CapturedStats(a=a, g=g)


def observability_tensors(state):
    """The state's health, metrics and flight tensors, as numpy."""
    out = {}
    for field in ('health', 'metrics', 'flight'):
        obj = getattr(state, field)
        out[field] = {
            f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        }
    return out


def case_observe(spec, rank, frac, root=None, **kw):
    """``OBS_STEPS`` engine steps of the MLP with the sentinel, metrics and
    the flight recorder on, step 1's statistics poisoned: each step's
    preconditioned grads and health counters, ``POISON``'s A factor after
    each step, the drains, and the state's observability tensors (held
    bitwise across the ranks). The dense engine goes through the same
    steps on the global batch beside it (on every rank: the ring's drain
    gathers); rank 0 returns it. With ``root``, a ``PostmortemWriter``
    with a checkpoint manager observes each step: its bundles (rank 0's)
    and the rotation."""
    _, reg, loss, batch = build(spec, 'mlp')
    cfg = config(reg, health=HealthConfig(**OBS_HEALTH), **OBS_KW, **kw)
    dk = DistributedKFAC(cfg, kaisa_mesh(frac, device='cpu'))
    grads, stats, value = local_grads_stats(dk, reg, loss, batch)
    pm = None
    if root is not None:
        mgr = CheckpointManager(os.path.join(root, 'rot'), engine=dk, install_signals=(),
                                async_save=False, save_interval_steps=None)
        pm = PostmortemWriter(os.path.join(root, 'pm'), engine=dk, checkpoint_manager=mgr)
    state, steps, bundles = dk.init(), [], []
    for i in range(OBS_STEPS):
        state, pg = dk.step(state, grads, poisoned(stats) if i == 1 else stats, loss=value)
        steps.append({
            'grads': numpy_tree(pg), 'health': tracing.health_counters(state),
            'poisoned_a': numpy_tree(dk.extract_factors(state)[POISON]['a']),
        })
        if pm is not None:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                bundle = pm.observe(state)
            if bundle is not None:
                bundles.append((os.path.basename(bundle), sorted(os.listdir(bundle))))
    out = {
        'steps': steps,
        'drain': MetricsCollector(include_health=False).drain(state),
        'ring': drain_flight(state),
        'tensors': observability_tensors(state),
        'describe': dk.describe(),
        'bundles': bundles,
        'rotation': None if pm is None else pm.checkpoint_manager.rotation_steps(),
    }
    run = capture.CurvatureCapture(reg).value_stats_and_grad(loss)
    (dense_value, _), g_all, s_all = run(batch)
    ds, dense_steps = cfg.init(), []
    for i in range(OBS_STEPS):
        ds, pg = cfg.step(ds, g_all, poisoned(s_all) if i == 1 else s_all, loss=dense_value)
        dense_steps.append({'grads': numpy_tree(pg), 'health': tracing.health_counters(ds)})
    dense = {
        'steps': dense_steps,
        'drain': MetricsCollector(include_health=False).drain(ds),
        'ring': drain_flight(ds),
    }
    if rank == 0:
        out['dense'] = dense
    return out


def caught(fn):
    """``(fn(), the messages of the warnings it raised)``."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter('always')
        result = fn()
    return result, [str(w.message) for w in ws]


def raised(fn):
    """The message of the ``ValueError`` ``fn`` raises (None if none)."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


def trained(engine, reg, loss, batch, steps=2, local=True):
    """``steps`` engine steps from ``init`` (step 1's statistics poisoned,
    so the health counters move) and the grads they took."""
    if local:
        grads, stats, _ = local_grads_stats(engine, reg, loss, batch)
    else:
        _, grads, stats = capture.CurvatureCapture(reg).value_stats_and_grad(loss)(batch)
    state = engine.init()
    for i in range(steps):
        state, _ = engine.step(state, grads, poisoned(stats) if i == 1 else stats)
    return state, grads


def case_checkpoint(spec, rank, frac, root):
    """``checkpoint.save`` of a ``DistributedKFAC`` state and its restores:
    the same layout, another bucket granularity, the dense engine (and a
    dense checkpoint into the distributed engine), the JAX package's
    refusals, ``save_factors`` / ``load_factors``, and, on more than one
    rank, a restore onto a world of half the ranks (a subgroup) and back.
    Each restore: its warnings, step, health counters, per-layer factors
    and the grads it preconditions."""
    net, reg, loss, batch = build(spec, 'mlp')
    kw = dict(CKPT_KW, health=HealthConfig(warn=False))

    def engine(mesh_frac=frac, group=None, **over):
        mesh = kaisa_mesh(mesh_frac, group=group, device='cpu')
        return None if mesh is None else DistributedKFAC(config(reg, **kw, **over), mesh)

    def summary(eng, state, grads, warned):
        return {
            'warnings': warned, 'step': state.step, 'health': tracing.health_counters(state),
            'factors': numpy_tree(eng.extract_factors(state)),
            'grads': numpy_tree(eng.precondition(state, grads)),
        }

    out = {}
    dk = engine()
    state, grads = trained(dk, reg, loss, batch)
    path = os.path.join(root, 'dist')
    extra = {'w': torch.arange(3.0) + rank}
    checkpoint.save(path, state, extra=extra, engine=dk)
    out['source'] = summary(dk, state, grads, [])
    gathered = convert.gather_dist_state(state, dk)
    out['source']['stacks'] = {side: gathered[side] for side in ('a', 'g')}
    out['manifest'] = checkpoint.layout_manifest(dk)
    (same, got_extra), warned = caught(lambda: checkpoint.restore(path, engine()))
    out['same'] = dict(summary(dk, same, grads, warned), extra=numpy_tree(got_extra), blocks_equal=all(
        torch.equal(getattr(same, f)[k], v) for f in ('a', 'g') for k, v in getattr(state, f).items()
    ))
    dk128 = engine(bucket_granularity=128)
    (g128, _), warned = caught(lambda: checkpoint.restore(path, dk128))
    out['granularity'] = summary(dk128, g128, grads, warned)
    dense = config(reg, **kw)
    _, g_all, _ = capture.CurvatureCapture(reg).value_stats_and_grad(loss)(batch)
    (ds, _), warned = caught(lambda: checkpoint.restore(path, dense))
    out['to_dense'] = summary(dense, ds, g_all, warned)
    dense_state, _ = trained(dense, reg, loss, batch, local=False)
    dpath = os.path.join(root, 'dense')
    checkpoint.save(dpath, dense_state, engine=dense)
    (fd, _), warned = caught(lambda: checkpoint.restore(dpath, dk))
    out['from_dense'] = dict(
        summary(dk, fd, grads, warned), source=numpy_tree(dense.extract_factors(dense_state)),
        source_health=tracing.health_counters(dense_state),
        source_manifest=checkpoint.layout_manifest(dense),
    )
    out['granularity']['manifest'] = checkpoint.layout_manifest(dk128)
    partial = registry.register_model(net, skip_layers=['head'], device='cpu')
    out['layer_set'] = raised(lambda: checkpoint.restore(
        dpath, DistributedKFAC(config(partial, **kw), kaisa_mesh(frac, device='cpu'))
    ))
    wide = MLP(MLP_CFG['in_features'], (20, 12), MLP_CFG['num_classes'], device='cpu')
    out['width'] = raised(lambda: checkpoint.restore(path, DistributedKFAC(
        config(registry.register_model(wide, device='cpu'), **kw, bucket_granularity=128),
        kaisa_mesh(frac, device='cpu'),
    )))
    fpath = os.path.join(root, 'factors.npz')
    checkpoint.save_factors(fpath, dk, state)
    out['factors_file'] = summary(dk128, checkpoint.load_factors(fpath, dk128), grads, [])
    world = dist.get_world_size()
    if world > 1:
        half = world // 2
        sub = dist.new_group(list(range(half)))
        small = engine(0.5 if half > 1 else 1.0, group=sub)
        epath = os.path.join(root, 'elastic')
        if small is not None:
            (es, _), warned = caught(lambda: checkpoint.restore(path, small))
            sgrads, sstats, _ = local_grads_stats(small, reg, loss, batch)
            out['shrunk'] = summary(small, es, sgrads, warned)
            es, _ = small.step(es, sgrads, sstats)
            out['shrunk_stepped'] = summary(small, es, sgrads, [])
            checkpoint.save(epath, es, engine=small)
        multihost.barrier('elastic')
        (gs, _), warned = caught(lambda: checkpoint.restore(epath, dk))
        out['grown'] = summary(dk, gs, grads, warned)
    return out


def case_manager(spec, rank, frac, root):
    """The manager across the ranks: a ``Trainer(checkpoints=)`` run that
    the last rank sends itself a real SIGTERM in, its restore beside the
    interrupted run continued in memory; the coordination cadence (a
    SIGUSR1 on rank 0 deferred off the cadence, then agreed at the largest
    step; a SIGTERM on the last rank preempting every rank); elastic
    restores through the manager (dense into the stacked engine at another
    granularity and back; the stacked engine at granularity 64 restored
    into 128)."""
    world = dist.get_world_size()
    out = {}

    def trainer(directory, **mgr_kw):
        net, reg, loss, _ = build(spec, 'mlp')
        dk = DistributedKFAC(config(reg, **CKPT_KW), kaisa_mesh(frac, device='cpu'))
        mgr = CheckpointManager(directory, **mgr_kw)
        t = Trainer(
            net, torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9),
            lambda ms, b: (loss(b), ms), kfac=dk, checkpoints=mgr, device='cpu',
        )
        return t, net, dk, mgr

    batch = tensors(spec['batches']['mlp'])
    t, net, dk, mgr = trainer(os.path.join(root, 'rot'), save_interval_steps=2, keep=2)
    on_step, seen = mgr.on_step, {}

    def recording(train_state, step=None):
        seen['state'] = train_state  # the state a Preempted leaves behind
        return on_step(train_state, step=step)

    mgr.on_step = recording
    state, losses = t.init(), []
    try:
        for i in range(10):
            if i == 3 and rank == world - 1:
                os.kill(os.getpid(), signal.SIGTERM)
            state, value = t.step(state, batch)
            losses.append(float(value))
        out['preempted'] = None
    except Preempted as exc:
        out['preempted'] = (exc.signal_name, exc.step, exc.path)
    out['losses'] = losses
    out['rotation'] = mgr.rotation_steps()
    out['latest'] = mgr.latest_step()
    mgr.close()
    t2, net2, _, mgr2 = trainer(os.path.join(root, 'rot'), install_signals=())
    restored = t2.restore_latest()
    out['restored_step'] = restored.kfac_state.step
    out['restored_params'] = {n: p.detach().numpy().copy() for n, p in net2.named_parameters()}
    out['saved_params'] = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    resumed = []
    for _ in range(2):
        restored, value = t2.step(restored, batch)
        resumed.append(float(value))
    resumed_params = [p.detach().clone() for p in net2.parameters()]
    # rebind_engine: the rotation's sharded checkpoint into the dense engine
    t2.rebind_engine(config(t2.kfac.registry, **CKPT_KW))
    rebound, warned = caught(t2.restore_latest)
    out['rebound'] = dict(
        step=rebound.kfac_state.step, warnings=warned, engine=type(t2.kfac).__name__,
        params_equal=all(torch.equal(p, q) for p, q in zip(net.parameters(), net2.parameters())),
    )
    mgr2.close()
    # the oracle: the interrupted run, rematerialized in memory, stepped on
    t.checkpoints = None
    state = seen['state']
    state = dataclasses.replace(state, kfac_state=dk.rematerialize(state.kfac_state))
    oracle = []
    for _ in range(2):
        state, value = t.step(state, batch)
        oracle.append(float(value))
    out['resumed'], out['oracle'] = resumed, oracle
    out['resumed_params_equal'] = all(
        torch.equal(p, q) for p, q in zip(net.parameters(), resumed_params)
    )

    # the coordination cadence
    kstate = state.kfac_state
    mgr = CheckpointManager(
        os.path.join(root, 'agree'), engine=dk, save_interval_steps=None, coordinate_every=4,
        async_save=False,
    )
    if rank == 0:
        os.kill(os.getpid(), signal.SIGUSR1)
    agree = {'off_cadence': mgr.on_step(kstate, step=3), 'pending': signals.preemption_requested()}
    agree['agreed_path'] = mgr.on_step(kstate, step=4 if rank == 0 else 8)
    agree['latest'] = mgr.latest_step()
    if rank == world - 1:
        os.kill(os.getpid(), signal.SIGTERM)
    try:
        mgr.on_step(kstate, step=12)
        agree['preempted'] = None
    except Preempted as exc:
        agree['preempted'] = (exc.signal_name, exc.step, exc.path)
    agree['rotation'] = mgr.rotation_steps()
    mgr.close()
    out['agree'] = agree

    # elastic restores through the manager (with the sentinel: the
    # trained states' counters move)
    _, reg, loss, _ = build(spec, 'mlp')
    kw = dict(CKPT_KW, health=HealthConfig(warn=False))
    dense = config(reg, **kw)
    dense_state, _ = trained(dense, reg, loss, batch, local=False)
    fwd = CheckpointManager(os.path.join(root, 'fwd'), engine=dense, install_signals=(), async_save=False)
    fwd.save(dense_state)
    dk128 = DistributedKFAC(config(reg, **kw, bucket_granularity=128), kaisa_mesh(frac, device='cpu'))
    result, warned = caught(lambda: fwd.restore_latest(engine=dk128))
    back = CheckpointManager(os.path.join(root, 'back'), engine=dk128, install_signals=(), async_save=False)
    back.save(result.state)
    dense2 = config(reg, **kw)
    home, warned_back = caught(lambda: back.restore_latest(engine=dense2))
    out['elastic'] = {
        'source': numpy_tree(dense.extract_factors(dense_state)),
        'stacked': numpy_tree(dk128.extract_factors(result.state)), 'step': result.step,
        'warnings': warned, 'back': numpy_tree(dense2.extract_factors(home.state)),
        'back_step': home.step, 'back_warnings': warned_back,
    }
    dk64 = DistributedKFAC(config(reg, **kw, bucket_granularity=64), kaisa_mesh(frac, device='cpu'))
    s64, _ = trained(dk64, reg, loss, batch)
    gran = CheckpointManager(os.path.join(root, 'gran'), engine=dk64, install_signals=(), async_save=False)
    gran.save(s64)
    result, warned = caught(lambda: gran.restore_latest(engine=dk128))
    out['override'] = {
        'source': numpy_tree(dk64.extract_factors(s64)),
        'restored': numpy_tree(dk128.extract_factors(result.state)), 'step': result.step,
        'warnings': warned, 'binding_kept': gran.engine is dk64,
    }
    return out


def case_multihost(spec, rank):
    """The cross-process helpers on this world: the counts, a gathered
    array, the votes, and the step check on equal and on differing
    steps."""
    del spec
    world = multihost.process_count()
    multihost.barrier('multihost case')
    out = {
        'count': world,
        'index': multihost.process_index(),
        'gathered': multihost.allgather_scalars([rank, 10.0 * rank + 0.5]),
        'emergency': multihost.agree_emergency(rank % 2 + 1, 100 - rank),
        'all_true': multihost.agree_decision(True),
        'last_false': multihost.agree_decision(rank != world - 1),
    }
    multihost.assert_same_step(7)
    try:
        multihost.assert_same_step(rank)
        out['mismatch'] = None
    except RuntimeError as err:
        out['mismatch'] = str(err)
    return out


# --------------------------------------------- the engines' last knobs

# the compressed transport's one-step engine (tests/test_compression.py's
# _setup with the one-step cases' kl-clip), on the bucketed transport
COMP_KW = dict(damping=0.01, kl_clip=0.001, lr=0.1, allreduce_method='allreduce_bucketed')
# the async refresh's window (cadence N/N) and its engine, kl-clip off
ASYNC_N = 4
ASYNC_KW = dict(damping=0.003, lr=0.1, kl_clip=None, factor_update_steps=ASYNC_N,
                inv_update_steps=ASYNC_N)
DECOMP_FIELDS = ('qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')


def full_ef(dk, state):
    """Each chunk's whole residual, the ranks' slices in rank order
    (a collective), as numpy; None without error feedback."""
    if state.comp_ef is None:
        return None
    return {k: collectives.all_gather_cat(v, dk.mesh.group).numpy() for k, v in state.comp_ef.items()}


def gathered(dk, state, fields=('a', 'g')):
    full = convert.gather_dist_state(state, dk)
    return {f: full[f] for f in fields}


def case_compressed(spec, rank, frac, comps):
    """One engine step from ``init`` at each wire of ``comps`` (name ->
    ``stat_compression``): the grads, the whole residuals, the factor
    stacks, the transport's counter and rank 0's ``stat_transport``."""
    _, reg, loss, batch = build(spec, 'mlp')
    out = {}
    for name, comp in comps.items():
        dk = DistributedKFAC(config(reg, stat_compression=comp, **COMP_KW), kaisa_mesh(frac, device='cpu'))
        grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
        state, pgrads = dk.step(dk.init(), grads, stats)
        out[name] = {
            'grads': numpy_tree(pgrads),
            'comp_ef': full_ef(dk, state),
            'factors': gathered(dk, state),
            'counter': dict(dk.transport_counter),
            'plan': dk._comp_plan,
            'stores': [(side, sb.key, len(sb.layers))
                       for side, store in (('a', dk.a_store), ('g', dk.g_store)) for sb in store],
            'comms': dk.comms_report()['stat_transport'] if rank == 0 else None,
        }
    return out


def case_converge(spec, rank, frac, steps):
    """``steps`` Trainer steps (cadence 2/2, damping 1e-3, SGD(0.1)) at the
    f32 wire and the int8 one (tests/test_compression.py's convergence
    parity): the losses of each."""
    out = {}
    for name, comp in (('f32', None), ('int8', 'int8')):
        net, reg, loss, batch = build(spec, 'mlp')
        dk = DistributedKFAC(config(
            reg, damping=1e-3, lr=0.1, allreduce_method='allreduce_bucketed',
            factor_update_steps=2, inv_update_steps=2, stat_compression=comp,
        ), kaisa_mesh(frac, device='cpu'))
        trainer = Trainer(net, torch.optim.SGD(net.parameters(), lr=0.1),
                          lambda ms, b: (loss(b), ms), kfac=dk, device='cpu')
        state, losses = trainer.init(), []
        for _ in range(steps):
            state, value = trainer.step(state, batch)
            losses.append(float(value))
        out[name] = losses
    return out


def case_comp_checkpoint(spec, rank, frac, root, restore_from=None, model='mlp'):
    """The residuals through a sharded checkpoint: an int8 engine's
    state saved and restored (its residuals bitwise), an f32 engine's
    checkpoint restored into an int8 engine (zero residuals), the int8
    checkpoint into an f32 engine (refused); with ``restore_from``, another
    world's int8 checkpoint restored into this one."""
    _, reg, loss, batch = build(spec, model)
    mesh = kaisa_mesh(frac, device='cpu')
    dk8 = DistributedKFAC(config(reg, stat_compression='int8', **COMP_KW), mesh)
    dk32 = DistributedKFAC(config(reg, **COMP_KW), mesh)
    out = {}
    for name, dk in (('int8', dk8), ('f32', dk32)):
        grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
        state, _ = dk.step(dk.init(), grads, stats)
        checkpoint.save(os.path.join(root, name), state, engine=dk)
        out[f'saved_{name}'] = full_ef(dk, state)
        out[f'factors_{name}'] = gathered(dk, state)
    restored, _ = checkpoint.restore(os.path.join(root, 'int8'), dk8)
    out['round_trip'] = full_ef(dk8, restored)
    restored, _ = checkpoint.restore(os.path.join(root, 'f32'), dk8)
    out['pre_compression'] = full_ef(dk8, restored)
    try:
        checkpoint.restore(os.path.join(root, 'int8'), dk32)
        out['into_f32'] = None
    except ValueError as err:
        out['into_f32'] = str(err)
    if restore_from is not None:
        restored, _ = checkpoint.restore(restore_from, dk8)
        out['cross_world'] = {'comp_ef': full_ef(dk8, restored), 'factors': gathered(dk8, restored)}
    return out


def case_offload(spec, rank, frac, steps=17):
    """``steps`` Trainer steps (cadence 8/8) with offload off and on
    (``OffloadConfig(2, 1)``): each run's losses and parameters, the
    counters and rank 0's ``comms_report()['offload']``; a spilled state's
    refusal by ``durable_state``."""
    out = {}
    for name, off in (('off', None), ('on', OffloadConfig(min_cold_steps=2, prefetch_lead=1))):
        net, reg, loss, batch = build(spec, 'mlp')
        dk = DistributedKFAC(config(
            reg, damping=1e-3, lr=0.1, factor_update_steps=8, inv_update_steps=8, offload=off,
        ), kaisa_mesh(frac, device='cpu'))
        trainer = Trainer(net, torch.optim.SGD(net.parameters(), lr=0.05),
                          lambda ms, b: (loss(b), ms), kfac=dk, device='cpu')
        state, losses, spilled = trainer.init(), [], []
        for _ in range(steps):
            state, value = trainer.step(state, batch)
            losses.append(float(value))
            spilled.append(offload_lib.is_spilled(state.kfac_state))
        out[name] = {
            'losses': losses,
            'params': {n: p.detach().numpy().copy() for n, p in net.named_parameters()},
            'spilled': spilled,
            'comms': dk.comms_report()['offload'],
        }
        if off is not None:
            out[name]['stats'] = dict(dk._offload_manager.stats)
            held = offload_lib.pump(dk, state.kfac_state, step=3)  # f = c = 8: spills
            try:
                checkpoint.durable_state(held)
                out['refused'] = None
            except ValueError as err:
                out['refused'] = str(err)
            out['host_view_spilled'] = offload_lib.is_spilled(dk._offload_manager.host_view(held))
    return out


def case_async(spec, rank, frac, mode, method='eigen', poison_step=None, **kw):
    """``3 * ASYNC_N + 1`` engine steps at fixed weights on the spec's
    per-step batches (the engine's own step, the host mode pumped before
    each), ``mode`` None (synchronous), ``'sliced'`` or ``'host'``; the
    ``POISON`` layer's A statistic NaN at ``poison_step``. Per step: the
    grads, the gathered decompositions and the health counters; for the
    synchronous run also each step's grads preconditioned with the state of
    one window back (``lagged``)."""
    _, reg, loss, _ = build(spec, 'mlp')
    dk = DistributedKFAC(config(reg, compute_method=method, async_inverse=mode, **ASYNC_KW, **kw),
                         kaisa_mesh(frac, device='cpu'))
    state = dk.init()
    rows = []
    back = {}  # the state after the step that opened each window
    for i, b in enumerate(spec['async_batches']):
        grads, stats, _ = local_grads_stats(dk, reg, loss, tensors(b))
        if i == poison_step:
            stats = poisoned(stats)
        state = async_host.pump(dk, state, step=i)
        row = {}
        if mode is None and i >= ASYNC_N:
            lag = back[(i // ASYNC_N - 1) * ASYNC_N]
            row['lagged'] = numpy_tree(dk.precondition(dataclasses.replace(lag, step=i), grads))
        state, pgrads = dk.step(state, grads, stats)
        if i % ASYNC_N == 0:
            back[i] = state
        full = convert.gather_dist_state(state, dk)
        row.update(
            grads=numpy_tree(pgrads),
            decomps={f: full[f] for f in DECOMP_FIELDS},
            health=None if state.health is None else {
                f: getattr(state.health, f).numpy().copy() for f in ('bad_inv', 'quarantined')
            },
        )
        rows.append(row)
    return {'rows': rows, 'slots': {'a': dict(dk._a_slot), 'g': dict(dk._g_slot)},
            'names': list(reg.layers)}


def case_convert_knobs(spec, rank, frac, jax_state, **kw):
    """A JAX state with a shadow and residuals into this rank's shards,
    then one engine step from it: the grads, the whole residuals and the
    shadow's progress."""
    _, reg, loss, batch = build(spec, 'mlp')
    dk = DistributedKFAC(config(reg, **kw), kaisa_mesh(frac, device='cpu'))
    state = convert.from_jax_dist_state(jax_state, dk)
    carried = {'comp_ef': full_ef(dk, state), 'progress': state.shadow.progress}
    grads, stats, _ = local_grads_stats(dk, reg, loss, batch)
    state, pgrads = dk.step(state, grads, stats)
    return {'carried': carried, 'grads': numpy_tree(pgrads), 'comp_ef': full_ef(dk, state),
            'factors': gathered(dk, state)}


CASES = {
    'compressed': case_compressed,
    'converge': case_converge,
    'comp_checkpoint': case_comp_checkpoint,
    'offload': case_offload,
    'async': case_async,
    'convert_knobs': case_convert_knobs,
    'multihost': case_multihost,
    'step': case_step,
    'convert': case_convert,
    'variants': case_variants,
    'unexecuted': case_unexecuted,
    'train': case_train,
    'resnet': case_resnet,
    'observe': case_observe,
    'checkpoint': case_checkpoint,
    'manager': case_manager,
}


def run_cases(rank, world, device, spec):
    """Every case of ``spec['cases']`` (``(id, kind, kwargs)``) in order on
    this rank: ``{id: result}``."""
    del world, device
    return {cid: CASES[kind](spec, rank, **kw) for cid, kind, kw in spec['cases']}
