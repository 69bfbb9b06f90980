"""Rank bodies of ``tests/test_torch_kaisa.py``'s gloo worlds.

Each rank of a world (``kfac_tpu_torch.parallel.spawn_world``) runs every
case of the spec in order and returns its results, numpy only. This
module imports neither JAX nor the JAX package: the ranks run the port
alone, on the CPU, and the test holds their results against the JAX
engine in the parent process.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP, TransformerLM, lm_loss
from kfac_tpu_torch.ops import factors
from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh, multihost
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

MLP_CFG = dict(in_features=6, features=(16, 12), num_classes=5)
LM_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=16)
# the engine of the one-step cases, as tests/parallel/test_kaisa_distributed.py
STEP_KW = dict(damping=0.01, kl_clip=0.001, lr=0.1)
TRAINER_KW = dict(damping=0.003, lr=0.1, factor_update_steps=1, inv_update_steps=2)


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


def build(spec, name):
    """(model, registry, loss_fn, global batch) of one of the spec's
    models, with the spec's weights."""
    if name == 'lm':
        model = TransformerLM(**LM_CFG, device='cpu')
        reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
        loss = lm_loss(model)
    else:
        model = {'mlp': lambda: MLP(**MLP_CFG, device='cpu'), 'wide': Wide, 'hetero': Hetero}[name]()
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


CASES = {
    'multihost': case_multihost,
    'step': case_step,
    'convert': case_convert,
    'variants': case_variants,
    'unexecuted': case_unexecuted,
    'train': case_train,
}


def run_cases(rank, world, device, spec):
    """Every case of ``spec['cases']`` (``(id, kind, kwargs)``) in order on
    this rank: ``{id: result}``."""
    del world, device
    return {cid: CASES[kind](spec, rank, **kw) for cid, kind, kw in spec['cases']}
