"""Rank bodies of ``tests/test_torch_interleaved.py``'s gloo world.

Each rank runs the port alone (no JAX, no JAX package) on one of four
ranks: every grid first (each creates process groups, so every rank builds
them in one order), then the cases on their grids, with the weights and
batches the test made with the JAX package (numpy). The tests hold the
results against the JAX package on the global arrays.
"""

from __future__ import annotations

import os
import time
import warnings

import torch
import torch.distributed as dist

from kfac_tpu_torch import checkpoint, convert
from kfac_tpu_torch.parallel import interleaved_scan, pipeline
from kfac_tpu_torch.parallel.mesh import pipeline_mesh
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# tests/parallel/test_interleaved_scan.py's sizes
GEOM = dict(vocab_size=64, d_model=32, num_heads=4, max_len=16)
KFAC = dict(damping=0.01, lr=0.1)
# the world's pipeline grids: (pipe ranks, ranks); every rank builds every
# grid, in this order
GRIDS = {
    'p1': (1, [0]),
    'p2': (2, [0, 1]),
    'p2_dp2': (2, [0, 1, 2, 3]),
    'p4': (4, [0, 1, 2, 3]),
}


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree


def model_of(grid, case):
    """The case's interleaved model (or, with ``base``, the 1F1B
    ``PipelinedLM`` over the same logical stages) with the JAX weights."""
    kw = dict(GEOM, num_layers=case['layers'], n_microbatches=case['micro'])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        if case.get('base'):
            params = convert.from_flax_pipeline_params(case['params'], grid.stage)
            return pipeline.PipelinedLM(grid, schedule='1f1b', params=params, **kw)
        v = case['v']
        params = convert.from_flax_interleaved_params(case['params'], grid.stage, grid.n_stages, v)
        return interleaved_scan.InterleavedPipelinedLM(grid, virtual_chunks=v, params=params, **kw)


def batch_of(case):
    tokens = torch.from_numpy(case['tokens']).long()
    return tokens, torch.roll(tokens, -1, dims=1)


def stats_case(grid, case):
    """One pass of the schedule: loss, grads, statistics, the executed tick
    counts of every pipe rank and the table's report."""
    model = model_of(grid, case)
    if case.get('base'):
        loss, grads, stats = model.loss_and_stats(batch_of(case))
        ticks = report = None
    else:
        loss, grads, stats, ticks = model.loss_stats_and_ticks(batch_of(case))
        report = model.tick_report(ticks)
    return dict(loss=float(loss), grads=numpy_tree(grads), a=numpy_tree(stats.a),
                g=numpy_tree(stats.g), ticks=ticks, report=report,
                names=list(model.stage_registry.layers))


def engine_of(model, case):
    cfg = KFACPreconditioner(model.stage_registry, device='cpu', **KFAC, **case.get('kfac', {}))
    return pipeline.PipelineKFAC(cfg, model)


def sgd_step(model, engine, state, batch):
    loss, grads, stats = model.loss_and_stats(batch)
    state, pg = engine.step(state, grads, stats)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p -= 0.1 * pg[n]
    return state, float(loss), pg


def train_case(grid, case):
    """``steps`` steps of PipelineKFAC and SGD at 0.1 (the JAX test's
    loop): the losses, the last step's preconditioned grads and factors."""
    model = model_of(grid, case)
    engine = engine_of(model, case)
    state = engine.init()
    batch = batch_of(case)
    losses = []
    for _ in range(case['steps']):
        state, loss, pg = sgd_step(model, engine, state, batch)
        losses.append(loss)
    return dict(losses=losses, pgrads=numpy_tree(pg), a=numpy_tree(state.a),
                g=numpy_tree(state.g), topology=engine.topology())


def checkpoint_case(grid, case):
    """Three steps, a sharded save, a restore into a fresh engine and a step
    on each; restoring into the layout of another chunk count is refused."""
    path = os.path.join(case['root'], 'ilv')
    model = model_of(grid, case)
    engine = engine_of(model, case)
    state = engine.init()
    batch = batch_of(case)
    for _ in range(3):
        state, _, _ = sgd_step(model, engine, state, batch)
    checkpoint.save(path, state, extra={'params': model.state_dict()}, engine=engine)
    restored, extra = checkpoint.restore(path, engine, extra_template={'params': None})
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    _, l1, _ = sgd_step(model, engine, state, batch)
    model.load_state_dict(extra['params'])
    _, l2, _ = sgd_step(model, engine, restored, batch)
    other = dict(case, v=1, layers=case['layers'] // 2)
    refusal = None
    try:
        checkpoint.restore(path, engine_of(model_of(grid, other), case))
    except ValueError as exc:
        refusal = str(exc)
    key = next(iter(state.a))
    return dict(losses=(l1, l2), step=(state.step, restored.step), refusal=refusal,
                a_equal=bool(torch.equal(state.a[key], restored.a[key])),
                params_saved_equal=all(torch.equal(saved[k], extra['params'][k]) for k in saved))


def convert_case(grid, case):
    """The JAX run's params and PipelineKFAC state after its step 3, taken
    over (``convert``), then one step: the loss and the factors."""
    model = model_of(grid, case)
    engine = engine_of(model, case)
    state = convert.from_jax_pipeline_state(case['jax_state'], engine)
    state, loss, _ = sgd_step(model, engine, state, batch_of(case))
    return dict(loss=loss, a=numpy_tree(state.a), step=state.step)


KINDS = {'stats': stats_case, 'train': train_case, 'checkpoint': checkpoint_case,
         'convert': convert_case}


def run(rank: int, world: int, device: torch.device, spec: dict) -> dict:
    warnings.simplefilter('ignore')
    t0 = time.perf_counter()
    grids = {}
    for name, (n, members) in GRIDS.items():
        group = None if len(members) == world else dist.new_group(members)
        grids[name] = pipeline_mesh(n, group=group, device='cpu')
    out = {'coords': {n: (g.stage, g.data) for n, g in grids.items() if g is not None},
           'grid_seconds': time.perf_counter() - t0, 'seconds': {}}
    for name, case in spec.items():
        grid = grids[case['grid']]
        t0 = time.perf_counter()
        if grid is not None:  # the grid's ranks run the case, the others wait
            out[name] = KINDS[case['kind']](grid, case)
        out['seconds'][name] = time.perf_counter() - t0
        dist.barrier()
    return out
