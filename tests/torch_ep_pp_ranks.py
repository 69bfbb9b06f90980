"""Rank bodies of ``tests/test_torch_expert_parallel.py`` and
``tests/test_torch_pipeline.py``'s gloo worlds.

Each rank runs the port alone (no JAX, no JAX package) on one of four
ranks: every grid first (each creates process groups, so every rank builds
them in one order), then the cases on the grids, with the weights and
batches the test made with the JAX package (numpy). The tests hold the
results against the JAX package on the global arrays.
"""

from __future__ import annotations

import copy
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from kfac_tpu_torch import checkpoint, convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.models import moe as moe_lib
from kfac_tpu_torch.parallel import DistributedKFAC, expert_parallel, pipeline, tensor_parallel
from kfac_tpu_torch.parallel.mesh import pipeline_mesh, train_mesh
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# tests/parallel/test_expert_parallel.py's sizes
E, D, B, S, RATIO = 4, 8, 8, 4, 2
ROUTED = [r'.*expert\d+_(up|down)']
EP_GRIDS = {
    'ep2': dict(expert=2),            # data 2 x expert 2
    'ep4': dict(expert=4),            # expert 4
    'tp_ep': dict(model=2, expert=2),  # model 2 x expert 2
    'tp': dict(model=2),              # data 2 x model 2
}
MOE_LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=16, num_experts=4,
              moe_every=2)
EP_TRAIN = dict(damping=0.01, lr=0.1, factor_update_steps=1, inv_update_steps=2)
EP_TRAIN_STEPS = 20
EP_LM_KW = dict(damping=0.01, lr=0.1, kl_clip=0.001)


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return tree


def stats_np(stats):
    return {'a': numpy_tree(stats.a), 'g': numpy_tree(stats.g), 'w': numpy_tree(stats.w)}


def quiet():
    warnings.simplefilter('ignore')


# --------------------------------------------------------------- expert parallel


def ep_block(grid, spec, cf, prefix=''):
    ffn = expert_parallel.EPSwitchFFN(grid, D, E, RATIO, capacity_factor=cf, name_prefix=prefix)
    full = convert.from_flax_params(spec['moe_params'])
    ffn.load_state_dict(convert.local_params(full, ffn))
    return ffn


def mse_loss(batch, ffns):
    x, t = batch
    return torch.mean((ffns[0](x) - t) ** 2)


def ep_capture(grid, spec, cf):
    ffn = ep_block(grid, spec, cf)
    x, t = grid.local_tokens((torch.from_numpy(spec['x']), torch.from_numpy(spec['target'])))
    with torch.no_grad():
        y = ffn(x)
    run = expert_parallel.combined_value_stats_and_grad(mse_loss, ep_ffns=(ffn,))
    (loss, _), grads, stats = run((x, t))
    return dict(y=y.numpy(), loss=float(loss), grads=numpy_tree(grads), stats=stats_np(stats),
                experts=list(ffn.local_experts))


def ep_train(grid, spec):
    """The JAX test's loop: EP capture, the engine over the block's
    registry, SGD at 0.2 on the preconditioned grads, 20 steps; and the
    kl-clip sum of step 0 beside the dense engine's on the dense masked
    block of the same weights and global batch."""
    ffn = ep_block(grid, spec, float(E))
    x, t = grid.local_tokens((torch.from_numpy(spec['x']), torch.from_numpy(spec['train_target'])))
    reg = ffn.registry()
    engine = expert_parallel.ExpertParallelKFAC(
        KFACPreconditioner(reg, device='cpu', **EP_TRAIN), grid, [ffn])
    seen = []
    reduce = engine.vg_reduce
    engine.vg_reduce = lambda terms, vg: seen.append(reduce(terms, vg)) or seen[-1]
    run = expert_parallel.combined_value_stats_and_grad(mse_loss, ep_ffns=(ffn,))
    state = engine.init()
    losses = []
    for _ in range(EP_TRAIN_STEPS):
        (loss, _), grads, stats = run((x, t))
        state, pg = engine.step(state, grads, stats)
        with torch.no_grad():
            for n, p in ffn.named_parameters():
                p -= 0.2 * pg[n]
        losses.append(float(loss))
    # the dense engine's kl-clip sum on the dense masked block, step 0
    dense = moe_lib.MoEMLP(D, E, RATIO)
    dense.load_state_dict(convert.from_flax_params(spec['moe_params']))
    dreg = registry.register_model(dense, device='cpu', routed_layers=ROUTED)
    dk = KFACPreconditioner(dreg, device='cpu', **EP_TRAIN)
    dseen = []
    dstate = dk.init()
    xg, tg = torch.from_numpy(spec['x']), torch.from_numpy(spec['train_target'])
    (_, _), dgrads, dstats = capture.CurvatureCapture(dreg).value_stats_and_grad(
        lambda b: torch.mean((dense(b[0]) - b[1]) ** 2))((xg, tg))
    dk.step(dstate, dgrads, dstats, vg_reduce=lambda terms, vg: dseen.append(vg) or vg)
    return dict(losses=losses, vg_step0=float(seen[0]), dense_vg_step0=float(dseen[0]))


def ep_combined(grid, spec):
    """A dense projection (hook capture) and two EP blocks in one backward:
    one module tree holds them (``proj``, ``moe0``, ``moe1``), so the
    registry merges as the JAX test's does."""
    full = convert.from_flax_params(spec['combined_params'])
    holder = nn.ModuleDict({'proj': nn.Linear(D, D)})
    for blk in ('moe0', 'moe1'):
        holder[blk] = expert_parallel.EPSwitchFFN(
            grid, D, E, RATIO, capacity_factor=float(E), name_prefix=f'{blk}/')
    holder.load_state_dict(convert.local_params(full, holder))
    ffns = [holder['moe0'], holder['moe1']]
    preg = registry.register_model(holder, device='cpu')
    merged = expert_parallel.register_model(holder, device='cpu')

    def loss_fn(batch, fs):
        x, t = batch
        return torch.mean((fs[1](fs[0](holder['proj'](x))) - t) ** 2)

    x, t = grid.local_tokens((torch.from_numpy(spec['x']), torch.from_numpy(spec['train_target'])))
    run = expert_parallel.combined_value_stats_and_grad(loss_fn, registry=preg, ep_ffns=ffns)
    (loss, _), grads, stats = run((x, t))
    return dict(loss=float(loss), grads=numpy_tree(grads), stats=stats_np(stats),
                merged=sorted(merged.layers), hooked=sorted(preg.layers))


def ep_errors(grid, spec):
    """The runner's refusals: a block called twice, a block never called,
    duplicate prefixes."""
    out = {}
    ffn = ep_block(grid, spec, float(E))
    x = grid.local_tokens(torch.from_numpy(spec['x']))

    def twice(b, fs):
        return torch.mean(fs[0](fs[0](b)) ** 2)

    for name, fn, ffns in (
        ('double', twice, (ffn,)),
        ('uninvoked', lambda b, fs: torch.mean(fs[0](b) ** 2),
         (ep_block(grid, spec, float(E), 'a/'), ep_block(grid, spec, float(E), 'b/'))),
    ):
        try:
            expert_parallel.combined_value_stats_and_grad(fn, ep_ffns=ffns)(x)
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def ep_lm_kw(grid):
    return dict(**MOE_LM, device='cpu', ep_mesh=grid)


def routed_tp(grid, spec):
    """The MoE LM with its experts sharded by ``expert_tp_overrides``, routed
    capture, one ``DistributedKFAC`` step (dp 2 x model 2): the loss, the
    gathered preconditioned grads and the experts' statistics."""
    model = TransformerLM(**MOE_LM, device='cpu')
    full = {k: torch.from_numpy(np.array(v)) for k, v in spec['lm_params'].items()}
    base = registry.register_model(model, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    tensor_parallel.shard_params_from_registry(
        model, grid, base, overrides=moe_lib.expert_tp_overrides(), warn_unmatched=False,
        params=full,
    )
    reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    engine = DistributedKFAC(KFACPreconditioner(reg, device='cpu', **EP_LM_KW), grid)
    tokens, targets = (torch.from_numpy(spec['tokens']), torch.from_numpy(spec['targets']))
    run = capture.CurvatureCapture(reg).value_stats_and_grad(lm_loss(model))
    (loss, _), grads, stats = run(grid.local_tokens((tokens, targets)))
    grads, loss = engine.average_grads(grads, loss)
    state, pg = engine.step(engine.init(), grads, stats)
    gathered = tensor_parallel.gather_params(model, pg)
    kinds = {n: tensor_parallel.layer_kind(m) for n, m in reg.modules.items()}
    return dict(loss=float(loss), pgrads=numpy_tree(gathered), kinds=kinds,
                w=numpy_tree(stats.w), wg=numpy_tree(stats.wg))


def ep_lm(grid, spec, steps=2):
    """The MoE LM with its MoE block expert-parallel (on a model 2 x
    expert 2 grid: the other layers tensor-parallel), two steps of
    ``ExpertParallelKFAC``: losses, the preconditioned grads of each step
    (experts local, shards gathered) and the replicated digest."""
    model = TransformerLM(**ep_lm_kw(grid))
    full = {k: torch.from_numpy(np.array(v)) for k, v in spec['lm_params'].items()}
    model.load_state_dict(convert.local_params(full, model))
    if grid.model > 1:
        tensor_parallel.shard_params(model, grid)
    reg = expert_parallel.register_model(model, skip_layers=['lm_head'], device='cpu')
    hook_reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
    ffns = [f for _, f in expert_parallel.ep_blocks(model)]
    engine = expert_parallel.ExpertParallelKFAC(
        KFACPreconditioner(reg, device='cpu', **EP_LM_KW), grid, ffns)
    loss_fn = lm_loss(model)
    run = expert_parallel.combined_value_stats_and_grad(
        lambda b, fs: loss_fn(b), registry=hook_reg, ep_ffns=ffns, model=model)
    batch = grid.local_tokens((torch.from_numpy(spec['tokens']), torch.from_numpy(spec['targets'])))
    state = engine.init()
    losses, pgrads = [], []
    for _ in range(steps):
        (loss, _), grads, stats = run(batch)
        state, pg = engine.step(state, grads, stats)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.1 * pg[n]
        losses.append(float(loss))
        pgrads.append(numpy_tree(tensor_parallel.gather_params(model, pg)))
    sharded = tensor_parallel.sharded_param_names(model)
    experts = {n for p, f in expert_parallel.ep_blocks(model) for n in f.expert_param_names(p)}
    replicated = {n: p.detach().numpy().copy() for n, p in model.named_parameters()
                  if n not in sharded and n not in experts}
    return dict(losses=losses, pgrads=pgrads, replicated=replicated,
                experts=sorted(experts))


def run_ep(rank: int, world: int, device: torch.device, spec: dict) -> dict:
    quiet()
    grids = {name: train_mesh(**kw, device='cpu') for name, kw in EP_GRIDS.items()}
    out = {'coords': {
        name: dict(coords=(g.row, g.col, g.m, g.s, g.e), rows=g.token_rows)
        for name, g in grids.items()
    }}
    out['forward_drops'] = ep_capture(grids['ep2'], spec, 0.25)['y']
    for name, cf in (('ep2', float(E)), ('ep2_cf0.5', 0.5), ('ep4', float(E)), ('tp_ep', float(E))):
        out[f'capture_{name}'] = ep_capture(grids[name.split('_cf')[0]], spec, cf)
    out['train'] = ep_train(grids['ep2'], spec)
    out['combined'] = ep_combined(grids['ep2'], spec)
    out['errors'] = ep_errors(grids['ep2'], spec)
    out['routed_tp'] = routed_tp(grids['tp'], spec)
    out['ep_lm'] = ep_lm(grids['tp_ep'], spec)
    out['ep_lm_ep4'] = ep_lm(grids['ep4'], spec)
    return out


# --------------------------------------------------------------------- pipeline

# tests/parallel/conftest.py's TICK_GEOM and tests/parallel/test_pipeline.py's LM
PP_LM = dict(vocab_size=64, d_model=32, num_heads=4, max_len=16)
PP_KFAC = dict(damping=0.01, lr=0.1)
# the world's pipeline grids: (n_stages, model, ranks); every rank builds
# every grid, in this order
PP_GRIDS = {
    'p1': (1, 1, [0]),
    'p2': (2, 1, [0, 1]),
    'p4': (4, 1, [0, 1, 2, 3]),
    'p1_dp4': (1, 1, [0, 1, 2, 3]),
    'p2_dp2': (2, 1, [0, 1, 2, 3]),
    'p2_tp2': (2, 2, [0, 1, 2, 3]),
}


class MLPStage(nn.Module):
    """tests/parallel/test_pipeline.py's non-transformer stage: a residual
    MLP over the features."""

    def __init__(self, d=32, width=48):
        super().__init__()
        self.up = nn.Linear(d, width)
        self.down = nn.Linear(width, d)

    def forward(self, x):
        return x + self.down(torch.relu(self.up(x)))


class SquarePair(nn.Module):
    """tests/parallel/test_pipeline.py's square-layer stage."""

    def __init__(self, d=32):
        super().__init__()
        self.first = nn.Linear(d, d)
        self.second = nn.Linear(d, d)

    def forward(self, x):
        return x + self.second(torch.relu(self.first(x)))


STAGES = {'mlp': MLPStage, 'square': SquarePair}


def pp_model(grid, case, **kw):
    """The case's ``PipelinedLM`` with the JAX weights of its stage."""
    args = dict(PP_LM, num_layers=case.get('layers', 2), n_microbatches=case.get('micro', 4))
    args.update(kw)
    if 'stage' in case:
        args['stage_module'] = STAGES[case['stage']]
    for key in ('schedule', 'remat'):
        if key in case:
            args[key] = case[key]
    params = convert.from_flax_pipeline_params(case['params'], grid.stage)
    return pipeline.PipelinedLM(grid, params=params, **args)


def pp_batch(case):
    tokens = torch.from_numpy(case['tokens']).long()
    return tokens, torch.roll(tokens, -1, dims=1)


def pp_train(grid, case, steps, kfac=None, save=None):
    """``steps`` steps of PipelineKFAC and SGD at 0.1: losses, the last
    step's preconditioned grads and this rank's digest of its stage."""
    quiet()
    model = pp_model(grid, case)
    engine = pipeline.PipelineKFAC(
        KFACPreconditioner(model.stage_registry, device='cpu', **PP_KFAC, **(kfac or {})), model)
    vgs = []
    reduce = engine._vg_reduce
    engine._vg_reduce = lambda terms, vg: vgs.append(reduce(terms, vg)) or vgs[-1]
    state = engine.init()
    batch = pp_batch(case)
    losses = []
    for i in range(steps):
        loss, grads, stats = model.loss_and_stats(batch)
        state, pg = engine.step(state, grads, stats)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.1 * pg[n]
        losses.append(float(loss))
        if save is not None and i == save['at']:
            save['fn'](model, engine, state, losses)
    return dict(losses=losses, vg=[float(v) for v in vgs],
                stage_a=numpy_tree(state.a), n_layers=len(model.stage_registry.layers))


def pp_stats(grid, case):
    quiet()
    model = pp_model(grid, case)
    loss, grads, stats = model.loss_and_stats(pp_batch(case))
    return dict(loss=float(loss), grads=numpy_tree(grads), stats=stats_np(stats),
                names=list(model.stage_registry.layers),
                shapes={n: h.a_factor_shape for n, h in model.stage_registry.layers.items()})


def pp_forward(grid, case):
    quiet()
    model = pp_model(grid, case)
    return dict(logits=model.apply(pp_batch(case)[0]).numpy())


def pp_checkpoint(grid, case):
    """3 steps, a sharded save, a restore into a fresh engine and a step on
    each; the restore of a 2-stage checkpoint into another stage count is
    refused."""
    quiet()
    path = os.path.join(case['root'], 'pp')
    model = pp_model(grid, case)
    engine = pipeline.PipelineKFAC(KFACPreconditioner(model.stage_registry, device='cpu', **PP_KFAC), model)
    state = engine.init()
    batch = pp_batch(case)

    def step(state):
        loss, grads, stats = model.loss_and_stats(batch)
        state, pg = engine.step(state, grads, stats)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.1 * pg[n]
        return state, float(loss)

    for _ in range(3):
        state, _ = step(state)
    checkpoint.save(path, state, extra={'params': model.state_dict()}, engine=engine)
    restored, extra = checkpoint.restore(path, engine, extra_template={'params': None})
    params = {k: v.clone() for k, v in model.state_dict().items()}
    _, l1 = step(state)
    after1 = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(extra['params'])
    _, l2 = step(restored)
    after2 = model.state_dict()
    key = next(iter(state.a))
    refusals = []
    other = copy.copy(engine)
    other.n_stages = 1  # another stage count
    dense = KFACPreconditioner(model.stage_registry, device='cpu', **PP_KFAC)
    for eng in (other, dense):
        try:
            checkpoint.restore(path, eng)
            refusals.append(None)
        except ValueError as exc:
            refusals.append(str(exc))
    return dict(refusals=refusals,
        step=(state.step, restored.step), a_equal=bool(torch.equal(state.a[key], restored.a[key])),
        decomp_nonzero=float(restored.qa[key].abs().max()), losses=(l1, l2),
        params_saved_equal=all(torch.equal(params[k], extra['params'][k]) for k in params),
        params_after=max(float((after1[k] - after2[k]).abs().max()) for k in after1),
    )


def run_pp(rank: int, world: int, device: torch.device, spec: dict) -> dict:
    quiet()
    t0 = time.perf_counter()
    grids = {}
    for name, (n, model, members) in PP_GRIDS.items():
        group = None if len(members) == world else dist.new_group(members)
        grids[name] = pipeline_mesh(n, model=model, group=group, device='cpu')
    out = {'coords': {n: (g.stage, g.data, g.m) for n, g in grids.items() if g is not None},
           'grid_seconds': time.perf_counter() - t0}
    kinds = {
        'forward': pp_forward, 'stats': pp_stats, 'checkpoint': pp_checkpoint,
        'convert': pp_convert, 'tp_overrides': pp_tp_overrides,
        'train': lambda grid, case: pp_train(grid, case, case['steps'], case.get('kfac')),
    }
    out['seconds'] = {}
    for case_name, case in spec.items():
        grid = grids[case['grid']]
        t0 = time.perf_counter()
        if grid is not None:  # the grid's ranks run the case, the others wait
            out[case_name] = kinds[case['kind']](grid, case)
        out['seconds'][case_name] = time.perf_counter() - t0
        dist.barrier()
    return out


def pp_convert(grid, case):
    """The JAX run's params and PipelineKFAC state after its step 3, taken
    over (``convert``), then one step: the loss and the state's factors."""
    quiet()
    model = pp_model(grid, case)
    engine = pipeline.PipelineKFAC(KFACPreconditioner(model.stage_registry, device='cpu', **PP_KFAC), model)
    state = convert.from_jax_pipeline_state(case['jax_state'], engine)
    loss, grads, stats = model.loss_and_stats(pp_batch(case))
    state, _ = engine.step(state, grads, stats)
    return dict(loss=float(loss), a=numpy_tree(state.a), step=state.step)


def pp_tp_overrides(grid, case):
    """A square-layer stage on a model axis: no override warns and
    replicates; the explicit Megatron pairing shards and trains."""
    import warnings as w

    from kfac_tpu_torch.parallel.tensor_parallel import UnshardedParamWarning

    with w.catch_warnings(record=True) as caught:
        w.simplefilter('always')
        pp_model(grid, case, tp_overrides=())
    warned = any(issubclass(c.category, UnshardedParamWarning) for c in caught)
    with w.catch_warnings(record=True) as caught:
        w.simplefilter('always')
        model = pp_model(grid, case, tp_overrides=(('.*first', 'column'), ('.*second', 'row')))
    warned_explicit = any(issubclass(c.category, UnshardedParamWarning) for c in caught)
    quiet()
    loss, grads, stats = model.loss_and_stats(pp_batch(case))
    return dict(
        warned=warned, warned_explicit=warned_explicit,
        kinds={n: tensor_parallel.layer_kind(m) for n, m in model.stage_registry.modules.items()},
        first=tuple(model.stage.first.weight.shape), second=tuple(model.stage.second.weight.shape),
        head=tensor_parallel.layer_kind(model.lm_head), loss=float(loss), names=sorted(stats.a),
    )
