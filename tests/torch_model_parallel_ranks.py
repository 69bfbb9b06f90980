"""Rank bodies of ``tests/test_torch_model_parallel.py``'s gloo world.

Each rank runs the port alone (no JAX, no JAX package) on one of four
ranks: every training grid first (each creates process groups, so every
rank builds them in one order), then ring and zigzag attention on its
sequence and head shards, the vocab-parallel NLL on its vocab shard, the
captured statistics of a registry-sharded net, and three
``DistributedKFAC`` steps of the LM through ``Trainer.step`` in each
layout. The test holds the results against the JAX package on the global
arrays.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn as nn

from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, attention, lm_loss
from kfac_tpu_torch.ops import losses
from kfac_tpu_torch.parallel import DistributedKFAC, tensor_parallel, train_mesh
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

LM_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=32)
STEP_KW = dict(damping=0.01, lr=0.1)
STEPS = 3
# the DistributedKFAC layouts on four ranks: (a) TP x SP with the ring,
# (b) SP with the zigzag ring, (c) DP x TP at fractions 1 and 0.5
LAYOUTS = {
    'a': dict(frac=1.0, model=2, seq=2),
    'b': dict(frac=1.0, seq=4, zigzag=True),
    'c-1.0': dict(frac=1.0, model=2),
    'c-0.5': dict(frac=0.5, model=2),
}
# attention cases: (grid, causal); the grids' sequence layouts decide ring
# or zigzag
ATTENTION = {
    'ring-seq4': ('ring4', True),
    'ring-model2-seq2': ('a', True),
    'zigzag-seq4': ('b', True),
    'zigzag-model2-seq2': ('zigzag2', True),
    'noncausal-seq4': ('ring4', False),
}
GRIDS = dict(
    LAYOUTS, ring4=dict(seq=4), zigzag2=dict(model=2, seq=2, zigzag=True), tp4=dict(model=4),
)


class GenericNet(nn.Module):
    """The JAX test's net with names unlike the LM's."""

    def __init__(self):
        super().__init__()
        self.expander = nn.Linear(32, 128)
        self.contractor = nn.Linear(128, 32)
        self.classify_out = nn.Linear(32, 10, bias=False)

    def forward(self, x):
        return self.classify_out(self.contractor(torch.relu(self.expander(x))))


def tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree


def case_attention(grid, spec, causal):
    """This rank's output and input grads of ring (or zigzag) attention on
    its sequence positions and, with a model axis, its heads."""
    q, k, v, dout = (torch.from_numpy(spec['qkv'][n]) for n in ('q', 'k', 'v', 'dout'))
    heads = q.shape[2]
    pos = grid.seq_positions(q.shape[1])
    per = heads // grid.model
    hs = slice(grid.m * per, (grid.m + 1) * per)

    def local(x):
        return x[:, pos][:, :, hs].contiguous()

    ql, kl, vl = (local(x).requires_grad_() for x in (q, k, v))
    attn = attention.make_context_parallel_attention(grid, 'seq', causal, zigzag=grid.zigzag)
    out = attn(ql, kl, vl)
    (out * local(dout)).sum().backward()
    return dict(
        positions=pos.numpy(), heads=(hs.start, hs.stop), out=numpy_tree(out),
        dq=numpy_tree(ql.grad), dk=numpy_tree(kl.grad), dv=numpy_tree(vl.grad),
    )


def case_vocab_loss(grid, spec):
    """The mean vocab-parallel NLL of this rank's vocab shard of the logits
    and its gradient."""
    logits, targets = torch.from_numpy(spec['logits']), torch.from_numpy(spec['targets'])
    per = logits.shape[-1] // grid.model
    local = logits[:, grid.m * per:(grid.m + 1) * per].clone().requires_grad_()
    loss = losses.vocab_parallel_nll(local, targets, grid.model_group, grid.m * per).mean()
    loss.backward()
    return dict(loss=float(loss), grad=numpy_tree(local.grad), vocab=(grid.m * per, (grid.m + 1) * per))


def case_capture(grid, spec):
    """The generic net sharded by its registry's derived kinds over the
    model axis: the captured statistics (every rank's, the global batch's
    at dp 1) and the loss."""
    model = GenericNet()
    model.load_state_dict(tensors(spec['generic']['weights']))
    tensor_parallel.shard_params_from_registry(
        model, grid, registry.register_model(model, device='cpu'), warn_unmatched=False
    )
    reg = registry.register_model(model, device='cpu')
    x, y = (torch.from_numpy(a) for a in spec['generic']['batch'])

    def loss_fn(batch):
        xb, yb = batch
        return -torch.mean(torch.sum(torch.log_softmax(model(xb), -1) * yb, -1))

    (loss, _), _, stats = capture.CurvatureCapture(reg).value_stats_and_grad(loss_fn)((x, y))
    kinds = {n: tensor_parallel.layer_kind(m) for n, m in reg.modules.items()}
    return dict(loss=float(loss), a=numpy_tree(stats.a), g=numpy_tree(stats.g), kinds=kinds)


def case_steps(grid, spec):
    """``STEPS`` steps of the LM through ``Trainer.step`` with a
    ``DistributedKFAC`` on ``grid``, the global batch, weights from flax:
    the losses, the last step's preconditioned grads gathered whole, the
    factor stacks, this rank's parameters and the engine's topology."""
    ring = {} if grid.seq == 1 else dict(ring_mesh=grid, ring_axis='seq')
    model = TransformerLM(**LM_CFG, device='cpu', **ring)
    tensor_parallel.shard_params(model, grid, params=tensors(spec['lm']['weights']))
    reg = registry.register_model(model, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        dk = DistributedKFAC(KFACPreconditioner(reg, device='cpu', **STEP_KW), grid)
    loss = lm_loss(model)
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1), lambda ms, b: (loss(b), ms),
        kfac=dk, device='cpu',
    )
    batch = tuple(torch.from_numpy(np.array(b)).long() for b in spec['lm']['batch'])
    state = trainer.init()
    values = []
    for _ in range(STEPS):
        state, value = trainer.step(state, batch)
        values.append(float(value))
    grads = {n: p.grad for n, p in model.named_parameters()}
    full = tensor_parallel.gather_params(model, grads)
    dist_state = convert.gather_dist_state(state.kfac_state, dk)
    return dict(
        losses=values, grads=numpy_tree(full),
        state={f: dist_state[f] for f in ('a', 'g')},
        params=numpy_tree(dict(model.state_dict())),
        sharded=sorted(tensor_parallel.sharded_param_names(model)),
        topology=dk.topology(), total_devices=dk.total_devices, world=dk.world,
        strategy=dk.strategy.name,
    )


def run_cases(rank, world, device, spec):
    grids = {
        name: train_mesh(
            kw.get('frac', 1.0), kw.get('model', 1), kw.get('seq', 1), device='cpu',
            zigzag=kw.get('zigzag', False),
        )
        for name, kw in GRIDS.items()
    }
    try:
        train_mesh(model=3, device='cpu')
        bad = None
    except ValueError as exc:
        bad = str(exc)
    return dict(
        coords={n: (g.row, g.col, g.m, g.s) for n, g in grids.items()},
        model3_error=bad,
        attention={
            name: case_attention(grids[g], spec, causal) for name, (g, causal) in ATTENTION.items()
        },
        loss=case_vocab_loss(grids['tp4'], spec),
        capture=case_capture(grids['tp4'], spec),
        steps={name: case_steps(grids[name], spec) for name in LAYOUTS},
    )
