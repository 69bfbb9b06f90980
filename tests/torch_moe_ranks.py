"""Rank bodies of ``tests/test_torch_moe.py``'s gloo world.

Each rank runs the port alone (no JAX, no JAX package): the switch-MoE LM
with routed experts on its own row block of the global batch, through
``DistributedKFAC``; the test holds the results against the JAX engine on
the whole batch.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
from kfac_tpu_torch.preconditioner import KFACPreconditioner

MOE_CFG = dict(
    vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=16,
    num_experts=4, moe_every=2,
)
ROUTED = [r'.*expert\d+_(up|down)']
STEP_KW = dict(damping=0.01, kl_clip=0.001, lr=0.1)


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree


def case_moe_step(rank, spec, frac, steps, **kw):
    """``steps`` engine steps from ``init`` on one batch, each from this
    rank's statistics: the gathered factors, the preconditioned grads and
    this rank's live fractions."""
    model = TransformerLM(**MOE_CFG, device='cpu')
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in spec['weights'].items()})
    reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        dk = DistributedKFAC(KFACPreconditioner(reg, device='cpu', **STEP_KW, **kw),
                             kaisa_mesh(frac, device='cpu'))
    batch = tuple(torch.from_numpy(np.array(b)).long() for b in spec['batch'])
    # no load-balance term: it is a product of batch means, so a mean of
    # the ranks' local terms is not the global batch's
    run = capture.CurvatureCapture(reg).value_stats_and_grad(lm_loss(model))
    (value, _), grads, stats = run(dk.mesh.local_rows(batch))
    grads, value = dk.average_grads(grads, value)
    state = dk.init()
    for _ in range(steps):
        state, pgrads = dk.step(state, grads, stats)
    return {
        'loss': float(value),
        'w': numpy_tree(stats.w),
        'state': convert.gather_dist_state(state, dk),
        'grads': numpy_tree(pgrads),
    }


def case_moe_convert(rank, spec, frac, jax_state, **kw):
    """A JAX state of the MoE LM into this rank's shards and back."""
    model = TransformerLM(**MOE_CFG, device='cpu')
    reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        dk = DistributedKFAC(KFACPreconditioner(reg, device='cpu', **STEP_KW, **kw),
                             kaisa_mesh(frac, device='cpu'))
    return {'roundtrip': convert.gather_dist_state(convert.from_jax_dist_state(jax_state, dk), dk)}


def run_cases(rank, world, device, spec):
    cases = {'step': case_moe_step, 'convert': case_moe_convert}
    return {name: cases[kind](rank, spec, **kw) for name, kind, kw in spec['cases']}
