"""The port's trainability mask against the JAX package's
(``kfac_tpu.layers.registry.masked_registry``; the dense cases of
``tests/test_mask.py``).

The JAX mask is an optax prefix pytree over flax params (``kernel``,
``bias``); the port's is a nested dict over ``named_modules()`` paths with
the module's parameter names (``weight``, ``bias``) below a layer, and the
same prefix semantics and errors. Both packages run the MLP 6 -> 8 -> 5
(``dense0``, ``head``) from the same weights, one capture-and-refresh step,
kl-clip off: a frozen layer's gradients pass through bit for bit, and the
trainable layer's match the JAX engine's within rtol 1e-4, atol 1e-4 x
the max.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
from kfac_tpu.layers import registry as jregistry
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu_torch import convert, health
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP, TransformerLM
from kfac_tpu_torch.observability import metrics
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

IN, HIDDEN, OUT = 6, 8, 5


def data():
    r = np.random.default_rng(1)
    x = r.standard_normal((32, IN)).astype(np.float32)
    return x, np.tanh(x @ r.standard_normal((IN, OUT))).astype(np.float32)


def setup():
    """(flax model, its params, JAX registry, port model, port registry)."""
    x, _ = data()
    fmodel = FlaxMLP(features=(HIDDEN,), num_classes=OUT)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    model = MLP(IN, (HIDDEN,), OUT, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    return (fmodel, params, kfac_tpu.register_model(fmodel, jnp.asarray(x)), model,
            registry.register_model(model, device='cpu'))


def torch_pgrads(model, reg, **kw):
    x, y = data()
    kfac = KFACPreconditioner(reg, device='cpu', kl_clip=None, **kw)
    run = capture.CurvatureCapture(kfac.registry).value_stats_and_grad(
        lambda b: torch.mean((model(b[0]) - b[1]) ** 2)
    )
    _, grads, stats = run((torch.from_numpy(x), torch.from_numpy(y)))
    state, pgrads = kfac.step(kfac.init(), grads, stats)
    return kfac, state, grads, pgrads


def jax_pgrads(fmodel, params, reg, **kw):
    x, y = data()
    kfac = kfac_tpu.KFACPreconditioner(registry=reg, kl_clip=None, **kw)

    def loss(p, b):
        return jnp.mean((fmodel.apply({'params': p}, b[0]) - b[1]) ** 2)

    _, grads, stats = kfac_tpu.CurvatureCapture(kfac.registry).value_stats_and_grad(loss)(
        params, (jnp.asarray(x), jnp.asarray(y))
    )
    _, pgrads = kfac.step(kfac.init(), grads, stats)
    return convert.from_flax_params(jax.device_get(pgrads))


def test_mask_none_is_identity():
    _, _, _, model, reg = setup()
    assert registry.masked_registry(reg, None) is reg
    kfac = KFACPreconditioner(reg, device='cpu', mask=None)
    assert kfac.registry is reg
    _, _, _, base = torch_pgrads(model, reg)
    _, _, _, masked = torch_pgrads(model, reg, mask=None)
    assert all(torch.equal(base[n], masked[n]) for n in base)


def test_frozen_layer_dropped_everywhere_as_jax():
    fmodel, params, jreg, model, reg = setup()
    kfac, state, grads, pgrads = torch_pgrads(
        model, reg, mask={'head': False}, health=health.HealthConfig(warn=False), metrics=True,
    )
    assert list(kfac.registry.layers) == list(kfac.registry.modules) == ['dense0']
    assert 'head' not in state.a and 'head' not in state.qa
    assert state.health.names == ('dense0',) and state.metrics.names == ('dense0',)
    assert all('head' not in k for k in metrics.metric_keys(kfac.metrics, ['dense0']))
    for n in ('head.weight', 'head.bias'):
        assert torch.equal(pgrads[n], grads[n])  # passes through bit for bit
    assert float((pgrads['dense0.weight'] - grads['dense0.weight']).abs().max()) > 0
    want = jax_pgrads(fmodel, params, jreg, mask={'head': False})
    scale = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(pgrads[n].numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=n)


def test_mask_matches_skip_layers_exactly():
    _, _, _, model, reg = setup()
    _, _, _, via_mask = torch_pgrads(model, reg, mask={'head': False})
    _, _, _, via_skip = torch_pgrads(
        model, registry.register_model(model, skip_layers=['head'], device='cpu')
    )
    assert all(torch.equal(via_mask[n], via_skip[n]) for n in via_mask)


def test_register_model_mask_kwarg_equals_masked_registry():
    _, _, _, model, reg = setup()
    direct = registry.register_model(model, device='cpu', mask={'dense0': False})
    wrapped = registry.masked_registry(reg, {'dense0': False})
    assert list(direct.layers) == list(wrapped.layers) == ['head']
    assert direct.param_paths == wrapped.param_paths == {'head': 'head'}


@pytest.mark.parametrize('tmask,jmask,kept', [
    ({'dense0': False}, {'dense0': False}, ['head']),
    ({'dense0': {'weight': False, 'bias': False}}, {'dense0': {'kernel': False, 'bias': False}},
     ['head']),
    ({'dense0': {'weight': True}}, {'dense0': {'kernel': True}}, ['dense0', 'head']),
    ({'other': False}, {'other': False}, ['dense0', 'head']),
    (False, False, []),
    (True, True, ['dense0', 'head']),
])
def test_mask_prefix_semantics_match_jax(tmask, jmask, kept):
    _, _, jreg, _, reg = setup()
    assert list(registry.masked_registry(reg, tmask).layers) == kept
    assert sorted(jregistry.masked_registry(jreg, jmask).layers) == kept


def test_mask_over_nested_modules():
    model = TransformerLM(vocab_size=16, d_model=8, num_heads=2, num_layers=2, max_len=4,
                          device='cpu')
    reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
    kept = registry.masked_registry(reg, {'block0': False, 'block1': {'attn': {'q_proj': False}}})
    assert all(not n.startswith('block0/') for n in kept.layers)
    assert 'block1/attn/q_proj' not in kept.layers and 'block1/attn/k_proj' in kept.layers
    assert len(kept.layers) == len(reg.layers) - 7


def test_mask_splitting_a_layer_raises_as_jax():
    _, _, jreg, _, reg = setup()
    with pytest.raises(ValueError, match='splits layer') as ours:
        registry.masked_registry(reg, {'dense0': {'weight': False, 'bias': True}})
    with pytest.raises(ValueError) as theirs:
        jregistry.masked_registry(jreg, {'dense0': {'kernel': False, 'bias': True}})
    # LoRA units are ported: the message is the JAX package's, verbatim
    assert str(ours.value) == str(theirs.value)


def test_mask_bad_node_type_raises_as_jax():
    _, _, jreg, _, reg = setup()
    with pytest.raises(TypeError, match='expected a bool or a mapping') as ours:
        registry.masked_registry(reg, 0.5)
    with pytest.raises(TypeError) as theirs:
        jregistry.masked_registry(jreg, 0.5)
    assert str(ours.value).split(';')[0] == str(theirs.value).split(';')[0]
