"""The port's LoRA family against the JAX package: the ``LoRADense`` unit
(``tests/test_lora.py``'s: d_in 6, rank 2, d_out 4), its registration as
one unit with ``Registry.taps``, its block-diagonal factors from the role
hooks, preconditioning in closed form (two-layer K-FAC over the adapters),
the mask's LoRA rule, ``merge_registries``, and 20 steps of the LoRA
fine-tune (``examples/finetune_lora.py``'s backbone, frozen base) beside
the JAX ``Trainer``. Inputs come from numpy seeds; flax weights carry over
with ``convert.from_flax_params``.

Tolerances: forward outputs and factors rtol 1e-5 with atol 1e-6 x
max|reference| (``tests/test_torch_model.py``'s); the closed form rtol 1e-4
with atol 1e-6 (``tests/test_lora.py``'s, f32 against f64); the fine-tune's
losses rtol 1e-5 and its trained parameters rtol 1e-4 with atol 1e-4 x the
largest (``tests/test_torch_preconditioner.py``'s); zero blocks, taps and
the frozen base exactly.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from examples import finetune_lora as jfinetune
from kfac_tpu import training as jtraining
from kfac_tpu.models import LoRADense as JaxLoRADense
from kfac_tpu.ops import cov as jcov
from kfac_tpu_torch import convert, data
from kfac_tpu_torch.examples import finetune_lora
from kfac_tpu_torch.layers import capture, helpers, registry
from kfac_tpu_torch.models import LoRADense
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

D_IN, RANK, D_OUT = 6, 2, 4


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))))


class JaxOneUnit(nn.Module):
    @nn.compact
    def __call__(self, x):
        return JaxLoRADense(features=D_OUT, rank=RANK, name='lora')(x)


class OneUnit(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lora = LoRADense(D_IN, D_OUT, rank=RANK)

    def forward(self, x):
        return self.lora(x)


def unit_pair(up_scale=0.0):
    """The flax unit and the port's with its weights (``up`` at zero, or
    drawn at ``up_scale``), and a batch."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, D_IN)).astype(np.float32)
    y = rng.normal(size=(16, D_OUT)).astype(np.float32)
    jm = JaxOneUnit()
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    if up_scale:
        params['lora']['up']['kernel'] = (
            up_scale * rng.normal(size=(RANK, D_OUT))).astype(np.float32)
    tm = OneUnit()
    tm.load_state_dict(convert.from_flax_params(params))
    return jm, params, tm, (x, y)


def jax_loss(jm):
    return lambda p, b: jnp.mean((jm.apply({'params': p}, b[0]) - b[1]) ** 2)


def torch_loss(tm):
    return lambda b: torch.mean((tm(b[0]) - b[1]) ** 2)


def test_unit_registers_once_with_its_taps():
    jm, params, tm, (x, _) = unit_pair()
    reg = registry.register_model(tm, device='cpu')
    jreg = kfac_tpu.register_model(jm, jnp.asarray(x))
    assert reg.names() == jreg.names() == ['lora']
    h = reg.layers['lora']
    assert isinstance(h, helpers.LoRAHelper)
    assert h.a_factor_shape == jreg.layers['lora'].a_factor_shape == (D_IN + RANK,) * 2
    assert h.g_factor_shape == jreg.layers['lora'].g_factor_shape == (RANK + D_OUT,) * 2
    assert reg.taps == jreg.taps == {'lora/down': ('lora', 'down'), 'lora/up': ('lora', 'up')}
    # up at zero: the unit computes exactly base(x)
    xt = torch.from_numpy(x)
    assert torch.equal(tm(xt), tm.lora.base(xt))
    close(tm(xt), jm.apply({'params': params}, jnp.asarray(x)))
    with pytest.raises(ValueError, match='no bias column'):
        helpers.LoRAHelper(name='u', has_bias=True, in_features=2, rank=1, out_features=2)


@pytest.mark.parametrize('up_scale', [0.0, 0.5], ids=['up-zero', 'up-drawn'])
def test_captured_factors_are_block_diagonal_as_jax(up_scale):
    jm, params, tm, batch = unit_pair(up_scale)
    jreg = kfac_tpu.register_model(jm, jnp.asarray(batch[0]))
    _, _, jstats = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(jax_loss(jm))(
        params, tuple(jnp.asarray(b) for b in batch))
    reg = registry.register_model(tm, device='cpu')
    tbatch = tuple(torch.from_numpy(b) for b in batch)
    _, grads, stats = capture.CurvatureCapture(reg).value_stats_and_grad(torch_loss(tm))(tbatch)
    a, g = stats.a['lora'], stats.g['lora']
    close(a, jstats.a['lora'])
    close(g, jstats.g['lora'])
    # the cross-adapter blocks are exactly zero
    assert not a[:D_IN, D_IN:].any() and not a[D_IN:, :D_IN].any()
    assert not g[:RANK, RANK:].any() and not g[RANK:, :RANK].any()
    # the down block is the plain A of the unit's input
    close(a[:D_IN, :D_IN], jcov.linear_a_factor(batch[0], has_bias=False))
    if not up_scale:
        # up at zero: every down cotangent is zero, and its routed G block
        # stays exactly zero (not 0/N)
        assert not g[:RANK, :RANK].any() and g[RANK:, RANK:].abs().max() > 0
    assert set(grads) == {'lora.base.weight', 'lora.base.bias', 'lora.down.weight', 'lora.up.weight'}


def test_unit_preconditioning_is_two_layer_kfac():
    """Closed form: the block-diagonal solve is the per-adapter solves."""
    rng = np.random.default_rng(0)

    def spd(n):
        m = rng.standard_normal((n, n))
        return m @ m.T + n * np.eye(n)

    a_down, a_up = spd(D_IN), spd(RANK)
    g_down, g_up = spd(RANK), spd(D_OUT)
    w_down = rng.standard_normal((RANK, D_IN)).astype(np.float32)
    w_up = rng.standard_normal((D_OUT, RANK)).astype(np.float32)
    h = helpers.LoRAHelper(name='lora', has_bias=False, in_features=D_IN, rank=RANK,
                           out_features=D_OUT)
    mat = h.grads_to_matrix({'down.weight': torch.from_numpy(w_down),
                             'up.weight': torch.from_numpy(w_up)})
    assert not mat[:RANK, D_IN:].any() and not mat[RANK:, :D_IN].any()
    a = np.zeros((D_IN + RANK,) * 2)
    a[:D_IN, :D_IN], a[D_IN:, D_IN:] = a_down, a_up
    g = np.zeros((RANK + D_OUT,) * 2)
    g[:RANK, :RANK], g[RANK:, RANK:] = g_down, g_up

    def solve(gf, wf, af):
        lam = np.sqrt(0.1)
        return np.linalg.inv(gf + lam * np.eye(len(gf))) @ wf @ np.linalg.inv(af + lam * np.eye(len(af)))

    out = h.matrix_to_grads(torch.from_numpy(solve(g, mat.numpy().astype(np.float64), a)).float())
    np.testing.assert_allclose(out['down.weight'].numpy(), solve(g_down, w_down, a_down),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out['up.weight'].numpy(), solve(g_up, w_up, a_up),
                               rtol=1e-4, atol=1e-6)


def test_engine_preconditions_the_unit_as_jax():
    """One dense-engine step on the unit (EIGEN), against the JAX engine."""
    jm, params, tm, batch = unit_pair(0.5)
    jreg = kfac_tpu.register_model(jm, jnp.asarray(batch[0]))
    kw = dict(damping=0.01, lr=0.1, factor_update_steps=1, inv_update_steps=1)
    jkfac = kfac_tpu.KFACPreconditioner(registry=jreg, **kw)
    _, jgrads, jstats = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(jax_loss(jm))(
        params, tuple(jnp.asarray(b) for b in batch))
    _, jpg = jkfac.step(jkfac.init(), jgrads, jstats)
    reg = registry.register_model(tm, device='cpu')
    kfac = KFACPreconditioner(reg, device='cpu', **kw)
    _, grads, stats = capture.CurvatureCapture(reg).value_stats_and_grad(torch_loss(tm))(
        tuple(torch.from_numpy(b) for b in batch))
    _, pg = kfac.step(kfac.init(), grads, stats)
    want = convert.from_flax_params(jax.device_get(jpg))
    scale = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(pg[n].numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def test_mask_lora_rule_matches_jax():
    jm, _, tm, (x, _) = unit_pair()
    jreg = kfac_tpu.register_model(jm, jnp.asarray(x))
    reg = registry.register_model(tm, device='cpu')
    # freezing the base keeps the unit: it is never preconditioned
    kept = registry.masked_registry(reg, {'lora': {'base': False}})
    jkept = kfac_tpu.layers.registry.masked_registry(jreg, {'lora': {'base': False}})
    assert kept.names() == jkept.names() == ['lora'] and kept.taps == jkept.taps
    # both adapters frozen: the unit goes, with its taps
    gone = registry.masked_registry(reg, {'lora': {'down': False, 'up': False}})
    assert gone.names() == [] and gone.taps == {}
    # one adapter frozen: the pair preconditions as one, so it raises
    for mask in ({'lora': {'down': False}}, {'lora': {'up': False, 'base': False}}):
        with pytest.raises(ValueError, match='one adapter of LoRA unit'):
            registry.masked_registry(reg, mask)
        with pytest.raises(ValueError, match='one adapter of LoRA unit'):
            kfac_tpu.layers.registry.masked_registry(jreg, mask)
    # the optimizer's reading of the same mask
    assert [n for n, _ in tm.named_parameters()
            if registry.is_trainable({'lora': {'base': False}}, n)] == [
        'lora.down.weight', 'lora.up.weight']


def test_merge_registries_unions_and_rejects_collisions():
    _, _, tm, _ = unit_pair()
    model = torch.nn.ModuleDict({'unit': tm, 'head': torch.nn.Linear(D_OUT, 3)})
    both = registry.register_model(model, device='cpu')
    units = registry.register_model(model, device='cpu', skip_layers=['head'])
    heads = registry.register_model(model, device='cpu', skip_layers=['unit.*'])
    merged = registry.merge_registries(units, heads)
    assert sorted(merged.names()) == sorted(both.names()) == ['head', 'unit/lora']
    assert merged.taps == both.taps and merged.param_paths == both.param_paths
    with pytest.raises(ValueError, match='layer names collide'):
        registry.merge_registries(units, both)
    with pytest.raises(ValueError, match='different models'):
        registry.merge_registries(units, registry.register_model(OneUnit(), device='cpu'))


# ---------------------------------------------------------------- fine-tune

FT_STEPS = 20


def test_lora_finetune_matches_the_jax_trainer():
    """20 fine-tune steps of the JAX example's backbone (rank 8, frozen
    base, K-FAC cadence 1/10, lr 0.05, damping 0.003) from the same weights
    on the same batches of the digits 5-9, beside the JAX ``Trainer``."""
    (x_train, y_train), _ = data.digits()
    ft = y_train >= 5
    x_ft, y_ft = x_train[ft], y_train[ft]
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, len(x_ft), 128) for _ in range(FT_STEPS)]
    jmodel = jfinetune.Backbone(rank=8)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x_ft[:128]))['params'])
    mask = finetune_lora.FROZEN_MASK
    jreg = kfac_tpu.register_model(jmodel, jnp.asarray(x_ft[:128]), mask=mask)
    jkfac = kfac_tpu.KFACPreconditioner(registry=jreg, damping=0.003, lr=0.05,
                                        factor_update_steps=1, inv_update_steps=10)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: 'frozen' if 'base' in [getattr(k, 'key', '') for k in path] else 'train',
        params,
    )
    opt = optax.multi_transform({'train': optax.sgd(0.05), 'frozen': optax.set_to_zero()}, labels)
    jtr = jtraining.Trainer(loss_fn=jfinetune._loss_fn(jmodel), optimizer=opt, kfac=jkfac)
    jst = jtr.init(params, None)
    jlosses = []
    for i in idx:
        jst, loss = jtr.step(jst, (jnp.asarray(x_ft[i]), jnp.asarray(y_ft[i])))
        jlosses.append(float(loss))

    model = finetune_lora.Backbone(rank=8, device='cpu')
    model.load_state_dict(convert.from_flax_params(params))
    tr = finetune_lora.finetune_trainer(model, 0.05, 0.003, torch.device('cpu'))
    assert tr.kfac.registry.names() == jreg.names() == ['dense0', 'dense1', 'head']
    base = model.dense0.base.weight.detach().clone()
    st = tr.init()
    losses = []
    for i in idx:
        st, loss = tr.step(st, (torch.from_numpy(x_ft[i]), torch.from_numpy(y_ft[i])))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert torch.equal(model.dense0.base.weight, base)  # the frozen base never moved
    want = convert.from_flax_params(jax.device_get(jst.params))
    scale = max(float(w.abs().max()) for w in want.values())
    got = model.state_dict()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=n)
