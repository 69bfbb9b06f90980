"""The port's K-FAC slice end to end against the JAX package.

Twelve steps of the bench's training loop (capture steps at 0 and 10,
factor cadence 10, inverse cadence 5 so refreshes land at 0, 5 and 10;
Newton-Schulz starts cold at 0 and warm from the last inverse at 5 and 10),
SGD(0.1, momentum 0.9), run by both packages from the same flax weights
and batch: batch 2, seq 32, d_model 64, 2 layers, 4 heads, vocab 128.
Tolerances: losses rtol 1e-5; preconditioned grads rtol 1e-4 with atol
1e-4 x the step's max |grad|; factors rtol 1e-4 with atol 1e-4 x each
factor's max. Eigenvectors are never compared element-wise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from kfac_tpu.models import MLP
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu_torch import convert, enums
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.ops import factors as factors_lib
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.preconditioner import (
    KFACPreconditioner,
    default_compute_method,
    set_grads,
)

CFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_len=32)
KFAC = dict(damping=0.003, lr=0.1, factor_update_steps=10, inv_update_steps=5)
STEPS = 12

CONFIGS = {
    'eigen': dict(compute_method='eigen', prediv_eigenvalues=False),
    'eigen-prediv': dict(compute_method='eigen', prediv_eigenvalues=True),
    'inverse-cholesky': dict(compute_method='inverse', inverse_solver='cholesky'),
    # refreshes at 0 (cold start) and 5, 10 (warm starts from the last inverse)
    'inverse-newton-schulz': dict(compute_method='inverse', inverse_solver='newton_schulz'),
    'inverse-auto': dict(compute_method='inverse', inverse_solver='auto'),
}


def data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG['vocab_size'], (2, 32)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def jax_run(config):
    tokens, targets = data()
    model = JaxLM(**CFG)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params']
    init_params = jax.device_get(params)
    reg = kfac_tpu.register_model(model, jnp.asarray(tokens), skip_layers=['lm_head'])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # inverse cadence not a multiple
        kfac = kfac_tpu.KFACPreconditioner(registry=reg, **KFAC, **config)
    loss = jax_lm_loss(model)
    run = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(loss)
    opt = optax.sgd(0.1, momentum=0.9)

    def finish(params, kstate, opt_state, l, grads, stats):
        kstate, pgrads = kfac.step(kstate, grads, stats)
        updates, opt_state = opt.update(pgrads, opt_state, params)
        return optax.apply_updates(params, updates), kstate, opt_state, l, pgrads

    @jax.jit
    def capture_step(params, kstate, opt_state, batch):
        (l, _), grads, stats = run(params, batch)
        return finish(params, kstate, opt_state, l, grads, stats)

    @jax.jit
    def plain_step(params, kstate, opt_state, batch):
        l, grads = jax.value_and_grad(loss)(params, batch)
        return finish(params, kstate, opt_state, l, grads, None)

    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    kstate, opt_state = kfac.init(), opt.init(params)
    losses, pgrads, factors = [], [], {}
    for i in range(STEPS):
        step = capture_step if i % 10 == 0 else plain_step
        params, kstate, opt_state, l, pg = step(params, kstate, opt_state, batch)
        losses.append(float(l))
        pgrads.append(convert.from_flax_params(jax.device_get(pg)))
        if i % 10 == 0:
            factors[i] = jax.device_get((kstate.a, kstate.g))
    return init_params, losses, pgrads, factors


def torch_run(init_params, config):
    tokens, targets = data()
    model = TransformerLM(**CFG, device='cpu')
    model.load_state_dict(convert.from_flax_params(init_params))
    reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        kfac = KFACPreconditioner(reg, **KFAC, **config, device='cpu')
    loss = lm_loss(model)
    run = capture.CurvatureCapture(reg).value_stats_and_grad(loss)
    plain = capture.value_and_grad(model, loss)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    kstate = kfac.init()
    losses, pgrads, factors = [], [], {}
    for i in range(STEPS):
        if i % 10 == 0:
            (l, _), grads, stats = run(batch)
        else:
            (l, grads), stats = plain(batch), None
        kstate, pg = kfac.step(kstate, grads, stats)
        set_grads(model, pg)
        opt.step()
        losses.append(float(l))
        pgrads.append({n: g.detach().clone() for n, g in pg.items()})
        if i % 10 == 0:
            factors[i] = (dict(kstate.a), dict(kstate.g))
    return losses, pgrads, factors


@pytest.mark.parametrize('config', list(CONFIGS), ids=list(CONFIGS))
def test_twelve_step_slice_matches_jax(config):
    init_params, jlosses, jpgrads, jfactors = jax_run(CONFIGS[config])
    tlosses, tpgrads, tfactors = torch_run(init_params, CONFIGS[config])
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    for i, (tg, jg) in enumerate(zip(tpgrads, jpgrads)):
        assert set(tg) == set(jg)
        scale = max(float(g.abs().max()) for g in jg.values())
        for name in jg:
            np.testing.assert_allclose(
                tg[name].numpy(), jg[name].numpy(), rtol=1e-4,
                atol=1e-4 * scale, err_msg=f'step {i} {name}',
            )
    assert sorted(tfactors) == sorted(jfactors) == [0, 10]
    for i in (0, 10):
        for tside, jside in zip(tfactors[i], jfactors[i]):
            for name, want in jside.items():
                want = np.asarray(want)
                np.testing.assert_allclose(
                    tside[name].numpy(), want, rtol=1e-4,
                    atol=1e-4 * float(np.max(np.abs(want))),
                    err_msg=f'step {i} {name}',
                )


# the Newton-Schulz case refreshes on every step and captures on both, so
# the port's step 1 warm-starts from the carried JAX inverses of step 0
CARRY = {
    'eigen': dict(KFAC),
    'inverse-newton-schulz': dict(
        KFAC, factor_update_steps=1, inv_update_steps=1,
        **CONFIGS['inverse-newton-schulz'],
    ),
}


@pytest.mark.parametrize('config', list(CARRY), ids=list(CARRY))
def test_from_jax_kfac_state_continues_like_jax(config, monkeypatch):
    kfac_kw = CARRY[config]
    capture_both = kfac_kw['factor_update_steps'] == 1
    tokens, targets = data()
    model = JaxLM(**CFG)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params']
    reg = kfac_tpu.register_model(model, jnp.asarray(tokens), skip_layers=['lm_head'])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # inverse cadence not a multiple
        jkfac = kfac_tpu.KFACPreconditioner(registry=reg, **kfac_kw)
    (_, _), grads, stats = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(
        jax_lm_loss(model)
    )(params, (jnp.asarray(tokens), jnp.asarray(targets)))
    jstate0, _ = jkfac.step(jkfac.init(), grads, stats)
    jstate1, jpg = jkfac.step(jstate0, grads, stats if capture_both else None)

    tmodel = TransformerLM(**CFG, device='cpu')
    tmodel.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    treg = registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        tkfac = KFACPreconditioner(treg, **kfac_kw, device='cpu')
    # the JAX state after step 0, carried over, then step 1 in the port
    tstate = convert.from_jax_kfac_state(jstate0, tkfac)
    assert tstate.step == 1
    tgrads = convert.from_flax_params(jax.device_get(grads))
    tstats = None
    if capture_both:
        (_, _), _, tstats = capture.CurvatureCapture(treg).value_stats_and_grad(
            lm_loss(tmodel)
        )((torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()))
    starts = []
    solve = factors_lib.damped_inverse
    monkeypatch.setattr(
        factors_lib, 'damped_inverse',
        lambda f, dmp, solver, iters, x0: starts.append(x0) or solve(f, dmp, solver, iters, x0),
    )
    tstate, tpg = tkfac.step(tstate, tgrads, tstats)
    want = convert.from_flax_params(jax.device_get(jpg))
    scale = max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            tpg[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6 * scale,
            err_msg=name,
        )
    if tkfac.eigen:
        assert not starts
        return
    # each refresh started from the carried inverse, A then G per layer,
    # and lands on JAX's warm-started inverse (rtol 1e-4, atol 1e-5 x max)
    carried = [
        np.asarray(side[n]) for n in treg.layers for side in (jstate0.a_inv, jstate0.g_inv)
    ]
    assert len(starts) == len(carried)
    for x0, c in zip(starts, carried):
        assert torch.equal(x0, torch.from_numpy(np.array(c)))
    for side_t, side_j in ((tstate.a_inv, jstate1.a_inv), (tstate.g_inv, jstate1.g_inv)):
        for name in treg.layers:
            want = np.asarray(side_j[name])
            np.testing.assert_allclose(
                side_t[name].numpy(), want, rtol=1e-4,
                atol=1e-5 * float(np.max(np.abs(want))), err_msg=name,
            )


def test_default_compute_method_cuda_branch_equals_jax_off_tpu():
    assert default_compute_method('cuda') == (enums.ComputeMethod.EIGEN, 'cholesky')
    assert default_compute_method('cpu') == (enums.ComputeMethod.EIGEN, 'cholesky')
    assert default_compute_method('tpu') == (enums.ComputeMethod.INVERSE, 'newton_schulz')
    jax_default = kfac_tpu.default_compute_method('cpu')
    assert (jax_default[0].name, jax_default[1]) == ('EIGEN', 'cholesky')


def small_registry():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3))
    return registry.register_model(model, device='cpu')


@pytest.mark.parametrize(
    'knob,value',
    [
        ('health', True), ('metrics', True), ('flight', 8),
        ('async_inverse', 'sliced'), ('offload', True),
        ('stat_compression', 'int8'), ('compile_watch', True),
        ('eigh_impl', 'host'), ('eigh_impl', 'eig_host'),
    ],
)
def test_later_slice_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError):
        KFACPreconditioner(small_registry(), device='cpu', **{knob: value})


@pytest.mark.parametrize('solver', ['newton_schulz', 'auto'])
def test_newton_schulz_solver_with_eigen_warns_as_jax_does(solver):
    jreg = kfac_tpu.register_model(MLP(features=(), num_classes=3), jnp.zeros((1, 4)))
    with pytest.warns(UserWarning) as ours:
        KFACPreconditioner(
            small_registry(), device='cpu', compute_method='eigen', inverse_solver=solver
        )
    with pytest.warns(UserWarning) as theirs:
        kfac_tpu.KFACPreconditioner(
            registry=jreg, compute_method='eigen', inverse_solver=solver
        )
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        KFACPreconditioner(
            small_registry(), device='cpu', compute_method='inverse', inverse_solver=solver
        )


def test_unknown_options_are_rejected():
    with pytest.raises(ValueError):
        KFACPreconditioner(small_registry(), device='cpu', compute_method='svd')
    with pytest.raises(ValueError):
        KFACPreconditioner(small_registry(), device='cpu', factor_update_steps=0)
