"""The port's MoE family against the JAX package: routed factors and
``effective_alpha``, the switch ``MoEMLP`` (dense masked and capacity
dispatch), ``load_balance_loss``, the MoE LM (``tests/test_moe.py``'s: vocab
64, d_model 32, 2 layers, 4 heads, 4 experts, an MoE block every second),
routed capture (``CapturedStats`` a, g, w), the dense engine's weighted
EMA, and ``DistributedKFAC`` over a gloo world of two ranks whose row
blocks route different numbers of tokens to each expert. Inputs come from
numpy seeds; flax weights carry over with ``convert.from_flax_params``.

Tolerances (``tests/test_torch_model.py``'s): outputs, losses and routed
factors rtol 1e-5 with atol 1e-6 x max|reference|; parameter gradients the
same with the max over the whole gradient; expert indices exactly. Engine
steps (``tests/test_torch_preconditioner.py``'s): losses rtol 1e-5,
preconditioned grads rtol 1e-4 with atol 1e-4 x the step's max, factors
rtol 1e-4 with atol 1e-4 x each factor's max; the gloo world's factor
stacks rtol 1e-5 with atol 1e-6 x max and its grads rtol 1e-4 with atol
1e-5 x max (``tests/test_torch_kaisa.py``'s), its int8 transport's
factors within one int8 quantum of the largest entry. A starved expert's
factors are compared bitwise.
"""

import fcntl
import os
import pickle
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
import torch_moe_ranks as ranks
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.models import moe as jmoe
from kfac_tpu.ops import cov as jcov
from kfac_tpu.ops import factors as jfactors
from kfac_tpu.ops import losses as jlosses
from kfac_tpu.parallel import DistributedKFAC as JaxDistributedKFAC
from kfac_tpu.parallel import kaisa_mesh as jax_kaisa_mesh
from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss, moe
from kfac_tpu_torch.ops import cov
from kfac_tpu_torch.ops import factors
from kfac_tpu_torch.parallel import spawn_world
from kfac_tpu_torch.preconditioner import KFACPreconditioner, set_grads

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

CFG = ranks.MOE_CFG
ROUTED = ranks.ROUTED
LB = 0.01  # the load-balance weight of the flagship MoE configuration


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))))


def close_grads(got, flax_grads, rtol=1e-5, atol_rel=1e-6):
    want = convert.from_flax_params(jax.device_get(flax_grads))
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), rtol=rtol, atol=atol_rel * scale, err_msg=name,
        )


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ routed factors


def masked_rows(n_live, seed=0, shape=(12, 5)):
    """Random rows of which the first ``n_live`` (over the flattened
    leading dims) are live and the rest zero."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[n_live:] = 0.0
    return x


@pytest.mark.parametrize('n_live', [0, 1, 7, 12])
@pytest.mark.parametrize('has_bias', [True, False])
def test_routed_a_factor_and_live_fraction_match_jax(n_live, has_bias):
    x = masked_rows(n_live)
    close(cov.routed_linear_a_factor(t(x), has_bias), jcov.routed_linear_a_factor(x, has_bias))
    close(cov.routed_live_fraction(t(x)), jcov.routed_live_fraction(x))
    if n_live == 0:  # an all-zero input: zeros, not 0/0
        assert torch.equal(cov.routed_linear_a_factor(t(x), has_bias),
                           torch.zeros((5 + has_bias,) * 2))


@pytest.mark.parametrize('n_live', [0, 1, 7, 12])
def test_routed_g_factor_matches_jax(n_live):
    g = masked_rows(n_live, seed=1, shape=(3, 4, 6))
    got = cov.routed_linear_g_factor(t(g))
    close(got, jcov.routed_linear_g_factor(g))
    # the per-expert oracle: the live rows' covariance over their count
    rows = g.reshape(-1, 6)[:n_live]
    close(got, rows.T @ rows / max(n_live, 1) if n_live else np.zeros((6, 6)), atol_rel=1e-6)


def test_effective_alpha_matches_jax():
    w = np.array([0.0, 0.25, 1.0], np.float32)
    for alpha in (0.95, torch.tensor(0.9)):
        got = factors.effective_alpha(alpha, t(w))
        want = jfactors.effective_alpha(float(alpha), jnp.asarray(w))
        close(got, want)
    assert float(factors.effective_alpha(0.95, torch.tensor(0.0))) == 1.0


# ------------------------------------------------------------------ MoEMLP


def moe_pair(capacity_factor, num_experts=4, d=8, tokens=(2, 12), seed=0):
    """A flax ``MoEMLP`` and the port's with its weights, an input and a
    cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*tokens, d)).astype(np.float32)
    r = rng.normal(size=(*tokens, d)).astype(np.float32)
    jm = jmoe.MoEMLP(num_experts=num_experts, capacity_factor=capacity_factor)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))['params'])
    tm = moe.MoEMLP(d, num_experts, capacity_factor=capacity_factor)
    tm.load_state_dict(convert.from_flax_params(params))
    return jm, params, tm, x, r


@pytest.mark.parametrize('capacity_factor', [None, 1.25, 0.5])
def test_moe_mlp_outputs_grads_and_routing_match_jax(capacity_factor):
    jm, params, tm, x, r = moe_pair(capacity_factor)

    def jloss(p):
        y, inter = jm.apply({'params': p}, jnp.asarray(x), mutable=['intermediates'])
        return jnp.sum(y * r), (y, inter['intermediates'])

    (_, (jy, inter)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    xt = t(x)
    y = tm(xt)
    torch.sum(y * t(r)).backward()
    # routings first: a flipped argmax would explain any later difference
    np.testing.assert_array_equal(tm.expert_index.numpy(), np.asarray(inter['expert_index'][0]))
    close(tm.router_probs, inter['router_probs'][0])
    close(y, jy)
    close_grads({n: p.grad for n, p in tm.named_parameters()}, jgrads)


def test_capacity_dispatch_drops_overflow_and_full_capacity_is_dense():
    # one slot an expert: at most E tokens get expert output, the others 0
    _, _, tight, x, _ = moe_pair(2 / 12, num_experts=2, tokens=(1, 12))
    y = tight(t(x)).detach()
    live = torch.any(y[0].abs() > 0, dim=-1)
    assert int(live.sum()) <= 2
    dense = moe.MoEMLP(8, 2)
    dense.load_state_dict(tight.state_dict())
    y_dense = dense(t(x)).detach()
    close(y[0][live], y_dense[0][live].numpy())
    # C = T: nothing drops, the capacity path is the dense path
    _, _, full, x, _ = moe_pair(4.0)
    dense = moe.MoEMLP(8, 4)
    dense.load_state_dict(full.state_dict())
    close(full(t(x)), dense(t(x)).detach().numpy())


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 8, 4)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits)))
    idx = probs.argmax(-1)
    close(moe.load_balance_loss(t(probs), t(idx), 4), jmoe.load_balance_loss(probs, idx, 4))
    uniform = moe.load_balance_loss(torch.full((2, 8, 4), 0.25), torch.arange(4).repeat(4).view(2, 8), 4)
    assert abs(float(uniform) - 1.0) < 1e-6
    assert moe.expert_tp_overrides() == jmoe.expert_tp_overrides()


# ------------------------------------------------------------------ MoE LM


def lm_data(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG['vocab_size'], (batch, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def jax_moe_loss(model, weight=LB):
    """The JAX LM loss plus ``weight`` x the sown routings' load-balance
    loss, summed over the MoE blocks."""

    def loss_fn(params, batch):
        tokens, targets = batch
        logits, inter = model.apply({'params': params}, tokens, mutable=['intermediates'])
        loss = jnp.mean(jlosses.vocab_parallel_nll(logits, targets))
        for block in inter['intermediates'].values():
            m = block['moe']
            loss = loss + weight * jmoe.load_balance_loss(
                m['router_probs'][0], m['expert_index'][0], CFG['num_experts'])
        return loss

    return loss_fn


def lm_pair(capacity_factor=None, starve=None, batch=4):
    """The flax MoE LM, its params (expert ``starve`` of block1 never
    chosen: its router bias at -1e4), the port's twin and a batch."""
    jm = JaxLM(**CFG, moe_capacity_factor=capacity_factor)
    tokens, targets = lm_data(batch)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params'])
    if starve is not None:
        params['block1']['moe']['router']['bias'][starve] = -1e4
    tm = TransformerLM(**CFG, moe_capacity_factor=capacity_factor, device='cpu')
    tm.load_state_dict(convert.from_flax_params(params))
    jbatch = (jnp.asarray(tokens), jnp.asarray(targets))
    tbatch = (t(tokens).long(), t(targets).long())
    return jm, params, tm, jbatch, tbatch


@pytest.mark.parametrize('capacity_factor', [None, 1.25])
def test_moe_lm_loss_and_grads_match_jax(capacity_factor):
    jm, params, tm, jbatch, tbatch = lm_pair(capacity_factor)
    jl, jg = jax.value_and_grad(jax_moe_loss(jm))(params, jbatch)
    _, inter = jm.apply({'params': params}, jbatch[0], mutable=['intermediates'])
    loss = lm_loss(tm, LB)(tbatch)
    loss.backward()
    np.testing.assert_array_equal(
        tm.block1.moe.expert_index.numpy(),
        np.asarray(inter['intermediates']['block1']['moe']['expert_index'][0]),
    )
    close(loss, jl)
    close_grads({n: p.grad for n, p in tm.named_parameters()}, jg)


def test_moe_registration_layers_and_routed_errors():
    _, _, tm, _, _ = lm_pair()
    reg = registry.register_model(tm, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    jm = JaxLM(**CFG)
    jreg = kfac_tpu.register_model(jm, jnp.zeros((4, 16), jnp.int32), skip_layers=['lm_head'],
                                   routed_layers=ROUTED)
    assert reg.names() == jreg.names()
    assert [n for n, h in reg.layers.items() if h.weighted] == [
        n for n, h in jreg.layers.items() if h.weighted]
    assert not reg.layers['block1/moe/router'].routed
    with pytest.raises(ValueError, match='matched no registered layer'):
        registry.register_model(tm, device='cpu', routed_layers=[r'.*expert\d+_upp'])
    with pytest.raises(ValueError, match='not a dense layer'):
        registry.register_model(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)), device='cpu',
                                routed_layers=['0'])


# ----------------------------------------------------------- routed capture


def test_routed_capture_matches_jax_and_the_per_expert_oracle():
    jm, params, tm, jbatch, tbatch = lm_pair(1.25, starve=3)
    jreg = kfac_tpu.register_model(jm, jbatch[0], skip_layers=['lm_head'], routed_layers=ROUTED)
    (jl, _), _, jstats = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(
        jax_moe_loss(jm))(params, jbatch)
    reg = registry.register_model(tm, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    inputs = {}
    tm.block1.moe.register_forward_pre_hook(lambda m, a: inputs.update(x=a[0].detach()))
    (loss, _), _, stats = capture.CurvatureCapture(reg).value_stats_and_grad(lm_loss(tm, LB))(tbatch)
    close(loss, jl)
    assert set(stats.a) == set(jstats.a) and set(stats.w) == set(jstats.w)
    for n in jstats.a:
        close(stats.a[n], jstats.a[n], atol_rel=1e-5 if n in stats.w else 1e-6)
        close(stats.g[n], jstats.g[n], atol_rel=1e-5 if n in stats.w else 1e-6)
    for n, w in jstats.w.items():
        close(stats.w[n], w)
    # each expert's up A is the covariance of the tokens it kept (arrival
    # order, the first C), with a bias one each, over their count
    m = tm.block1.moe
    x = inputs['x'].reshape(-1, CFG['d_model'])
    idx = m.expert_index.reshape(-1)
    cap = m.capacity(x.shape[0])
    for e in range(3):
        rows = x[idx == e][:cap]
        rows = torch.cat([rows, torch.ones(rows.shape[0], 1)], 1)
        close(stats.a[f'block1/moe/expert{e}_up'], (rows.T @ rows / rows.shape[0]).numpy())
        # the weight: the buffer's live fraction, its kept tokens over C
        close(stats.w[f'block1/moe/expert{e}_up'], rows.shape[0] / cap)
    # the starved expert: zero factors and weight, and its running factors
    # stay bitwise through the weighted EMA
    starved = [f'block1/moe/expert3_{s}' for s in ('up', 'down')]
    for n in starved:
        assert float(stats.w[n]) == 0.0
        assert not stats.a[n].any() and not stats.g[n].any()
    kfac = KFACPreconditioner(reg, device='cpu')
    before = kfac.update_factors(kfac.init(), stats)
    after = kfac.update_factors(before, stats)
    for n in starved:
        assert torch.equal(after.a[n], before.a[n]) and torch.equal(after.g[n], before.g[n])
        assert torch.equal(after.a[n], torch.eye(after.a[n].shape[0]))
    assert not torch.equal(after.a['block1/moe/expert0_up'], before.a['block1/moe/expert0_up'])


class TwoCall(torch.nn.Module):
    """One routed dense layer called twice a loss: on the input, then on
    zeros (tests/test_moe.py's ``TwoCall``)."""

    def __init__(self):
        super().__init__()
        self.shared = torch.nn.Linear(6, 4)

    def forward(self, x):
        return self.shared(x).sum(-1) + self.shared(torch.zeros_like(x)).sum(-1)


def test_multi_invocation_routed_capture_matches_jax():
    import flax.linen as nn

    class JTwoCall(nn.Module):
        @nn.compact
        def __call__(self, x):
            shared = nn.Dense(4, name='shared')
            return shared(x).sum(-1) + shared(jnp.zeros_like(x)).sum(-1)

    x = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    jm = JTwoCall()
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    jreg = kfac_tpu.register_model(jm, jnp.asarray(x), routed_layers=['shared'])
    _, _, jstats = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(
        lambda p, b: jnp.mean(jm.apply({'params': p}, b) ** 2))(params, jnp.asarray(x))
    tm = TwoCall()
    tm.load_state_dict(convert.from_flax_params(params))
    reg = registry.register_model(tm, device='cpu', routed_layers=['shared'])
    _, _, stats = capture.CurvatureCapture(reg).value_stats_and_grad(
        lambda b: torch.mean(tm(b) ** 2))(t(x))
    close(stats.a['shared'], jstats.a['shared'])
    close(stats.g['shared'], jstats.g['shared'])
    assert float(stats.w['shared']) == float(jstats.w['shared']) == 0.5
    # the G divisor is the cotangents' live fraction: both calls' are 1
    assert float(stats.wg['shared']) == 1.0


def test_accumulated_routed_stats_match_jax():
    from kfac_tpu.layers import capture as jcapture

    rng = np.random.default_rng(5)
    micro = []
    for w in (0.0, 0.25, 1.0):
        a = rng.normal(size=(3, 3)).astype(np.float32)
        micro.append((a @ a.T, a.T @ a, np.float32(w)))
    jacc = tacc = None
    for a, g, w in micro:
        jacc = jcapture.accumulate_stats(jacc, jcapture.CapturedStats(
            a={'e': jnp.asarray(a), 'p': jnp.asarray(a)}, g={'e': jnp.asarray(g), 'p': jnp.asarray(g)},
            w={'e': jnp.asarray(w)}))
        tacc = capture.accumulate_stats(tacc, capture.CapturedStats(
            a={'e': t(a), 'p': t(a)}, g={'e': t(g), 'p': t(g)}, w={'e': torch.tensor(w)}))
    javg, tavg = jcapture.average_stats(jacc, 3), capture.average_stats(tacc, 3)
    for side in ('a', 'g'):
        for n in ('e', 'p'):
            close(getattr(tavg, side)[n], getattr(javg, side)[n])
    close(tavg.w['e'], javg.w['e'])


# ------------------------------------------------------------- dense engine

ENGINE_STEPS = 3
ENGINE_CONFIGS = {
    'eigen': dict(compute_method='eigen'),
    'inverse-newton-schulz': dict(compute_method='inverse', inverse_solver='newton_schulz'),
}
# a refresh every step: Newton-Schulz starts cold at 0, warm at 1 and 2
ENGINE_KW = dict(damping=0.003, lr=0.1, factor_update_steps=1, inv_update_steps=1)


@pytest.mark.parametrize('config', list(ENGINE_CONFIGS))
def test_three_dense_engine_steps_match_jax(config):
    kw = dict(ENGINE_KW, **ENGINE_CONFIGS[config])
    jm, params, tm, jbatch, tbatch = lm_pair(1.25, starve=3, batch=8)
    jreg = kfac_tpu.register_model(jm, jbatch[0], skip_layers=['lm_head'], routed_layers=ROUTED)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jkfac = kfac_tpu.KFACPreconditioner(registry=jreg, **kw)
    jrun = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(jax_moe_loss(jm))

    @jax.jit
    def jstep(params, kstate):
        (loss, _), grads, stats = jrun(params, jbatch)
        kstate, pgrads = jkfac.step(kstate, grads, stats)
        return optax.apply_updates(params, jax.tree.map(lambda g: -0.1 * g, pgrads)), kstate, loss, pgrads

    reg = registry.register_model(tm, skip_layers=['lm_head'], device='cpu', routed_layers=ROUTED)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        kfac = KFACPreconditioner(reg, device='cpu', **kw)
    run = capture.CurvatureCapture(reg).value_stats_and_grad(lm_loss(tm, LB))
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    jstate, kstate = jkfac.init(), kfac.init()
    for i in range(ENGINE_STEPS):
        params, jstate, jl, jpg = jstep(params, jstate)
        (loss, _), grads, stats = run(tbatch)
        kstate, pg = kfac.step(kstate, grads, stats)
        set_grads(tm, pg)
        opt.step()
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        want = convert.from_flax_params(jax.device_get(jpg))
        scale = max(float(g.abs().max()) for g in want.values())
        for n, g in want.items():
            np.testing.assert_allclose(pg[n].detach().numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=f'step {i} {n}')
        for side in ('a', 'g'):
            for n, f in getattr(jstate, side).items():
                close(getattr(kstate, side)[n], f, rtol=1e-4, atol_rel=1e-4)
    for s in ('up', 'down'):  # the starved expert's factors never moved
        n = f'block1/moe/expert3_{s}'
        assert torch.equal(kstate.a[n], torch.eye(kstate.a[n].shape[0]))
        assert torch.equal(kstate.g[n], torch.eye(kstate.g[n].shape[0]))
    # and the JAX state carries over into the port's
    carried = convert.from_jax_kfac_state(jstate, kfac)
    assert carried.step == ENGINE_STEPS
    for n in jstate.a:
        np.testing.assert_array_equal(carried.a[n].numpy(), np.asarray(jstate.a[n]))


# -------------------------------------------------------------- gloo world

WORLD_CASES = [
    ('allreduce-1.0', dict(frac=1.0, steps=2, allreduce_method='allreduce')),
    ('bucketed-0.5', dict(frac=0.5, steps=2, allreduce_method='allreduce_bucketed')),
    ('int8-0.5', dict(frac=0.5, steps=1, allreduce_method='allreduce_bucketed',
                      stat_compression='int8')),
]


def run_world():
    """The JAX engine on the global batch of 8 rows (dense masked
    dispatch, so a rank's rows are routed as in the global batch), and the
    port's two gloo ranks, each on its 4 rows."""
    jm, params, _, jbatch, _ = lm_pair(None, batch=8)
    jreg = kfac_tpu.register_model(jm, jbatch[0], skip_layers=['lm_head'], routed_layers=ROUTED)
    (_, _), grads, stats = jax.jit(kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(
        jax_lm_loss(jm)))(params, jbatch)
    ref = {}
    for name, kw in WORLD_CASES:
        kw = dict(kw)
        frac, steps = kw.pop('frac'), kw.pop('steps')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            dk = JaxDistributedKFAC(
                config=kfac_tpu.KFACPreconditioner(registry=jreg, **ranks.STEP_KW, **kw),
                mesh=jax_kaisa_mesh(frac, devices=jax.devices()[:2]),
            )
        state, step = dk.init(), jax.jit(dk.step)
        for _ in range(steps):
            state, pg = step(state, grads, stats)
        ref[name] = {
            'grads': {k: v.numpy() for k, v in convert.from_flax_params(jax.device_get(pg)).items()},
            'a': {k: np.asarray(v) for k, v in state.a.items()},
            'g': {k: np.asarray(v) for k, v in state.g.items()},
            'state': {
                f: {k: np.asarray(v) for k, v in getattr(state, f).items()}
                for f in ('a', 'g', 'qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')
            } | {'step': int(state.step), 'inv_damping': float(state.inv_damping)},
        }
    spec = {
        'weights': {k: v.numpy() for k, v in convert.from_flax_params(params).items()},
        'batch': tuple(np.asarray(b) for b in jbatch),
        'cases': [(name, 'step', kw) for name, kw in WORLD_CASES] + [(
            'convert', 'convert',
            dict(frac=0.5, jax_state=ref['bucketed-0.5']['state'],
                 allreduce_method='allreduce_bucketed'),
        )],
    }
    out = spawn_world(ranks.run_cases, 2, 'gloo', 'cpu', args=(spec,), timeout_s=300)
    return ref, out, {k: float(v) for k, v in stats.w.items()}


@pytest.fixture(scope='module')
def world():
    """:func:`run_world` once per test run: under pytest-xdist the first
    worker to need it computes it under a file lock and leaves it in the
    temporary directory, keyed by the run's id, for the others."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return run_world()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_moe_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = run_world()
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(out, f)
        os.replace(path + '.tmp', path)
        return out


def test_gloo_ranks_route_unequal_counts(world):
    _, out, w_global = world
    w0, w1 = (out[r]['allreduce-1.0']['w'] for r in (0, 1))
    assert any(abs(float(w0[n]) - float(w1[n])) > 0 for n in w0)
    for n, w in w_global.items():  # the global live fraction is their mean
        assert abs((float(w0[n]) + float(w1[n])) / 2 - w) < 1e-6


@pytest.mark.parametrize('case', [c for c, _ in WORLD_CASES])
def test_gloo_world_matches_the_jax_engine_on_the_global_batch(world, case):
    ref, out, _ = world
    want = ref[case]
    quantum = case.startswith('int8')
    for r in range(2):
        got = out[r][case]
        for side in ('a', 'g'):
            for key, f in want[side].items():
                scale = float(np.abs(f).max())
                np.testing.assert_allclose(
                    got['state'][side][key], f, rtol=0 if quantum else 1e-5,
                    atol=scale / 127 if quantum else 1e-6 * scale, err_msg=f'{case} {side} {key}',
                )
        if quantum:
            continue
        scale = max(float(np.abs(g).max()) for g in want['grads'].values())
        for n, g in want['grads'].items():
            np.testing.assert_allclose(got['grads'][n], g, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f'{case} {n}')
    for n in out[0][case]['grads']:  # the same on every rank, bitwise
        np.testing.assert_array_equal(out[0][case]['grads'][n], out[1][case]['grads'][n])


def test_from_jax_dist_state_carries_the_moe_stacks(world):
    ref, out, _ = world
    want = ref['bucketed-0.5']['state']
    for r in range(2):
        got = out[r]['convert']['roundtrip']
        assert got['step'] == want['step']
        for f in ('a', 'g', 'qa', 'qg', 'da', 'dg'):
            assert set(got[f]) == set(want[f])
            for key, v in want[f].items():
                np.testing.assert_array_equal(got[f][key], v, err_msg=f'{f} {key}')
