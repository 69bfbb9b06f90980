"""Mixed precision in the PyTorch port, held against the JAX package on the
CPU with inputs made from numpy seeds.

Tolerances of a reduced dtype are its own, derived from its unit roundoff
u (bf16 2^-8, f16 2^-11) at the output; every f32 tolerance elsewhere is
unchanged:

- a single rounding of a covariance (``sym_cov``, the factor functions):
  within 2u of the largest element, one flip of the last bit of an
  element of at most that size, since the f32 sums before the rounding
  agree to ~2^-20; the control, the product accumulated in the 16-bit
  dtype, is tens of u off;
- the flash oracle against the Pallas kernel: on inputs built so that
  every rounding point and sum is exact (``flash_attention.exact_inputs``)
  acc bitwise and m, l within the f32 flash tolerance 1e-5 of max; p left
  unrounded moves acc and ``q * scale`` rounded to 16 bits (the einsum
  form) moves m, both outside; on normal inputs acc within 2u of its max
  (one rounding of each p, at a key tile's running max or the row's max);
- a model or an engine step (the bf16 LM against flax, the bf16 engine
  against the JAX engine, the loss-scaled f16 step against the JAX
  example's): the loss within 2u relative and grads, factors and updates
  within 8u of their largest (a few roundings of 16-bit products on each
  path, made at other points by XLA's fusions than by eager PyTorch). A
  model run in f32 stays inside those, so the dtype layout itself (what
  computes and what is stored in 16 bits) is checked directly.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import kfac_tpu
from examples import train_amp as jtrain_amp
from kfac_tpu import amp as jamp
from kfac_tpu.layers import capture as jcapture
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.ops import cov as jcov
from kfac_tpu.ops import pallas_attention as jpa
from kfac_tpu.ops import pallas_cov as jpallas_cov
from kfac_tpu_torch import amp, bench_lm, convert
from kfac_tpu_torch.examples import train_amp
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP, TransformerLM, lm_loss
from kfac_tpu_torch.models.layers import CastLinear
from kfac_tpu_torch.ops import cov, flash_attention, sym_cov
from kfac_tpu_torch.parallel import DistributedKFAC
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

U = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32}
HALF = pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])


def to_jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(JDT[x.dtype])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def err_of_max(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def tree_err_of_max(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    return max(float((got[n].float() - want[n].float()).abs().max()) for n in want) / scale


# ------------------------------------------------------------------- scaler


@pytest.mark.parametrize('flags', [
    [False, True, True, True, True],
    [True, True, False, True, True, True, True, False],
    [False, False, False],
], ids=['backoff-then-growth', 'growth-interrupted', 'backoffs'])
def test_scaler_schedule_matches_jax(flags):
    s, js = amp.init(1024.0, device='cpu'), jamp.init(1024.0)
    for finite in flags:
        s = amp.update(s, torch.tensor(finite), growth_interval=3)
        js = jamp.update(js, jnp.asarray(finite), growth_interval=3)
        assert float(s.scale) == float(js.scale)
        assert int(s.good_steps) == int(js.good_steps)
        assert s.scale.dtype == torch.float32 and s.good_steps.dtype == torch.int32
    default, jdefault = amp.init(device='cpu'), jamp.init()
    assert float(default.scale) == float(jdefault.scale) == 2.0**16


@pytest.mark.parametrize('bad', [None, float('inf'), float('nan')], ids=['finite', 'inf', 'nan'])
def test_all_finite_and_unscale_match_jax(bad):
    a, b = np.ones((2, 2), np.float32), np.full((3,), 8.0, np.float32)
    if bad is not None:
        a[0, 1] = bad
    tree = {'a': torch.from_numpy(a), 'b': torch.from_numpy(b)}
    jtree = {'a': jnp.asarray(a), 'b': jnp.asarray(b)}
    finite = amp.all_finite(tree)
    assert finite.shape == () and bool(finite) == bool(jamp.all_finite(jtree)) == (bad is None)
    un = amp.unscale(tree, torch.tensor(4.0))
    jun = jamp.unscale(jtree, jnp.asarray(4.0))
    np.testing.assert_array_equal(un['b'].numpy(), np.asarray(jun['b']))
    assert bool(amp.all_finite({})) and bool(jamp.all_finite({}))


def test_captured_stats_scaled_divides_g_by_scale_squared_as_jax():
    rng = np.random.default_rng(0)
    a = {n: rng.standard_normal((4, 4)).astype(np.float32) for n in ('x', 'y')}
    g = {n: rng.standard_normal((3, 3)).astype(np.float32) for n in ('x', 'y')}
    w = {'y': np.float32(0.5)}
    stats = capture.CapturedStats(
        a={n: torch.from_numpy(v) for n, v in a.items()},
        g={n: torch.from_numpy(v) for n, v in g.items()},
        w={'y': torch.tensor(w['y'])}, wg={'y': torch.tensor(0.25)},
    )
    jstats = jcapture.CapturedStats(
        a={n: jnp.asarray(v) for n, v in a.items()},
        g={n: jnp.asarray(v) for n, v in g.items()},
        w={'y': jnp.asarray(w['y'])},
    )
    scale = torch.tensor(2.0**12)
    out, jout = stats.scaled(scale), jstats.scaled(jnp.asarray(2.0**12))
    for n in a:
        assert out.a[n] is stats.a[n]
        np.testing.assert_array_equal(out.g[n].numpy(), np.asarray(jout.g[n]))
        # the control, G over the scale once, is 2^12 times off
        assert not np.allclose((stats.g[n] / scale).numpy(), np.asarray(jout.g[n]))
    assert out.w is stats.w and out.wg is stats.wg


# ---------------------------------------------------------------- factors


FACTORS = {
    'linear_a': (lambda a, dt: cov.linear_a_factor(a, True, dt),
                 lambda a, dt: jcov.linear_a_factor(a, True, dtype=dt)),
    'linear_g': (cov.linear_g_factor, lambda g, dt: jcov.linear_g_factor(g, dtype=dt)),
    'routed_a': (lambda a, dt: cov.routed_linear_a_factor(a, True, dt),
                 lambda a, dt: jcov.routed_linear_a_factor(a, True, dtype=dt)),
    'routed_g': (cov.routed_linear_g_factor, lambda g, dt: jcov.routed_linear_g_factor(g, dtype=dt)),
}


@pytest.mark.parametrize('name', sorted(FACTORS))
def test_factor_functions_at_bf16_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40, 24)).astype(np.float32)
    x[:, ::3] = 0.0  # unrouted rows, for the routed factors
    port, jax_fn = FACTORS[name]
    got = port(torch.from_numpy(x), torch.bfloat16)
    want = jax_fn(jnp.asarray(x), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert err_of_max(got, want) <= 2 * U[torch.bfloat16]
    assert torch.equal(got, got.T)


def test_conv_factors_at_bf16_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)  # NHWC, the JAX layout
    g = rng.standard_normal((2, 4, 4, 5)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    got_a = cov.conv2d_a_factor(xt, (3, 3), (2, 2), 'SAME', True, torch.bfloat16)
    want_a = jcov.conv2d_a_factor(jnp.asarray(x), (3, 3), (2, 2), 'SAME', True, dtype=jnp.bfloat16)
    got_g = cov.conv2d_g_factor(gt, torch.bfloat16)
    want_g = jcov.conv2d_g_factor(jnp.asarray(g), dtype=jnp.bfloat16)
    for got, want in ((got_a, want_a), (got_g, want_g)):
        assert got.dtype == torch.bfloat16
        assert err_of_max(got, want) <= 2 * U[torch.bfloat16]


@HALF
def test_sym_cov_plain_in_16_bits_is_the_pallas_kernel(dtype):
    """The kernel's plain version (f32 sum and divide, one rounding) against
    the Pallas kernel in interpret mode, and the CPU path (``get_cov``)
    against the JAX package's off-TPU ``get_cov`` in the same dtype."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((300, 70)).astype(np.float32)).to(dtype)
    got = sym_cov.sym_cov(a, 7.0)
    want = jpallas_cov.sym_cov(to_jax(a), scale=7.0, interpret=True)
    assert got.dtype == dtype and torch.equal(got, got.T)
    assert err_of_max(got, want) <= 2 * U[dtype]
    # the control, the product accumulated in the 16-bit dtype
    acc = torch.zeros((70, 70), dtype=dtype)
    for row in a:
        acc = acc + torch.outer(row, row)
    assert err_of_max(acc.float() / 7.0, want) > 2 * U[dtype]
    # the CPU path is the JAX package's CPU form
    cpu = cov.get_cov(a)
    assert cpu.dtype == dtype
    assert err_of_max(cpu, jcov.get_cov(to_jax(a))) <= 2 * U[dtype]


# ------------------------------------------------------------------ flash


@HALF
@pytest.mark.parametrize('inputs', ['exact', 'normal'])
def test_flash_oracle_in_16_bits_is_the_pallas_kernel(dtype, inputs):
    gen = torch.Generator().manual_seed(4)
    if inputs == 'exact':
        q, k, v = flash_attention.exact_inputs(2, 256, 2, 128, dtype, gen)
    else:
        q, k, v = (torch.randn(2, 256, 2, 128, generator=gen).to(dtype) for _ in range(3))
    want = jpa.flash_attention_partials(to_jax(q), to_jax(k), to_jax(v), causal=True, interpret=True)
    acc, m, l = flash_attention.attend_partials_rounded(q, k, v, 0, 0, True)
    assert err_of_max(m, want[1]) <= 1e-5 and err_of_max(l, want[2]) <= 1e-5
    if inputs == 'normal':
        assert err_of_max(acc, want[0]) <= 2 * U[dtype]
        return
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[0]))
    # the controls: p left unrounded moves acc, the einsum form moves m
    unrounded = flash_attention.attend_partials_rounded(q, k, v.float(), 0, 0, True)
    assert err_of_max(unrounded[0], want[0]) > 1e-5
    assert err_of_max(flash_attention.attend_partials_einsum(q, k, v, 0, 0, True)[1], want[1]) > 1e-5


def test_cpu_attention_is_the_jax_cpu_form_and_differs_from_the_kernels_in_bf16():
    """The CPU path stays the JAX package's off-TPU one, the einsum form;
    the card's kernel computes the Pallas form. In bf16 the two differ by
    the rounding of ``q * scale`` to bf16 (at most 2^-9 relative on each
    term of a logit), part of what separates the bf16 flagship on the card from the CPU; at
    f32 they agree to f32 rounding."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32) for _ in range(3))
    for dtype in (torch.bfloat16, torch.float32):
        qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        cpu = flash_attention.flash_attention_partials(qt, kt, vt, 0, 0, True)
        jcpu = jpa.attend_partials_einsum(*(to_jax(x) for x in (qt, kt, vt)), 0, 0, True)
        einsum = flash_attention.attend_partials_einsum(qt, kt, vt, 0, 0, True)
        for got, same, want in zip(cpu, einsum, jcpu):
            assert torch.equal(got, same)
            assert err_of_max(got, want) <= (2 * U[torch.bfloat16] if dtype != torch.float32 else 1e-6)
        kernel_form = flash_attention.attend_partials_rounded(qt, kt, vt, 0, 0, True)
        gap = err_of_max(kernel_form[1], cpu[1])
        if dtype == torch.float32:
            assert gap <= 1e-6
        else:
            assert 1e-5 < gap <= 2 * U[torch.bfloat16]


# ------------------------------------------------------------------ model

LM_CFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_len=32)


def test_bf16_lm_loss_and_grads_match_flax():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, (2, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jmodel = JaxLM(**LM_CFG, dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params']
    model = TransformerLM(**LM_CFG, device='cpu', dtype=torch.bfloat16)
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    assert all(p.dtype == torch.float32 for p in model.parameters())  # f32 masters
    jloss, jgrads = jax.value_and_grad(jax_lm_loss(jmodel))(
        params, (jnp.asarray(tokens), jnp.asarray(targets))
    )
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    loss, grads = capture.value_and_grad(model, lm_loss(model))(batch)
    u = U[torch.bfloat16]
    assert abs(float(loss) - float(jloss)) <= 2 * u * abs(float(jloss))
    assert tree_err_of_max(grads, convert.from_flax_params(jax.device_get(jgrads))) <= 8 * u
    # the layout: dense layers compute in bf16, LayerNorms and logits in f32
    seen = {}
    hooks = [
        model.get_submodule(n).register_forward_hook(
            lambda mod, inp, out, n=n: seen.__setitem__(n, out.dtype)
        )
        for n in ('block0.attn.q_proj', 'block1.mlp_down', 'block0.ln1', 'ln_f', 'lm_head')
    ]
    assert model(batch[0]).dtype == torch.float32
    for h in hooks:
        h.remove()
    assert seen == {
        'block0.attn.q_proj': torch.bfloat16, 'block1.mlp_down': torch.bfloat16,
        'block0.ln1': torch.float32, 'ln_f': torch.float32, 'lm_head': torch.float32,
    }
    assert isinstance(model.block0.attn.q_proj, CastLinear)
    assert type(TransformerLM(**LM_CFG, device='cpu').block0.attn.q_proj) is torch.nn.Linear


# ---------------------------------------------------------------- engines

X = np.random.default_rng(6).standard_normal((32, 12)).astype(np.float32)
Y = np.random.default_rng(7).integers(0, 5, 32)


def flax_mlp_params(model):
    return model.init(jax.random.PRNGKey(0), jnp.asarray(X))['params']


def test_dense_engine_at_bf16_stores_matches_jax_for_two_steps():
    fm = kfac_tpu.models.MLP(features=(16,), num_classes=5)
    params = flax_mlp_params(fm)

    def jloss(p, b):
        return optax.softmax_cross_entropy_with_integer_labels(fm.apply({'params': p}, b[0]), b[1]).mean()

    jreg = kfac_tpu.register_model(fm, jnp.asarray(X), factor_dtype=jnp.bfloat16)
    jkfac = kfac_tpu.KFACPreconditioner(
        registry=jreg, damping=0.01, lr=0.1, factor_dtype=jnp.bfloat16, inv_dtype=jnp.bfloat16,
    )
    jrun = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(jloss)
    model = MLP(12, (16,), 5, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    reg = registry.register_model(model, device='cpu', factor_dtype=torch.bfloat16)
    kfac = KFACPreconditioner(
        reg, damping=0.01, lr=0.1, factor_dtype=torch.bfloat16, inv_dtype=torch.bfloat16,
        device='cpu',
    )
    run = capture.CurvatureCapture(reg).value_stats_and_grad(
        lambda b: F.cross_entropy(model(b[0]), b[1])
    )
    jstate, state = jkfac.init(), kfac.init()
    u = U[torch.bfloat16]
    for _ in range(2):
        _, jg, jst = jrun(params, (jnp.asarray(X), jnp.asarray(Y)))
        jstate, jp = jkfac.step(jstate, jg, jst)
        _, g, st = run((torch.from_numpy(X), torch.from_numpy(Y).long()))
        assert all(v.dtype == torch.bfloat16 for v in (*st.a.values(), *st.g.values()))
        state, p = kfac.step(state, g, st)
        for n in state.a:
            assert state.a[n].dtype == state.qa[n].dtype == state.da[n].dtype == torch.bfloat16
            assert err_of_max(state.a[n], jstate.a[n]) <= 2 * u
            assert err_of_max(state.g[n], jstate.g[n]) <= 2 * u
        assert all(v.dtype == torch.float32 for v in p.values())  # the grads' own dtype
        assert tree_err_of_max(p, convert.from_flax_params(jax.device_get(jp))) <= 8 * u
    usage = kfac.memory_usage(state)
    assert usage['a_factors'] == sum(2 * v.numel() for v in state.a.values())


class F16MLP(fnn.Module):
    """A small dense model computing in float16, f32 parameters."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Dense(16, dtype=jnp.float16, name='dense0')(x))
        return fnn.Dense(5, dtype=jnp.float16, name='head')(x)


@pytest.mark.parametrize('engine', ['dense', 'kaisa'])
def test_loss_scaled_f16_steps_match_the_jax_example(engine):
    """Three steps of the JAX example's loop (``examples/train_amp.py``'s
    ``build_step``) against ``train_amp.amp_step`` on the same weights: an
    applied step, a forced overflow (inputs past f16's range) that skips,
    an applied step. The dense engine, and ``DistributedKFAC`` in a world
    of one rank."""
    fm = F16MLP()
    params = flax_mlp_params(fm)
    jreg = kfac_tpu.register_model(fm, jnp.asarray(X))
    jkfac = kfac_tpu.KFACPreconditioner(
        registry=jreg, damping=0.003, lr=0.05, factor_update_steps=1, inv_update_steps=2,
    )
    jopt = optax.sgd(0.05, momentum=0.9)
    jstep = jtrain_amp.build_step(fm, jkfac, jopt, jreg)
    jk, jo, jscaler = jkfac.init(), jopt.init(params), jamp.init(2.0**12)

    model = MLP(12, (16,), 5, device='cpu', dtype=torch.float16)
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    reg = registry.register_model(model, device='cpu')
    config = KFACPreconditioner(
        reg, damping=0.003, lr=0.05, factor_update_steps=1, inv_update_steps=2, device='cpu',
    )
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    run = capture.CurvatureCapture(reg).value_stats_and_grad(
        lambda b, scale: F.cross_entropy(model(b[0]).float(), b[1]) * scale
    )
    scaler = amp.init(2.0**12, device='cpu')
    u = U[torch.float16]
    with bench_lm.one_rank_world(torch.device('cpu')):
        kfac = config if engine == 'dense' else DistributedKFAC(config)
        kstate = kfac.init()
        for i, poison in enumerate((1.0, 1e5, 1.0)):
            x = X * poison
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            jparams_before = params
            params, jk, jo, jscaler, jloss, jfinite = jstep(
                params, jk, jo, jscaler, (jnp.asarray(x), jnp.asarray(Y)), 2
            )
            kstate, scaler, loss, applied = train_amp.amp_step(
                model, kfac, opt, run, kstate, scaler,
                (torch.from_numpy(x), torch.from_numpy(Y).long()), 2,
            )
            assert applied == bool(jfinite) == (poison == 1.0)
            assert float(scaler.scale) == float(jscaler.scale)
            assert int(scaler.good_steps) == int(jscaler.good_steps)
            assert int(kstate.step) == int(jk.step) == (1 if i < 2 else 2)
            after = dict(model.named_parameters())
            if not applied:  # skipped: nothing moved
                for n, p in after.items():
                    assert torch.equal(p, before[n])
                continue
            assert abs(float(loss) - float(jloss)) <= 2 * u * abs(float(jloss))
            jmoved = jax.tree_util.tree_map(lambda a, b: a - b, params, jparams_before)
            moved = {n: after[n].detach() - before[n] for n in after}
            assert tree_err_of_max(moved, convert.from_flax_params(jax.device_get(jmoved))) <= 8 * u


def test_comms_bytes_follow_the_store_dtypes():
    model = MLP(12, (16,), 5, device='cpu')
    reg = registry.register_model(model, device='cpu')
    reports = {}
    with bench_lm.one_rank_world(torch.device('cpu')):
        for dt in (torch.float32, torch.bfloat16):
            for method in ('allreduce', 'allreduce_bucketed'):
                engine = DistributedKFAC(KFACPreconditioner(
                    reg, factor_dtype=dt, inv_dtype=dt, device='cpu', allreduce_method=method,
                ))
                reports[dt, method] = engine.comms_report()
    for method in ('allreduce', 'allreduce_bucketed'):
        full, half = reports[torch.float32, method], reports[torch.bfloat16, method]
        assert half['stat_transport']['wire_dtype'] == 'bfloat16'
        assert 2 * half['stat_transport']['bytes'] == full['stat_transport']['bytes']
        assert 2 * half['grad_broadcast_bytes'] == full['grad_broadcast_bytes']
        assert 2 * half['decomp_reshard_bytes'] == full['decomp_reshard_bytes']
        assert 2 * half['padding_totals']['resident_bytes'] == full['padding_totals']['resident_bytes']


def test_half_precision_stores_refuse_the_knobs_not_ported_with_them():
    reg = registry.register_model(MLP(12, (16,), 5, device='cpu'), device='cpu')
    with pytest.raises(NotImplementedError, match='async_inverse'):
        KFACPreconditioner(reg, factor_dtype=torch.bfloat16, async_inverse='sliced',
                           inv_update_steps=2, device='cpu')
    with pytest.raises(ValueError, match='factor_dtype'):
        KFACPreconditioner(reg, factor_dtype=torch.float64, device='cpu')
    with pytest.raises(NotImplementedError, match='ring attention'):
        TransformerLM(**LM_CFG, device='cpu', dtype=torch.bfloat16, num_experts=2)


# ---------------------------------------------------------------- example


def test_train_amp_example_skips_real_overflows_on_the_cpu():
    loss, skipped, kfac_steps = train_amp.main([
        '--device', 'cpu', '--steps', '2', '--batch-size', '4', '--init-scale', str(2.0**24),
    ])
    assert skipped >= 1 and kfac_steps == 2 - skipped and np.isfinite(loss)


def test_bench_lm_reads_mfu_against_the_peak_of_its_dtype():
    assert bench_lm.default_dtype(torch.device('cpu')) == torch.float32
    assert bench_lm.default_dtype(torch.device('cuda')) == torch.bfloat16
    assert bench_lm.PEAK_FLOPS[torch.bfloat16][0] == 989e12
    assert bench_lm.PEAK_FLOPS[torch.float32][0] == 67e12
    record = bench_lm.run_lm_stage('tiny', 'cpu', warmup=0, iters=1, scan_steps=1, probes=False)
    assert record['dtype'] == 'float32' and record['mfu'] is None
