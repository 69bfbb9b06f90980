"""The port's TransformerLM, registry and curvature capture against the
JAX package, at a small size: batch 2, seq 32, d_model 64, 2 layers, 4
heads, vocab 128. Flax weights carry over with ``from_flax_params``.

Tolerances: rtol 1e-5 with atol 1e-6 x max|reference| for logits and
loss; parameter gradients the same with the max taken over the whole
gradient, since some are zero up to rounding (a key bias shifts every
logit of a row alike, so softmax cancels its gradient); A and G factors
rtol 1e-5 relative to each factor's max (G comes from cotangents of a
mean loss and is tiny in absolute terms).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.models import attention
from kfac_tpu.models import attention as jattention

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

CFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_len=32)


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want)))
    )


def close_grads(got, flax_grads):
    want = convert.from_flax_params(jax.device_get(flax_grads))
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6 * scale,
            err_msg=name,
        )


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG['vocab_size'], (2, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jmodel = JaxLM(**CFG)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params']
    tmodel = TransformerLM(**CFG, device='cpu')
    tmodel.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    batch_j = (jnp.asarray(tokens), jnp.asarray(targets))
    batch_t = (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    return jmodel, params, batch_j, tmodel, batch_t


def test_from_flax_params_covers_every_parameter(setup):
    _, params, _, tmodel, _ = setup
    sd = convert.from_flax_params(jax.device_get(params))
    assert set(sd) == set(dict(tmodel.named_parameters()))
    assert sd['block0.attn.q_proj.weight'].shape == (64, 64)
    np.testing.assert_array_equal(
        sd['block1.mlp_up.weight'].numpy(),
        np.asarray(params['block1']['mlp_up']['kernel']).T,
    )


def test_logits_loss_and_grads_match_flax(setup):
    jmodel, params, batch_j, tmodel, batch_t = setup
    close(tmodel(batch_t[0]), jmodel.apply({'params': params}, batch_j[0]))
    jloss, jgrads = jax.value_and_grad(jax_lm_loss(jmodel))(params, batch_j)
    tloss, tgrads = capture.value_and_grad(tmodel, lm_loss(tmodel))(batch_t)
    close(tloss, jloss)
    close_grads(tgrads, jgrads)


def test_dense_causal_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32) for _ in range(3))
    got = attention.dense_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    close(got, jattention.dense_causal_attention(*(jnp.asarray(x) for x in (q, k, v))))


def test_registry_names_match_jax(setup):
    jmodel, _, batch_j, tmodel, _ = setup
    jreg = kfac_tpu.register_model(jmodel, batch_j[0], skip_layers=['lm_head'])
    treg = registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu')
    assert treg.names() == jreg.names()
    for name in treg.names():
        assert treg.layers[name].a_factor_shape == jreg.layers[name].a_factor_shape
        assert treg.layers[name].g_factor_shape == jreg.layers[name].g_factor_shape


def test_capture_factors_and_grads_match_jax(setup):
    jmodel, params, batch_j, tmodel, batch_t = setup
    jreg = kfac_tpu.register_model(jmodel, batch_j[0], skip_layers=['lm_head'])
    (jloss, _), jgrads, jstats = kfac_tpu.CurvatureCapture(jreg).value_stats_and_grad(
        jax_lm_loss(jmodel)
    )(params, batch_j)
    treg = registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu')
    (tloss, aux), tgrads, tstats = capture.CurvatureCapture(treg).value_stats_and_grad(
        lm_loss(tmodel)
    )(batch_t)
    assert aux is None
    close(tloss, jloss)
    assert sorted(tstats.a) == sorted(jstats.a) == sorted(treg.names())
    for name in treg.names():
        close(tstats.a[name], jstats.a[name])
        close(tstats.g[name], jstats.g[name])
        assert torch.equal(tstats.a[name], tstats.a[name].T)
    close_grads(tgrads, jgrads)


def test_capture_hooks_live_only_inside_the_call(setup):
    *_, tmodel, batch_t = setup
    treg = registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu')
    run = capture.CurvatureCapture(treg).value_stats_and_grad(lm_loss(tmodel))
    run(batch_t)
    for mod in treg.modules.values():
        assert not mod._forward_pre_hooks and not mod._forward_hooks


def test_capture_divides_repeated_calls():
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 3)
    model = torch.nn.Sequential(lin)
    treg = registry.register_model(model, device='cpu')
    x1, x2 = torch.randn(5, 6), torch.randn(5, 6)
    (_, _), _, stats = capture.CurvatureCapture(treg).value_stats_and_grad(
        lambda: (model(x1).sum() + model(x2).pow(2).sum())
    )()
    from kfac_tpu_torch.ops import cov

    want = (cov.linear_a_factor(x1, True) + cov.linear_a_factor(x2, True)) / 2
    close(stats.a['0'], want.numpy())
    g1 = torch.ones(5, 3)
    g2 = 2 * model(x2).detach()
    close(stats.g['0'], ((cov.get_cov(g1) + cov.get_cov(g2)) / 2).numpy())


def test_merge_of_chunk_partials_matches_jax():
    # two K-chunks attended separately and merged equal the JAX merge
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 16, 4, 16)).astype(np.float32) for _ in range(3))
    k2, v2 = (rng.standard_normal((2, 16, 4, 16)).astype(np.float32) for _ in range(2))
    from kfac_tpu.ops import pallas_attention as jpa
    from kfac_tpu_torch.ops import flash_attention

    def parts(lib, conv, qq, kk, vv, k_off):
        return lib(*(conv(x) for x in (qq, kk, vv)), 16, k_off, True)

    t = torch.from_numpy
    got = attention._finish(attention._merge(
        parts(flash_attention.attend_partials_einsum, t, q, k, v, 0),
        parts(flash_attention.attend_partials_einsum, t, q, k2, v2, 16),
    ))
    want = jattention._finish(jattention._merge(
        parts(jpa.attend_partials_einsum, jnp.asarray, q, k, v, 0),
        parts(jpa.attend_partials_einsum, jnp.asarray, q, k2, v2, 16),
    ))
    close(got, want)


def test_capture_has_aux_returns_the_aux_value(setup):
    *_, tmodel, batch_t = setup
    treg = registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu')
    loss = lm_loss(tmodel)
    (l1, aux), _, _ = capture.CurvatureCapture(treg).value_stats_and_grad(
        lambda b: (loss(b), {'tokens': b[0].numel()}), has_aux=True
    )(batch_t)
    assert aux == {'tokens': 64}
    assert torch.equal(l1, loss(batch_t).detach())
