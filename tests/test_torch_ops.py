"""The port's kernel modules and numerics against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages. The
JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's side runs its wrappers on CPU tensors, which take the plain
versions. f32 tolerance: rtol 1e-5, atol 1e-6 x max|reference| (the two
frameworks sum in different orders). The kernels themselves are held
against their plain versions on the card in ``test_torch_kernels.py``.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_tpu.ops import cov as jcov
from kfac_tpu.ops import factors as jfactors
from kfac_tpu.ops import losses as jlosses
from kfac_tpu.ops import pallas_attention as jpa
from kfac_tpu.ops import pallas_cov as jpallas_cov
from kfac_tpu.ops import pallas_cov_ema as jpallas_cov_ema
from kfac_tpu.ops import pallas_ns as jpallas_ns
from kfac_tpu_torch.ops import cov, cov_ema, factors, flash_attention, klclip, losses
from kfac_tpu_torch.ops import newton_schulz as ns_lib
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

NEG_INF = -1e30


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ------------------------------------------------------------------ sym_cov


@pytest.mark.parametrize('shape,scale', [((64, 40), None), ((300, 130), 7.0)])
def test_sym_cov_plain_matches_pallas_interpret(shape, scale):
    a = rand(0, *shape)
    want = jpallas_cov.sym_cov(jnp.asarray(a), scale=scale, interpret=True)
    got = sym_cov_lib.sym_cov(t(a), scale)
    close(got, want)
    # exactly symmetric, as the TPU kernel is
    assert torch.equal(got, got.T)


def kernel_pair_of(t, nblk):
    """sym_cov_tc_kernel's pair_of (csrc/sym_cov.cu): tile pair of CTA
    column t."""
    bi = 0
    while t >= nblk - bi:
        t -= nblk - bi
        bi += 1
    return bi, bi + t


@pytest.mark.parametrize('n', [77, 512, 8192])
@pytest.mark.parametrize('d', [129, 130, 512, 513, 2048, 2049])
@pytest.mark.parametrize('sms', [132, 16])
def test_sym_cov_plan_covers_each_pair_and_row_once(n, d, sms):
    p = sym_cov_lib.plan(n, d, sms)
    tile = sym_cov_lib.TILE
    assert p.rows_per_split % sym_cov_lib.SLAB_ROWS == 0  # the launcher's check
    # the kernel's grid is (p.pairs, p.splits); CTA (x, y) takes tile pair
    # pair_of(x) and rows [y * rows_per_split, min(n, (y + 1) * rows_per_split))
    pairs = [kernel_pair_of(x, p.nblk) for x in range(p.pairs)]
    assert sorted(pairs) == [(i, j) for i in range(p.nblk) for j in range(i, p.nblk)]
    assert (p.nblk - 1) * tile < d <= p.nblk * tile
    rows = np.zeros(n, np.int64)
    for y in range(p.splits):
        begin, end = y * p.rows_per_split, min(n, (y + 1) * p.rows_per_split)
        assert begin < end  # no slice is empty
        rows[begin:end] += 1
    assert (rows == 1).all()
    # the reduce pass reads splits * pairs tiles of partials
    assert p.scratch_bytes == 4 * p.splits * p.pairs * tile**2 * (p.splits > 1)
    # no fewer slices fill the waves; at most one slice per slab
    fill = [sym_cov_lib.wave_fill(p.pairs * s, sms) for s in range(1, p.splits)]
    assert all(f < sym_cov_lib.MIN_WAVE_FILL for f in fill)
    assert p.splits <= -(-n // sym_cov_lib.SLAB_ROWS)
    if n == 8192 and sms == 132:  # the flagship's factors on an H100
        assert p.splits == {129: 64, 130: 64, 512: 14, 513: 11, 2048: 1, 2049: 6}[d]
    if n <= 512:  # the tiny bench's factors: one slice
        assert p.splits == 1


@pytest.mark.parametrize('n,splits', [(32, 1), (512, 1), (513, 17), (544, 17), (1024, 32)])
def test_sym_cov_plan_splits_only_past_sixteen_slabs(n, splits):
    # at most 16 slabs of 32 rows stay whole; past that the wave rule's
    # split: 6 tile pairs at d = 130 would need 80 slices to fill 132 SMs'
    # 528 slots, so each slab is a slice
    assert sym_cov_lib.MAX_UNSPLIT_SLABS == 16
    p = sym_cov_lib.plan(n, 130, 132)
    assert p.splits == splits
    assert p == (sym_cov_lib.wave_plan(n, 130, 132) if splits > 1 else
                 sym_cov_lib.CovPlan(n, 130, 1, -(-n // 32) * 32))


def test_sym_cov_wrapper_takes_plain_on_cpu_without_launching():
    a = t(rand(1, 50, 33))
    before = sym_cov_lib.sym_cov.launches
    assert torch.equal(sym_cov_lib.sym_cov(a), sym_cov_lib.sym_cov_plain(a))
    assert sym_cov_lib.sym_cov.launches == before


def test_get_cov_matches_jax():
    a, b = rand(2, 48, 20), rand(3, 48, 20)
    close(cov.get_cov(t(a)), jcov.get_cov(jnp.asarray(a)))
    close(cov.get_cov(t(a), t(b), scale=5.0),
          jcov.get_cov(jnp.asarray(a), jnp.asarray(b), scale=5.0))
    got = cov.get_cov(t(a))
    assert torch.equal(got, got.T)


@pytest.mark.parametrize('has_bias', [True, False])
def test_linear_factors_match_jax(has_bias):
    a, g = rand(4, 2, 16, 24), rand(5, 2, 16, 12) * 1e-4
    close(cov.linear_a_factor(t(a), has_bias),
          jcov.linear_a_factor(jnp.asarray(a), has_bias))
    close(cov.linear_g_factor(t(g)), jcov.linear_g_factor(jnp.asarray(g)))
    close(cov.append_bias_ones(t(a)), jcov.append_bias_ones(jnp.asarray(a)))


# ------------------------------------------------------------------ cov+EMA


def sym_factor(seed, d):
    f = rand(seed, d, d)
    return 0.5 * (f + f.T)  # the running factor is symmetric by contract


@pytest.mark.parametrize(
    'n,d', [(512, 256), (640, 192), (1000, 200)], ids=['probe', 'padding', 'split']
)
def test_sym_cov_ema_plain_matches_pallas_interpret(n, d):
    if n == 1000:  # ragged N and D that the card's plan splits
        assert sym_cov_lib.plan(n, d, 132).splits > 1
    a, f = rand(20, n, d), sym_factor(21, d)
    beta, coeff = 0.95, 0.05 / n
    want = jpallas_cov_ema._fused(jnp.asarray(f), jnp.asarray(a), beta, coeff, interpret=True)
    got = cov_ema.sym_cov_ema(t(f), t(a), beta, coeff)
    assert got.dtype == torch.float32 and torch.equal(got, got.T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the unfused pair is the second oracle
    unfused = jfactors.ema_update(jnp.asarray(f), jcov.get_cov(jnp.asarray(a), scale=n), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(unfused), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('running', [False, True], ids=['cold-start', 'running'])
def test_fused_cov_ema_matches_jax(running):
    a = rand(22, 96, 40)
    f = sym_factor(23, 40) if running else None
    want = jpallas_cov_ema.fused_cov_ema(
        None if f is None else jnp.asarray(f), jnp.asarray(a), 0.95, scale=7.0
    )
    got = cov_ema.fused_cov_ema(None if f is None else t(f), t(a), 0.95, scale=7.0)
    close(got, want)
    assert torch.equal(got, got.T)
    assert got.dtype == torch.float32


def test_fused_cov_ema_promotes_dtype_and_does_not_launch_on_cpu():
    a = t(rand(24, 30, 12))
    before = cov_ema.sym_cov_ema.launches
    out = cov_ema.fused_cov_ema(torch.eye(12, dtype=torch.float64), a, 0.9)
    assert out.dtype == torch.float64
    f = t(sym_factor(25, 12))
    assert torch.equal(
        cov_ema.sym_cov_ema(f, a, 0.9, 0.1 / 30), cov_ema.sym_cov_ema_plain(f, a, 0.9, 0.1 / 30)
    )
    assert cov_ema.sym_cov_ema.launches == before
    with pytest.raises(ValueError):
        cov_ema.sym_cov_ema(torch.eye(11), a, 0.9, 0.1)


# ------------------------------------------------------------------- kl-clip


@pytest.mark.parametrize('shape', [(40, 70), (130, 65)])
def test_klclip_dot_plain_matches_pallas_interpret(shape):
    p, g = rand(6, *shape), rand(7, *shape)
    want = jpallas_ns.fused_klclip_dot(jnp.asarray(p), jnp.asarray(g), interpret=True)
    got = klclip.klclip_dot(t(p), t(g))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(
        float(got), float(want), rtol=1e-5, atol=1e-6 * float(np.sum(np.abs(p * g)))
    )


@pytest.mark.parametrize('shape', [(40, 70), (130, 65)])
def test_klclip_scale_plain_matches_pallas_interpret(shape):
    p = rand(8, *shape)
    s = np.float32(0.37)
    want = jpallas_ns.fused_klclip_scale(jnp.asarray(p), jnp.asarray(s), interpret=True)
    got = klclip.klclip_scale(t(p), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_klclip_wrappers_do_not_launch_on_cpu():
    p = t(rand(9, 8, 8))
    before = (klclip.klclip_dot.launches, klclip.klclip_scale.launches)
    klclip.klclip_dot(p, p)
    klclip.klclip_dot_many([p, p], [p, p], 0.1, 0.001)
    klclip.klclip_scale(p, torch.tensor(2.0))
    klclip.klclip_scale_many([p, p], torch.tensor(2.0))
    assert (klclip.klclip_dot.launches, klclip.klclip_scale.launches) == before


# layer sets of the grouped dot: (shapes, lr, kl_clip, how g is made). The
# zero grads give vg_sum 0 (scale 1); 1e-9 binds (scale well under 1); a
# NaN in one p carries through to vg_sum and the scale.
GROUPED_SETS = {
    'mixed': ([(12, 7), (5, 3), (40, 65), (1, 9)], 0.1, 1e3, 'random'),
    'zero_grads': ([(12, 7), (33, 4)], 0.1, 0.001, 'zeros'),
    'binding': ([(40, 65), (8, 129), (3, 3)], 0.3, 1e-9, 'random'),
    'nan': ([(12, 7), (6, 5)], 0.1, 0.001, 'nan'),
}


def grouped_inputs(name):
    shapes, lr, kl_clip, kind = GROUPED_SETS[name]
    ps = [rand(60 + i, *s) for i, s in enumerate(shapes)]
    gs = [rand(70 + i, *s) if kind != 'zeros' else np.zeros(s, np.float32)
          for i, s in enumerate(shapes)]
    if kind == 'nan':
        ps[1][2, 3] = np.nan
    return ps, gs, lr, kl_clip


@pytest.mark.parametrize('name', list(GROUPED_SETS))
def test_klclip_dot_many_plain_matches_jax_terms_sum_and_scale(name):
    ps, gs, lr, kl_clip = grouped_inputs(name)
    jterms = [jfactors.kl_clip_terms(jnp.asarray(p), jnp.asarray(g), lr) for p, g in zip(ps, gs)]
    jvg = sum(jterms)
    jscale = jfactors.kl_clip_scale(jvg, kl_clip)
    before = klclip.klclip_dot.launches
    terms, vg, scale = klclip.klclip_dot_many([t(p) for p in ps], [t(g) for g in gs], lr, kl_clip)
    assert klclip.klclip_dot.launches == before  # plain on the CPU
    assert terms.shape == (len(ps),) and vg.shape == () and scale.shape == ()
    # signed sums: the error scales with lr^2 sum|p*g|, not with the result
    atol = 1e-6 * lr ** 2 * float(np.nansum(np.abs(np.concatenate(
        [(p * g).ravel() for p, g in zip(ps, gs)]))))
    np.testing.assert_allclose(terms.numpy(), np.asarray(jterms), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(vg), float(jvg), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-5)
    if name == 'zero_grads':
        assert float(vg) == 0.0 and float(scale) == 1.0
    if name == 'binding':
        assert float(scale) < 0.1
    if name == 'nan':
        assert np.isnan(float(vg)) and np.isnan(float(scale))


def test_klclip_dot_many_raises_on_mismatched_pairs():
    p, q = t(rand(80, 4, 5)), t(rand(81, 4, 5))
    with pytest.raises(ValueError, match='one or more pairs'):
        klclip.klclip_dot_many([p, p], [q], 0.1, 0.001)
    with pytest.raises(ValueError, match='one or more pairs'):
        klclip.klclip_dot_many([], [], 0.1, 0.001)
    with pytest.raises(ValueError, match='shape mismatch'):
        klclip.klclip_dot_many([p, p], [q, q[:3]], 0.1, 0.001)
    with pytest.raises(ValueError, match='one device'):
        klclip.klclip_dot_many([p, p], [q, torch.empty(4, 5, device='meta')], 0.1, 0.001)
    with pytest.raises(ValueError, match='cuda or cpu'):
        meta = torch.empty(4, 5, device='meta')
        klclip.klclip_dot_many([meta], [meta], 0.1, 0.001)


# ragged shapes, one under a TPU tile, an empty one and a 1-D one
SCALE_SHAPES = [(40, 70), (130, 65), (3, 5), (0, 9), (257,)]


def test_klclip_scale_many_plain_matches_pallas_interpret():
    ps = [rand(10 + i, *shape) for i, shape in enumerate(SCALE_SHAPES)]
    s = np.float32(0.37)
    got = klclip.klclip_scale_many([t(p) for p in ps], torch.tensor(s))
    assert len(got) == len(ps)
    for p, g in zip(ps, got):
        assert g.shape == p.shape
        if p.size == 0:  # the TPU wrapper pads to whole tiles: nothing to hold
            continue
        p2 = p if p.ndim == 2 else p.reshape(1, -1)  # it takes 2-D arrays
        want = jpallas_ns.fused_klclip_scale(jnp.asarray(p2), jnp.asarray(s), interpret=True)
        np.testing.assert_array_equal(g.numpy().reshape(p2.shape), np.asarray(want))


def test_klclip_scale_many_scales_in_place_on_request():
    ps = [t(rand(20, 6, 4)), t(rand(21, 9))]
    s = torch.tensor(0.5)
    want = klclip.klclip_scale_many_plain(ps, s)
    fresh = klclip.klclip_scale_many(ps, s)
    assert all(x is not p for x, p in zip(fresh, ps))
    same = klclip.klclip_scale_many(ps, s, in_place=True)  # as the engine runs it
    assert len(same) == len(ps) and all(x is p for x, p in zip(same, ps))
    assert all(torch.equal(x, w) and torch.equal(f, w) for x, f, w in zip(ps, fresh, want))
    assert klclip.klclip_scale_many([], s) == []


# ----------------------------------------------------------------- attention


def close_partials(got, want):
    acc, m, l = (x.detach().numpy() for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    close(acc, wacc)
    close(l, wl)
    masked = wm <= NEG_INF / 2
    np.testing.assert_array_equal(m[masked], wm[masked])
    close(m[~masked], wm[~masked])


@pytest.mark.parametrize(
    'q_off,k_off,causal',
    [(0, 0, True), (32, 0, True), (16, 8, True), (0, 32, True), (0, 0, False)],
    ids=['dense', 'past-chunk', 'offsets', 'fully-masked', 'noncausal'],
)
def test_flash_partials_match_pallas_interpret(q_off, k_off, causal):
    q, k, v = (rand(10 + i, 2, 32, 4, 16) for i in range(3))
    want = jpa.flash_attention_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_off,
        k_offset=k_off, causal=causal, block_q=16, block_k=16, interpret=True,
    )
    got = flash_attention.flash_attention_partials(t(q), t(k), t(v), q_off, k_off, causal)
    close_partials(got, want)
    close_partials(
        flash_attention.attend_partials_einsum(t(q), t(k), t(v), q_off, k_off, causal),
        jpa.attend_partials_einsum(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off, causal
        ),
    )


@pytest.mark.parametrize(
    'q_off,k_off', [(0, 0), (16, 8), (0, 32)], ids=['dense', 'offsets', 'fully-masked']
)
def test_flash_partials_match_pallas_interpret_at_head_dim_256(q_off, k_off):
    # the `large` LM's head dim (the JAX kernel takes whole blocks of S)
    q, k, v = (rand(30 + i, 1, 32, 2, 256) for i in range(3))
    want = jpa.flash_attention_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_off,
        k_offset=k_off, causal=True, block_q=16, block_k=16, interpret=True,
    )
    assert 256 in flash_attention.HEAD_DIMS
    got = flash_attention.flash_attention_partials(t(q), t(k), t(v), q_off, k_off, True)
    close_partials(got, want)


def test_flash_tiles_first_candidates_are_the_built_tiles():
    from kfac_tpu_torch import flash_tiles
    from kfac_tpu_torch.ops import build

    src = (build.CSRC / 'flash_attn.cu').read_text()
    built = {d: c[0] for d, c in flash_tiles.CANDIDATES.items()}
    assert flash_tiles.variant_source(src, built) == src
    assert set(built) == set(flash_attention.HEAD_DIMS)
    assert flash_tiles.variant_source(src, {128: (8, 64)}) != src


def test_flash_partials_backward_matches_jax_vjp():
    import jax

    q, k, v = (rand(20 + i, 2, 32, 4, 16) for i in range(3))
    cts = (rand(23, 2, 32, 4, 16), rand(24, 2, 4, 32), rand(25, 2, 4, 32))
    _, pull = jax.vjp(
        lambda a, b, c: jpa.flash_attention_partials(
            a, b, c, 8, 0, True, block_q=16, block_k=16, interpret=True
        ),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = pull(tuple(jnp.asarray(c) for c in cts))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention.flash_attention_partials(tq, tk, tv, 8, 0, True)
    got = torch.autograd.grad(out, (tq, tk, tv), tuple(t(c) for c in cts))
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------------- factors


def spd(seed, n):
    x = rand(seed, 4 * n, n)
    return (x.T @ x / (4 * n)).astype(np.float32)


def test_ema_update_matches_jax():
    f, new = spd(30, 12), spd(31, 12)
    close(factors.ema_update(t(f), t(new), 0.95),
          jfactors.ema_update(jnp.asarray(f), jnp.asarray(new), 0.95))
    close(factors.ema_update(None, t(new), 0.9),
          jfactors.ema_update(None, jnp.asarray(new), 0.9))


def test_compute_eigh_matches_jax_through_reconstruction():
    # eigenvectors are defined only up to sign and rotation: compare
    # eigenvalues and Q diag(d) Q^T
    f = spd(32, 20)
    got = factors.compute_eigh(t(f))
    want = jfactors.compute_eigh(jnp.asarray(f))
    close(got.d, want.d, rtol=1e-4, atol_rel=1e-5)
    rec = got.q @ torch.diag(got.d) @ got.q.T
    wrec = np.asarray(want.q) @ np.diag(np.asarray(want.d)) @ np.asarray(want.q).T
    close(rec, wrec, rtol=1e-4, atol_rel=1e-5)


def nonfinite_factor(kind):
    f = spd(33, 64)
    if kind == 'nan_pair':
        f[3, 5] = f[5, 3] = np.nan
    elif kind == 'all_nan':
        f[:] = np.nan
    else:
        f[7, 7] = np.inf
    return f


@pytest.mark.parametrize('impl', ['device', 'host', 'eig_host'])
@pytest.mark.parametrize('kind', ['nan_pair', 'all_nan', 'inf'])
def test_compute_eigh_of_a_nonfinite_factor_is_nan_where_jax_is(kind, impl):
    # The JAX eigh returns NaN eigenvalues for a factor with one NaN pair
    # (63 of 64; one finite), all NaN or one inf (64), and NaN eigenvectors
    # but for one row, and does not raise. The port decomposes such a factor
    # to all NaN, chosen on the device (the card's eigh raises on it), so
    # every eigenvalue NaN in JAX's is NaN in the port's and the damped
    # inverse is all NaN in both: a refresh of such a factor poisons that
    # layer alike. A finite slot of the same stack is untouched.
    f = nonfinite_factor(kind)
    got = factors.compute_eigh(t(f), impl)
    want = jfactors.compute_eigh(jnp.asarray(f))
    jd, jq = np.asarray(want.d), np.asarray(want.q)
    assert int(np.isnan(jd).sum()) == (63 if kind == 'nan_pair' else 64)
    assert int(np.isnan(jq).sum()) >= 63 * 64
    assert bool(torch.isnan(got.d).all()) and bool(torch.isnan(got.q).all())
    assert bool(torch.isnan((got.q / (got.d + 0.01)) @ got.q.T).all())
    assert np.isnan((jq / (jd + 0.01)) @ jq.T).all()
    stack = torch.stack([t(f), t(spd(34, 64))])
    d, q = factors.batched_eigh(stack, impl)
    jd1, _ = jfactors.batched_eigh(jnp.asarray(spd(34, 64))[None], 'xla')
    assert bool(torch.isnan(d[0]).all()) and bool(torch.isfinite(d[1]).all() and torch.isfinite(q[1]).all())
    close(d[1], np.asarray(jd1)[0], rtol=1e-4, atol_rel=1e-5)


@pytest.mark.parametrize('impl,jimpl', [('device', 'xla'), ('host', 'host'), ('eig_host', 'eig_host')])
def test_batched_eigh_matches_jax(impl, jimpl):
    """Each ``impl`` on a (3, 12, 12) stack against the JAX function's: the
    host forms call the same LAPACK routine on the same f32 input, so
    eigenvalues and eigenvectors are equal to rounding; the device form by
    its eigenvalues and reconstruction."""
    f = np.stack([spd(40 + k, 12) for k in range(3)])
    d, q = factors.batched_eigh(t(f), impl)
    jd, jq = jfactors.batched_eigh(jnp.asarray(f), jimpl)
    assert d.dtype == q.dtype == torch.float32 and q.shape == (3, 12, 12)
    close(d, jd, rtol=1e-4, atol_rel=1e-5)
    if impl == 'device':
        rec = q @ torch.diag_embed(d) @ q.transpose(-1, -2)
        close(rec, f, rtol=1e-4, atol_rel=1e-5)
    else:
        close(q, jq, rtol=1e-5, atol_rel=1e-5)
    dec = factors.compute_eigh(t(f[0]), impl)
    jdec = jfactors.compute_eigh(jnp.asarray(f[0]), impl=jimpl)
    close(dec.d, jdec.d, rtol=1e-4, atol_rel=1e-5)


def test_batched_eigh_upcasts_and_rejects_as_jax():
    f = spd(44, 8)
    for impl in ('device', 'host', 'eig_host'):
        d, _ = factors.batched_eigh(t(f).to(torch.bfloat16), impl)
        assert d.dtype == torch.float32
        close(d, np.linalg.eigvalsh(f.astype(np.float64)), rtol=2e-2, atol_rel=2e-2)
        with pytest.raises(TypeError, match='real floating'):
            factors.batched_eigh(torch.ones(3, 3, dtype=torch.int32), impl)
    with pytest.raises(ValueError, match='unknown eigh impl'):
        factors.batched_eigh(t(f), 'xla')


def test_compute_inverse_matches_jax():
    f = spd(33, 16)
    close(factors.compute_inverse(t(f), 0.003),
          jfactors.compute_inverse(jnp.asarray(f), 0.003), rtol=1e-4)
    close(factors.damped_inverse(t(f), 0.01, solver='cholesky'),
          jfactors.damped_inverse(jnp.asarray(f), 0.01, solver='cholesky'), rtol=1e-4)


# a damped factor that is not positive definite: eigenvalues 3 and -1
NOT_PD = np.float32([[1.0, 2.0], [2.0, 1.0]])


def test_compute_inverse_of_a_non_pd_factor_is_all_nan_as_in_jax():
    want = np.asarray(jfactors.compute_inverse(jnp.asarray(NOT_PD), 0.003))
    got = factors.compute_inverse(t(NOT_PD), 0.003)
    assert np.isnan(want).all() and torch.isnan(got).all()
    # a larger factor failing late in the factorization: all NaN as well
    f = spd(34, 12)
    f[-1, -1] = -5.0
    want = np.asarray(jfactors.compute_inverse(jnp.asarray(f), 0.003))
    got = factors.compute_inverse(t(f), 0.003)
    assert np.isnan(want).all() and torch.isnan(got).all()
    # a tensor damping (the health path's) takes the same path
    assert torch.isnan(factors.compute_inverse(t(NOT_PD), torch.tensor(0.003))).all()
    # the PD case is unchanged (rtol 1e-4, as test_compute_inverse_matches_jax)
    f = spd(35, 12)
    close(factors.compute_inverse(t(f), torch.tensor(0.003)),
          jfactors.compute_inverse(jnp.asarray(f), 0.003), rtol=1e-4)


def test_non_pd_factor_under_cholesky_rolls_back_with_jax_health_counters():
    """INVERSE + Cholesky with the sentinel on: a layer whose damped factor is
    not PD gets NaN inverses, rolled back to its previous ones, and its
    ``bad_inv`` counts up, in both packages; the other layer refreshes."""
    import kfac_tpu
    from kfac_tpu import health as jhealth
    from kfac_tpu.models import MLP as FlaxMLP
    from kfac_tpu_torch import convert, health
    from kfac_tpu_torch.layers import registry
    from kfac_tpu_torch.models import MLP
    from kfac_tpu_torch.preconditioner import KFACPreconditioner

    opts = dict(damping=0.003, compute_method='inverse', inverse_solver='cholesky')
    jk = kfac_tpu.KFACPreconditioner(
        registry=kfac_tpu.register_model(FlaxMLP(features=(8,), num_classes=5), jnp.zeros((2, 6))),
        health=jhealth.HealthConfig(warn=False), **opts,
    )
    tk = KFACPreconditioner(
        registry.register_model(MLP(6, (8,), 5, device='cpu'), device='cpu'),
        health=health.HealthConfig(warn=False), device='cpu', **opts,
    )
    js = jk.update_inverses(jk.init())  # a healthy refresh of the identities first
    ts = convert.from_jax_kfac_state(js, tk)
    bad = spd(36, 9)
    bad[0, 0] = -4.0
    good = spd(37, 8)
    js = js._replace(a={**js.a, 'head': jnp.asarray(bad)}, g={**js.g, 'dense0': jnp.asarray(good)})
    ts = tk.insert_factors(ts, {'head': {'a': t(bad), 'g': ts.g['head']},
                                'dense0': {'a': ts.a['dense0'], 'g': t(good)}})
    ts0 = ts
    for _ in range(2):
        js2, ts2 = jk.update_inverses(js), tk.update_inverses(ts)
        for field in ('bad_inv', 'quarantined', 'quarantine_events', 'damping_mult'):
            want = [np.asarray(getattr(js2.health, field)[n]) for n in ('dense0', 'head')]
            np.testing.assert_array_equal(getattr(ts2.health, field).numpy(), want, err_msg=field)
        for side in ('a_inv', 'g_inv'):
            for n in ('dense0', 'head'):
                close(getattr(ts2, side)[n], getattr(js2, side)[n], rtol=1e-4)
        # the head's inverses are the previous ones
        assert torch.equal(ts2.a_inv['head'], ts.a_inv['head'])
        js, ts = js2, ts2
    assert ts.health.bad_inv.tolist() == [0, 2]
    assert not torch.equal(ts.g_inv['dense0'], ts0.g_inv['dense0'])  # refreshed


# ------------------------------------------------------------ Newton-Schulz


def ns_start(seed, d):
    """A damped SPD ``m`` and its Gershgorin cold start ``x0``, as
    ``newton_schulz_inverse_info`` sets them up."""
    g = rand(seed, d, d)
    m = (g @ g.T / d + 0.1 * np.eye(d)).astype(np.float32)
    return m, (np.eye(d) / np.max(np.sum(np.abs(m), axis=1))).astype(np.float32)


def close_ns_step(got, want):
    # x and mx: rtol 1e-5, atol 1e-6 x max (d-long f32 sums in another
    # order); the residual: rtol 1e-5 (measured at <= 1.1e-6)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    assert got[2].shape == () and got[2].dtype == torch.float32
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


def test_fused_ns_step_plain_matches_pallas_interpret_over_three_iterations():
    m, x0 = ns_start(50, 256)
    jm, jx, tm, tx = jnp.asarray(m), jnp.asarray(x0), t(m), t(x0)
    jmx, tmx = jm @ jx, tm @ tx
    for _ in range(3):
        jx, jmx, jr = jpallas_ns.fused_ns_step(jm, jx, jmx, interpret=True)
        tx, tmx, tr = ns_lib.fused_ns_step(tm, tx, tmx)
        close_ns_step((tx, tmx, tr), (jx, jmx, jr))


@pytest.mark.parametrize('d', [130, 257])
def test_fused_ns_step_plain_matches_jax_unfused_body_at_ragged_d(d):
    # the TPU kernel takes only d % 128 == 0; ragged d ran the unfused body
    m, x = ns_start(51, d)
    mx = m @ x
    eye = jnp.eye(d, dtype=jnp.float32)
    jx_new = jnp.asarray(x) @ (2.0 * eye - jnp.asarray(mx))
    jmx_new = jnp.asarray(m) @ jx_new
    jr = jnp.linalg.norm(eye - jmx_new) / jnp.sqrt(jnp.asarray(d, jnp.float32))
    close_ns_step(ns_lib.fused_ns_step(t(m), t(x), t(mx)), (jx_new, jmx_new, jr))


@pytest.mark.parametrize('sms', [132, 114])
def test_ns_tile_plan_covers_every_width(sms):
    for d in range(1, 2101):
        tile = ns_lib.plan(d, sms)
        assert tile in ns_lib.TILES
        rows, cols = ns_lib.grid(d, tile)
        # the grid covers d, and its last row and column of tiles start inside d
        assert rows * tile[0] >= d > (rows - 1) * tile[0]
        assert cols * tile[1] >= d > (cols - 1) * tile[1]
        # of the two-warpgroup tiles that fill the card, one of the fewest
        # waves of tile area; else the one-warpgroup tile
        fills = [x for x in ns_lib.TILES[:-1] if math.prod(ns_lib.grid(d, x)) >= sms]

        def cost(x):
            return -(-math.prod(ns_lib.grid(d, x)) // sms) * x[0] * x[1]

        if fills:
            assert tile in fills and cost(tile) == min(map(cost, fills))
        else:
            assert tile == ns_lib.TILES[-1]
    if sms == 132:  # the flagship's factor widths on an H100
        assert ns_lib.plan(2048, sms) == (128, 128)
        assert ns_lib.plan(2049, sms) == (128, 144)
        assert ns_lib.plan(512, sms) == ns_lib.plan(513, sms) == (64, 32)


def test_fused_ns_step_checks_shapes_and_does_not_launch_on_cpu():
    m, x = ns_start(52, 8)
    before = ns_lib.fused_ns_step.launches
    got = ns_lib.fused_ns_step(t(m), t(x), t(m @ x))
    want = ns_lib.fused_ns_step_plain(t(m), t(x), t(m @ x))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ns_lib.fused_ns_step.launches == before
    with pytest.raises(ValueError):
        ns_lib.fused_ns_step(t(m), t(x)[:4], t(m @ x))
    with pytest.raises(ValueError):
        ns_lib.fused_ns_step(t(m)[:4], t(x)[:4], t(m @ x)[:4])


def ns_case(case):
    """(factor, x0) of each solver case."""
    if case == 'cold':
        return spd(53, 48), None
    if case == 'cold-ragged':
        return spd(54, 130), None
    if case == 'warm-accepted':
        # the inverse of a nearby factor: residual well below 0.5
        f = spd(55, 64)
        return f, np.asarray(jfactors.compute_inverse(jnp.asarray(1.05 * f), 0.003))
    if case == 'warm-rejected':
        # a fresh engine state: residual 1, so the cold start runs
        return spd(56, 64), np.zeros((64, 64), np.float32)
    f = spd(57, 16)
    f[3, 3] = np.nan
    return f, None


@pytest.mark.parametrize(
    'case', ['cold', 'cold-ragged', 'warm-accepted', 'warm-rejected', 'nan']
)
def test_newton_schulz_inverse_info_matches_jax(case):
    f, x0 = ns_case(case)
    want = jfactors.newton_schulz_inverse_info(
        jnp.asarray(f), 0.003, x0=None if x0 is None else jnp.asarray(x0)
    )
    got = factors.newton_schulz_inverse_info(
        t(f), 0.003, x0=None if x0 is None else t(x0)
    )
    assert got.inverse.dtype == torch.float32 and got.residual.shape == ()
    if case == 'nan':
        # the NaN residual fails the first loop test: no iteration, and the
        # NaN surfaces in the result
        assert got.iterations == int(want.iterations) == 0
        assert np.isnan(float(got.residual)) and np.isnan(float(want.residual))
        assert torch.isnan(got.inverse).all() and np.isnan(np.asarray(want.inverse)).all()
        return
    # every other case stops by tol (the iteration before the stop sits at
    # >= 2.6e-6, the stop at the f32 floor, <= 6e-7): iterations are equal
    assert float(want.residual) <= 1e-6 and float(got.residual) <= 1e-6
    assert got.iterations == int(want.iterations)
    if case == 'warm-accepted':
        assert got.iterations < 5  # the cold start takes 8
    # inverse within rtol 1e-4, atol 1e-5 x max (near the f32 floor the two
    # iterates differ by O(kappa eps)); both residuals at or below tol
    close(got.inverse, want.inverse, rtol=1e-4, atol_rel=1e-5)


def test_warm_start_outside_the_convergence_region_restarts_cold():
    # I - M x0 has one eigenvalue at -1.8 and the rest at -0.1: its RMS,
    # 0.25, passes the 0.5 safeguard, but the -1.8 direction diverges. The
    # JAX function stops at the first rise and returns that iterate; the
    # port reruns from the cold start and returns the JAX cold solve
    f = spd(60, 64).astype(np.float64)
    m = f + 0.003 * np.eye(64)
    mu, v = np.linalg.eigh(m)
    c = np.full(64, 1.1)
    c[-1] = 2.8
    x0 = ((v * (c / mu)) @ v.T).astype(np.float32)
    f = f.astype(np.float32)
    jwarm = jfactors.newton_schulz_inverse_info(jnp.asarray(f), 0.003, x0=jnp.asarray(x0))
    jcold = jfactors.newton_schulz_inverse_info(jnp.asarray(f), 0.003)
    assert float(jwarm.residual) > factors.NS_FALLBACK_RESIDUAL  # the reference's result
    starts = dict(factors.newton_schulz_inverse_info.starts)
    got = factors.newton_schulz_inverse_info(t(f), 0.003, x0=t(x0))
    assert factors.newton_schulz_inverse_info.starts['warm_restarted'] == starts['warm_restarted'] + 1
    # both runs stop by tol or by the rise on the warm side: counts add up
    assert float(got.residual) <= 1e-6 and float(jcold.residual) <= 1e-6
    assert got.iterations == int(jwarm.iterations) + int(jcold.iterations)
    close(got.inverse, jcold.inverse, rtol=1e-4, atol_rel=1e-5)


@pytest.mark.parametrize(
    'solver,case',
    [('newton_schulz', 'cold'), ('newton_schulz', 'warm'), ('auto', 'cold'),
     ('auto', 'to-cholesky')],
)
def test_damped_inverse_newton_schulz_and_auto_match_jax(solver, case):
    x0 = None
    if case == 'to-cholesky':
        # eigenvalues 1 .. 1e-14: 40 iterations leave the residual at 0.34,
        # far above NS_FALLBACK_RESIDUAL, so 'auto' re-solves by Cholesky
        f, damping = np.diag(np.logspace(0, -14, 32)).astype(np.float32), 0.0
    else:
        f, damping = spd(58, 40), 0.01
        if case == 'warm':
            x0 = np.asarray(jfactors.compute_inverse(jnp.asarray(0.97 * f), damping))
    before = factors.damped_inverse.cholesky_fallbacks
    got = factors.damped_inverse(t(f), damping, solver=solver, x0=None if x0 is None else t(x0))
    want = jfactors.damped_inverse(
        jnp.asarray(f), damping, solver=solver, x0=None if x0 is None else jnp.asarray(x0)
    )
    fell_back = factors.damped_inverse.cholesky_fallbacks - before
    assert fell_back == (case == 'to-cholesky')
    close(got, want, rtol=1e-4, atol_rel=1e-5)


def test_newton_schulz_differentiable_is_not_ported():
    with pytest.raises(NotImplementedError):
        factors.newton_schulz_inverse_info(t(spd(59, 4)), 0.01, differentiable=True)


def test_preconditioned_grads_match_jax():
    fa, fg = spd(35, 9), spd(36, 6)
    grad = rand(37, 6, 9)
    # one decomposition fed to both, so eigenvector freedom cannot differ
    ja = jfactors.compute_eigh(jnp.asarray(fa))
    jg = jfactors.compute_eigh(jnp.asarray(fg))
    ta = factors.EigenDecomp(t(np.asarray(ja.q)), t(np.asarray(ja.d)))
    tg = factors.EigenDecomp(t(np.asarray(jg.q)), t(np.asarray(jg.d)))
    close(factors.eigen_preconditioned_grad(t(grad), ta, tg, 0.003),
          jfactors.eigen_preconditioned_grad(jnp.asarray(grad), ja, jg, 0.003))
    close(factors.prediv_eigenvalues(ta, tg, 0.003),
          jfactors.prediv_eigenvalues(ja, jg, 0.003))
    ainv, ginv = np.linalg.inv(fa + np.eye(9)), np.linalg.inv(fg + np.eye(6))
    close(factors.inverse_preconditioned_grad(t(grad), t(ainv.astype(np.float32)),
                                              t(ginv.astype(np.float32))),
          jfactors.inverse_preconditioned_grad(jnp.asarray(grad),
                                               jnp.asarray(ainv, jnp.float32),
                                               jnp.asarray(ginv, jnp.float32)))


@pytest.mark.parametrize('vg', [0.0, 1e-6, 0.5, -3.0])
def test_kl_clip_scale_matches_jax_including_zero_guard(vg):
    got = factors.kl_clip_scale(torch.tensor(vg, dtype=torch.float32), 0.001)
    want = jfactors.kl_clip_scale(jnp.asarray(vg, jnp.float32), 0.001)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_kl_clip_terms_and_apply_match_jax():
    p, g = rand(38, 12, 7), rand(39, 12, 7)
    # a signed sum: its error scales with sum|p*g|, not with the result
    np.testing.assert_allclose(
        float(factors.kl_clip_terms(t(p), t(g), 0.1)),
        float(jfactors.kl_clip_terms(jnp.asarray(p), jnp.asarray(g), 0.1)),
        rtol=1e-5, atol=1e-6 * 0.01 * float(np.sum(np.abs(p * g))),
    )
    s = np.float32(0.25)
    close(factors.kl_clip_apply(t(p), torch.tensor(s)),
          jfactors.kl_clip_apply(jnp.asarray(p), jnp.asarray(s)))


def test_kl_clip_apply_many_matches_jax_per_layer_and_keeps_dtype():
    ps = [rand(40, 12, 7), rand(41, 5, 3)]
    s = np.float32(0.25)
    mixed = [t(ps[0]), t(ps[1]).to(torch.bfloat16)]
    got = factors.kl_clip_apply_many_(mixed, torch.tensor(s))
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16]
    assert got[0] is mixed[0]  # the f32 one in place
    close(got[0], jfactors.kl_clip_apply(jnp.asarray(ps[0]), jnp.asarray(s)))
    want = jfactors.kl_clip_apply(jnp.asarray(ps[1], jnp.bfloat16), jnp.asarray(s))
    np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(want, np.float32))


# -------------------------------------------------------------------- losses


def test_vocab_parallel_nll_matches_jax_with_grads():
    import jax

    logits = rand(40, 2, 8, 32) * 3
    targets = np.random.default_rng(41).integers(0, 32, (2, 8))
    want, pull = jax.vjp(
        lambda x: jlosses.vocab_parallel_nll(x, jnp.asarray(targets)),
        jnp.asarray(logits),
    )
    tl = t(logits).requires_grad_()
    got = losses.vocab_parallel_nll(tl, torch.from_numpy(targets))
    close(got, want)
    ct = rand(42, 2, 8)
    (gx,) = torch.autograd.grad(got, tl, t(ct))
    close(gx, pull(jnp.asarray(ct))[0])


# ------------------------------------------------- stacked Newton-Schulz


def test_fused_ns_step_stacked_plain_matches_jax_body_per_slot():
    # the stacked step's plain version against the JAX loop body vmapped
    # over slots: x and mx within rtol 1e-5, atol 1e-6 x max; residuals
    # rtol 1e-5; and the 2-D plain step of each slot
    slots = [ns_start(70 + i, 48) for i in range(3)]
    m = np.stack([s[0] for s in slots])
    x = np.stack([s[1] for s in slots])
    mx = m @ x
    eye = jnp.eye(48, dtype=jnp.float32)

    def body(mm, xx, mmx):
        x_new = xx @ (2.0 * eye - mmx)
        mx_new = mm @ x_new
        return x_new, mx_new, jnp.linalg.norm(eye - mx_new) / jnp.sqrt(48.0)

    want = jax.vmap(body)(jnp.asarray(m), jnp.asarray(x), jnp.asarray(mx))
    got = ns_lib.fused_ns_step_stacked(t(m), t(x), t(mx))
    assert got[2].shape == (3,) and got[2].dtype == torch.float32
    close(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    for i in range(3):
        one = ns_lib.fused_ns_step_plain(t(m[i]), t(x[i]), t(mx[i]))
        close(got[0][i], one[0])
        np.testing.assert_allclose(float(got[2][i]), float(one[2]), rtol=1e-6)


def test_fused_ns_step_stacked_checks_shapes_and_does_not_launch_on_cpu():
    m, x = ns_start(75, 8)
    ms, xs = t(np.stack([m, m])), t(np.stack([x, x]))
    before = ns_lib.fused_ns_step_stacked.launches
    ns_lib.fused_ns_step_stacked(ms, xs, ms @ xs, torch.tensor([True, False]))
    assert ns_lib.fused_ns_step_stacked.launches == before
    with pytest.raises(ValueError):
        ns_lib.fused_ns_step_stacked(t(m), t(x), t(m @ x))  # 2-D
    with pytest.raises(ValueError):
        ns_lib.fused_ns_step_stacked(ms, xs[:1], ms @ xs)
    with pytest.raises(ValueError):
        ns_lib.fused_ns_step_stacked(ms, xs, ms @ xs, torch.tensor([1, 0]))


@pytest.mark.parametrize('sms', [132, 114])
def test_ns_stacked_plan_counts_every_slot(sms):
    # one slot plans as the 2-D launch; a stack fills the card sooner
    for d in (7, 130, 512, 513, 2048, 2049):
        assert ns_lib.plan(d, sms, 1) == ns_lib.plan(d, sms)
    assert ns_lib.plan(513, sms) == (64, 32)
    tile = ns_lib.plan(513, sms, 8)
    assert tile != (64, 32) and 8 * math.prod(ns_lib.grid(513, tile)) >= sms


def stacked_case():
    """(factors, x0, damping, live) of five slots: a cold start (x0 = 0,
    the fresh state's), a warm start that passes, a warm start outside the
    convergence region (the port's restart), an identity padding slot and
    a NaN factor."""
    d = 32
    f = [spd(80 + i, d) for i in range(3)]
    x0 = [np.zeros((d, d), np.float32)]
    x0.append(np.asarray(jfactors.compute_inverse(jnp.asarray(1.05 * f[1]), 0.004)))
    m = f[2].astype(np.float64) + 0.005 * np.eye(d)
    mu, v = np.linalg.eigh(m)
    c = np.full(d, 1.1)
    c[-1] = 2.8
    x0.append(((v * (c / mu)) @ v.T).astype(np.float32))
    f.append(np.eye(d, dtype=np.float32))
    x0.append(np.eye(d, dtype=np.float32) / 1.006)
    bad = spd(84, d)
    bad[3, 3] = np.nan
    f.append(bad)
    x0.append(np.zeros((d, d), np.float32))
    damping = np.asarray([0.003, 0.004, 0.005, 0.006, 0.007], np.float32)
    return np.stack(f), np.stack(x0), damping, np.asarray([True, True, True, False, True])


def test_newton_schulz_inverse_stacked_matches_vmapped_jax_solver_per_slot():
    f, x0, damping, live = stacked_case()
    want = jax.vmap(
        lambda m, w, dm: jfactors.newton_schulz_inverse_info(m, dm, x0=w)
    )(jnp.asarray(f), jnp.asarray(x0), jnp.asarray(damping))
    cold = jfactors.newton_schulz_inverse_info(jnp.asarray(f[2]), float(damping[2]))
    starts = dict(factors.newton_schulz_inverse_info.starts)
    launches = ns_lib.fused_ns_step_stacked.launches
    got = factors.newton_schulz_inverse_stacked(
        t(f), t(damping), x0=t(x0), live=t(live)
    )
    assert ns_lib.fused_ns_step_stacked.launches == launches  # CPU: the plain version
    # the safeguard's verdicts: slot 0 (zeros) rejected, 1 and 2 kept;
    # slot 2 restarts cold; the padding slot is not live
    assert got.warm.tolist() == [False, True, True, False, False]
    assert got.restarted.tolist() == [False, False, True, False, False]
    moved = {k: factors.newton_schulz_inverse_info.starts[k] - v for k, v in starts.items()}
    assert moved == {'warm': 1, 'cold': 2, 'warm_restarted': 1}
    iters, resid = np.asarray(want.iterations), np.asarray(want.residual)
    assert float(resid[2]) > factors.NS_FALLBACK_RESIDUAL  # the reference's iterate
    for i in (0, 1):
        assert int(got.iterations[i]) == int(iters[i])
        assert float(got.residual[i]) <= 1e-6 and float(resid[i]) <= 1e-6
        close(got.inverse[i], want.inverse[i], rtol=1e-4, atol_rel=1e-5)
    assert int(got.iterations[1]) < 5  # warm: the cold start takes 8 or more
    # the restarted slot: both runs counted, the JAX cold solve returned
    assert int(got.iterations[2]) == int(iters[2]) + int(cold.iterations)
    close(got.inverse[2], cold.inverse, rtol=1e-4, atol_rel=1e-5)
    # padding: never iterates, and its start is already its inverse
    assert int(got.iterations[3]) == 0 == int(iters[3])
    close(got.inverse[3], want.inverse[3])
    # the NaN slot stops at once, NaN in its result, as in JAX
    assert int(got.iterations[4]) == 0 == int(iters[4])
    assert np.isnan(float(got.residual[4])) and np.isnan(float(resid[4]))
    assert torch.isnan(got.inverse[4]).all()


@pytest.mark.parametrize('case', ['well-conditioned', 'one-slot-to-cholesky'])
def test_batched_damped_inverse_auto_matches_jax(case):
    f = np.stack([spd(90, 32), spd(91, 32)])
    damping = 0.01
    if case == 'one-slot-to-cholesky':
        f[1] = np.diag(np.logspace(0, -14, 32)).astype(np.float32)
        damping = 0.0
    before = factors.damped_inverse.cholesky_fallbacks
    got = factors.batched_damped_inverse_auto(t(f), damping)
    want = jfactors.batched_damped_inverse_auto(jnp.asarray(f), damping)
    assert factors.damped_inverse.cholesky_fallbacks - before == (case != 'well-conditioned')
    close(got, want, rtol=1e-4, atol_rel=1e-5)


def test_batched_compute_inverse_and_preconditioning_match_per_slot():
    fa = np.stack([spd(92, 9), spd(93, 9)])
    fg = np.stack([spd(94, 6), spd(95, 6)])
    grad = np.stack([rand(96, 6, 9), rand(97, 6, 9)])
    damping = t(np.asarray([0.003, 0.03], np.float32))
    inv = factors.compute_inverse(t(fa), damping)
    for i in range(2):
        close(inv[i], jfactors.compute_inverse(jnp.asarray(fa[i]), float(damping[i])))
    ea = factors.compute_eigh(t(fa))
    eg = factors.compute_eigh(t(fg))
    got = factors.eigen_preconditioned_grad(t(grad), ea, eg, damping)
    for i in range(2):
        ja = jfactors.EigenDecomp(jnp.asarray(ea.q[i].numpy()), jnp.asarray(ea.d[i].numpy()))
        jg = jfactors.EigenDecomp(jnp.asarray(eg.q[i].numpy()), jnp.asarray(eg.d[i].numpy()))
        close(got[i], jfactors.eigen_preconditioned_grad(
            jnp.asarray(grad[i]), ja, jg, float(damping[i])))
    ginv = factors.compute_inverse(t(fg), 0.01)
    got = factors.inverse_preconditioned_grad(t(grad), inv, ginv)
    for i in range(2):
        close(got[i], jfactors.inverse_preconditioned_grad(
            jnp.asarray(grad[i]), jnp.asarray(inv[i].numpy()), jnp.asarray(ginv[i].numpy())))
