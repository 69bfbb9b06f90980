"""The 16-bit covariance kernels' host side, on the CPU: the walk of
``sym_cov.plan16`` (every upper tile pair and every row of it taken once,
the waves it claims filled), the layouts TMA reads as they lie, the A
builders' padded rows, and ``sym_cov_ema``'s bf16 and f16 plain version
against the JAX package's fused kernel in interpret mode.

Tolerances: a 16-bit covariance within 2u of its largest element (u the
dtype's unit roundoff: one flip of its single rounding, as in
``test_torch_amp.py``); the blend of a 16-bit ``a`` into an f32 factor at
the f32 form's rtol 1e-5 / atol 1e-5 (the products are exact in f32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_tpu.ops import cov as jcov
from kfac_tpu.ops import pallas_cov_ema as jpallas_cov_ema
from kfac_tpu_torch.ops import cov, cov_ema
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

U = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
HALF = pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])


def kernel_pair_of(t, nblk):
    """csrc/sym_cov.cu's pair_of: the upper tile pair of index t."""
    bi = 0
    while t >= nblk - bi:
        t -= nblk - bi
        bi += 1
    return bi, bi + t


@pytest.mark.parametrize('n', [5, 77, 1000, 8192])
@pytest.mark.parametrize('d', [3, 130, 512, 513, 2048, 2049])
@pytest.mark.parametrize('sms', [132, 114])
def test_plan16_covers_each_pair_and_row_once(n, d, sms):
    p = sym_cov_lib.plan16(n, d, sms)
    tile, slab = sym_cov_lib.TILE16, sym_cov_lib.SLAB16_ROWS
    assert p.rows_per_slice % slab == 0  # the launcher's check
    assert (p.nblk - 1) * tile < d <= p.nblk * tile
    assert 1 <= p.ctas <= sms and p.ctas == min(sms, p.items)
    rows = {}
    split_pairs = []
    for cta, t, begin, end in p.walk():
        assert 0 <= t < p.pairs and begin < end  # no empty item
        rows.setdefault(kernel_pair_of(t, p.nblk), np.zeros(n, np.int64))[begin:end] += 1
        if t >= p.whole:  # a slice of one of the last `split` pairs
            split_pairs.append(t)
    assert sorted(rows) == [(i, j) for i in range(p.nblk) for j in range(i, p.nblk)]
    assert all((r == 1).all() for r in rows.values())
    # the split pairs are the last ones, each in `slices` slices
    assert sorted(split_pairs) == sorted(t for t in range(p.whole, p.pairs) for _ in range(p.slices))
    assert p.scratch_bytes == 4 * p.split * p.slices * tile**2
    if n <= sym_cov_lib.MAX_UNSPLIT16_SLABS * slab:
        assert p.split == 0  # short N stays whole: a split costs a second launch


@pytest.mark.parametrize('n', [5, 77, 1000, 8192])
@pytest.mark.parametrize('d', [3, 130, 512, 513, 2048, 2049])
@pytest.mark.parametrize('sms', [132, 114])
def test_plan16_fills_the_waves_it_claims(n, d, sms):
    p = sym_cov_lib.plan16(n, d, sms)
    slab = sym_cov_lib.SLAB16_ROWS
    per_cta = np.zeros(p.ctas, np.int64)
    whole = np.zeros(p.ctas, np.int64)
    sliced = np.zeros(p.ctas, np.int64)
    for cta, t, begin, end in p.walk():
        per_cta[cta] += -(-(end - begin) // slab)
        (whole if t < p.whole else sliced)[cta] += 1
    assert p.fill == pytest.approx(per_cta.sum() / (sms * per_cta.max()))
    if p.split:
        # every CTA takes the same whole pairs and at most one slice, so the
        # longest walk is at most one slice past an even share of the slabs
        assert (whole == p.whole // p.ctas).all() and sliced.max() == 1
        assert p.whole % p.ctas == 0 and p.split * p.slices <= sms
        work = p.pairs * -(-n // slab)
        assert per_cta.max() <= -(-work // sms) + p.rows_per_slice // slab
    if (n, sms) == (8192, 132) and d >= 512:  # the flagship's factors on an H100
        assert (p.whole, p.split, p.slices, p.rows_per_slice) == {
            512: (0, 10, 13, 640), 513: (0, 15, 8, 1024),
            2048: (132, 4, 32, 256), 2049: (132, 21, 6, 1408),
        }[d]
        assert round(p.fill, 3) == {512: 0.970, 513: 0.909, 2048: 0.999, 2049: 0.989}[d]


def test_tma_ready_takes_rows_on_16_bytes_only():
    buf = torch.zeros(6, 24, dtype=torch.bfloat16)
    assert sym_cov_lib.tma_ready(buf)
    assert sym_cov_lib.tma_ready(buf[:, :13])  # rows 24 values apart
    assert not sym_cov_lib.tma_ready(buf[:, 1:14])  # off a 16-byte boundary
    assert not sym_cov_lib.tma_ready(torch.zeros(6, 13, dtype=torch.bfloat16))
    assert not sym_cov_lib.tma_ready(buf.T)  # columns not unit-stride
    view = sym_cov_lib.kernel_rows(5, 13, torch.float16, 'cpu', padded=True)
    assert view.shape == (5, 13) and view.stride() == (64, 1) and sym_cov_lib.tma_ready(view)
    assert sym_cov_lib.kernel_rows(5, 13, torch.float16, 'cpu', padded=False).is_contiguous()
    ready = buf[:, :13]
    assert sym_cov_lib.half_input(ready) is ready
    a = torch.randn(7, 13).to(torch.bfloat16)
    copy = sym_cov_lib.half_input(a)
    assert sym_cov_lib.tma_ready(copy) and torch.equal(copy, a)


def padded_everywhere(monkeypatch):
    """Makes the A builders write padded rows on the CPU too, as they do
    for a 16-bit CUDA tensor; records the layouts they hand to get_cov."""
    seen = []
    get_cov = cov.get_cov

    def recording(a, *args, **kw):
        seen.append((a.stride(), sym_cov_lib.tma_ready(a)))
        return get_cov(a, *args, **kw)

    monkeypatch.setattr(cov, 'pads_rows', lambda x: True)
    monkeypatch.setattr(cov, 'get_cov', recording)
    return seen


BUILDERS = {
    'linear_a': (lambda a, dt: cov.linear_a_factor(a, True, dt),
                 lambda a, dt: jcov.linear_a_factor(a, True, dtype=dt)),
    'routed_a': (lambda a, dt: cov.routed_linear_a_factor(a, True, dt),
                 lambda a, dt: jcov.routed_linear_a_factor(a, True, dtype=dt)),
}


@pytest.mark.parametrize('name', sorted(BUILDERS))
@pytest.mark.parametrize('width', [24, 40, 64])  # rows of 25, 41 and 65 values
def test_padded_a_builders_match_contiguous_and_jax(monkeypatch, name, width):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, width)).astype(np.float32)
    x[:, ::3] = 0.0  # unrouted rows, for the routed factor
    port, jax_fn = BUILDERS[name]
    contiguous = port(torch.from_numpy(x), torch.bfloat16)
    seen = padded_everywhere(monkeypatch)
    padded = port(torch.from_numpy(x), torch.bfloat16)
    # the covariance saw rows padded to 64 values, with the values of the
    # contiguous build, bit for bit
    assert seen == [((-(-(width + 1) // 64) * 64, 1), True)]
    assert torch.equal(padded, contiguous)
    want = jax_fn(jnp.asarray(x), jnp.bfloat16)
    got, ref = padded.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.max(np.abs(got - ref)) <= 2 * U[torch.bfloat16] * np.max(np.abs(ref))


def test_append_bias_ones_pads_matrices_only(monkeypatch):
    padded_everywhere(monkeypatch)
    x = torch.randn(6, 12).to(torch.float16)
    out = cov.append_bias_ones(x)
    assert out.stride() == (64, 1) and torch.equal(out, torch.cat([x, torch.ones(6, 1, dtype=x.dtype)], -1))
    x3 = torch.randn(2, 6, 12).to(torch.float16)  # not a matrix: concatenated as before
    assert cov.append_bias_ones(x3).is_contiguous()


@HALF
@pytest.mark.parametrize('n,d', [(512, 256), (1000, 200), (77, 130)])
def test_sym_cov_ema_16_bit_plain_matches_pallas_interpret(dtype, n, d):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    f = rng.standard_normal((d, d)).astype(np.float32)
    f = 0.5 * (f + f.T)
    beta, coeff = 0.95, 0.05 / n
    want = jpallas_cov_ema._fused(
        jnp.asarray(f), jnp.asarray(a.float().numpy()).astype(JDT[dtype]), beta, coeff,
        interpret=True,
    )
    before = dict(cov_ema.sym_cov_ema.launches_by_dtype)
    got = cov_ema.sym_cov_ema(torch.from_numpy(f), a, beta, coeff)
    assert cov_ema.sym_cov_ema.launches_by_dtype == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and torch.equal(got, got.T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # fused_cov_ema promotes to the running factor's dtype, as the JAX one
    out = cov_ema.fused_cov_ema(torch.from_numpy(f), a, 0.95)
    assert out.dtype == torch.float32


def test_half_probe_variants_apply_to_the_sources():
    # the probe's variants are text replacements of the sources: each must
    # still find its text, so that it times what it names
    from kfac_tpu_torch import half_probe
    from kfac_tpu_torch.ops import build

    for name, table in (('sym_cov', half_probe.SYM_COV), ('flash_attn', half_probe.FLASH)):
        src = (build.CSRC / f'{name}.cu').read_text()
        for variant, (subs, _) in table.items():
            assert half_probe.variant_source(src, subs) != src or variant == 'built', variant
