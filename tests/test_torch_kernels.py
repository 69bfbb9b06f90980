"""The port's hand-written kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch; there, run it without the JAX test
configuration::

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Tolerances, the same as ``chip_smoke.py``'s, which also checks that each
one rejects the plain version at reduced precision (TF32 or bf16): the
covariance within 1e-5 x max|C| (8192-row f32 sums in another order),
exactly symmetric and identical from run to run; the covariance blended
into a symmetric running factor within 1e-5 x max|coeff a^T a| (the blend
scales the product's error by coeff, so the product is the reference) and
exactly symmetric; the kl-clip dot within 1e-7 x sum|p*g| and identical
from run to run; the kl-clip scale bitwise equal to the plain version; the
attention partials within 1e-5 x max|x| of each output; the Newton-Schulz
step within 3e-5 x max of x_new and of mx_new and 3e-5 of the residual,
every output identical from run to run.
"""

import pytest
import torch

from kfac_tpu_torch.ops import cov_ema, flash_attention, klclip
from kfac_tpu_torch.ops import newton_schulz as ns_lib
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# split (d ~ 512: pairs < SMs) and unsplit (d ~ 2048) plans, ragged N and D,
# N under one 32-row slab, the 16-byte copies (d % 4 == 0) and the 4-byte ones
@pytest.mark.cuda
@pytest.mark.parametrize(
    'shape',
    [(8192, 513), (1000, 70), (77, 2049), (8192, 512), (4096, 2048), (5, 130),
     (31, 2049), (77, 130), (300, 64), (1, 1)],
)
def test_sym_cov_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(0)
    a = torch.randn(shape, generator=g, device=cuda_device)
    got = sym_cov_lib.sym_cov(a)
    want = sym_cov_lib.sym_cov_plain(a)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, sym_cov_lib.sym_cov(a))  # no atomics: repeatable


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8192, 513), (512, 256), (77, 130), (1000, 70)])
def test_sym_cov_ema_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(4)
    a = torch.randn(shape, generator=g, device=cuda_device)
    f = sym_cov_lib.sym_cov_plain(torch.randn(shape, generator=g, device=cuda_device))
    n = shape[0]
    beta, coeff = 0.95, 0.05 / n
    before = cov_ema.sym_cov_ema.launches
    got = cov_ema.sym_cov_ema(f, a, beta, coeff)
    assert cov_ema.sym_cov_ema.launches == before + 1
    want = cov_ema.sym_cov_ema_plain(f, a, beta, coeff)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * (coeff * (a.T @ a)).abs().max()
    cold = cov_ema.fused_cov_ema(None, a, beta)
    assert (cold - cov_ema.sym_cov_ema_plain(torch.eye(shape[1], device=cuda_device), a, beta, coeff)
            ).abs().max() <= 1e-5 * (coeff * (a.T @ a)).abs().max()


def test_flash_kernel_raises_for_a_head_dim_it_was_not_built_for():
    # checked before the device, so this runs without a card
    q = torch.zeros(1, 4, 1, 64, device='meta')
    with pytest.raises(ValueError, match='head dims'):
        flash_attention._flash_partials_kernel(q, q, q, 0, 0, True)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(512, 513), (37, 129), (3, 5)])
def test_klclip_kernels_match_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(1)
    p = torch.randn(shape, generator=g, device=cuda_device)
    q = torch.randn(shape, generator=g, device=cuda_device)
    got = klclip.klclip_dot(p, q)
    assert torch.equal(got, klclip.klclip_dot(p, q))  # no atomics: repeatable
    assert abs(float(got - klclip.klclip_dot_plain(p, q))) <= 1e-7 * float((p * q).abs().sum())
    s = torch.tensor(0.3, device=cuda_device)
    assert torch.equal(klclip.klclip_scale(p, s), klclip.klclip_scale_plain(p, s))


@pytest.mark.cuda
def test_sym_cov_kernel_with_each_split_matches_plain_on_card(cuda_device):
    # one shape through splits from 1 to one slice per slab
    g = torch.Generator(cuda_device).manual_seed(5)
    a = torch.randn(200, 130, generator=g, device=cuda_device)
    want = sym_cov_lib.sym_cov_plain(a, 3.0)
    for slabs_per_split in (1, 2, 3, 4, 7):  # 200 rows are 7 slabs
        splits = -(-7 // slabs_per_split)
        p = sym_cov_lib.CovPlan(200, 130, splits, slabs_per_split * 32)
        got = torch.empty(130, 130, device=cuda_device)
        sym_cov_lib.launch(a, got, 3.0, p)
        assert torch.equal(got, got.T)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), splits


@pytest.mark.cuda
def test_sym_cov_ema_kernel_with_each_split_matches_plain_on_card(cuda_device):
    # one shape through splits from 1 to one slice per slab: the blend in
    # the main kernel's epilogue (1 slice) and in the reduce pass (more)
    g = torch.Generator(cuda_device).manual_seed(7)
    a = torch.randn(200, 130, generator=g, device=cuda_device)
    f = sym_cov_lib.sym_cov_plain(torch.randn(200, 130, generator=g, device=cuda_device))
    beta, coeff = 0.95, 0.05 / 200
    want = cov_ema.sym_cov_ema_plain(f, a, beta, coeff)
    tol = 1e-5 * (coeff * (a.T @ a)).abs().max()
    for slabs_per_split in (1, 2, 3, 4, 7):  # 200 rows are 7 slabs
        splits = -(-7 // slabs_per_split)
        p = sym_cov_lib.CovPlan(200, 130, splits, slabs_per_split * 32)
        got, again = (torch.empty(130, 130, device=cuda_device) for _ in range(2))
        cov_ema.launch(f, a, got, beta, coeff, p)
        cov_ema.launch(f, a, again, beta, coeff, p)
        assert torch.equal(got, got.T), splits
        assert torch.equal(got, again), splits  # no atomics: repeatable
        assert (got - want).abs().max() <= tol, splits


def scale_cases(device):
    """Tensors of numel 0 and 1, 2, 3 (mod 4), contiguous views that start
    off a 16-byte boundary, and 100 tensors (more than one launch's table)."""
    g = torch.Generator(device).manual_seed(6)
    base = torch.randn(40_000, generator=g, device=device)
    ragged = [
        torch.randn(s, generator=g, device=device) for s in ((37, 129), (5,), (3, 2), (4097,))
    ]
    views = [base[1:1 + 4099], base[2:2 + 8194].view(2, 4097), base[3:3 + 17]]
    many = [torch.randn(i % 7 * 600 + 1, generator=g, device=device) for i in range(100)]
    return {
        'ragged': ragged + [torch.empty(0, device=device)] + views,
        'single': [torch.randn(512, 513, generator=g, device=device)],
        'many': many,
    }


def offset_copy(p):
    """A copy of ``p`` at ``p``'s offset from a 16-byte boundary."""
    off = p.data_ptr() % 16 // 4
    return torch.empty(p.numel() + off, device=p.device)[off:].view(p.shape).copy_(p)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'single', 'many'])
def test_klclip_scale_many_is_bitwise_plain_on_card(cuda_device, case):
    ps = scale_cases(cuda_device)[case]
    s = torch.tensor(0.37, device=cuda_device)
    want = klclip.klclip_scale_many_plain(ps, s)
    before = klclip.klclip_scale.launches
    got = klclip.klclip_scale_many(ps, s)
    nonempty = sum(p.numel() > 0 for p in ps)
    assert klclip.klclip_scale.launches == before + -(-nonempty // klclip.TABLE_CAPACITY)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    # in place, as the engine calls it: the views keep their offsets
    copies = [offset_copy(p) for p in ps]
    same = klclip.klclip_scale_many(copies, s, in_place=True)
    for x, c, w in zip(same, copies, want):
        assert x is c and torch.equal(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize(
    'q_off,k_off,s,d',
    [(0, 0, 512, 128), (64, 0, 100, 128), (0, 256, 128, 128), (16, 0, 192, 128),
     (0, 0, 128, 32), (16, 0, 100, 32), (0, 0, 256, 256), (48, 0, 100, 256),
     (0, 128, 96, 256)],
)
def test_flash_kernel_matches_plain_on_card(cuda_device, q_off, k_off, s, d):
    g = torch.Generator(cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, s, 4, d, generator=g, device=cuda_device) for _ in range(3))
    got = flash_attention.flash_attention_partials(q, k, v, q_off, k_off, True)
    want = flash_attention.attend_partials_einsum(q, k, v, q_off, k_off, True)
    for x, w in zip(got, want):
        assert (x - w).abs().max() <= 1e-5 * w.abs().max().clamp(max=1e6) + 1e-6


@pytest.mark.cuda
def test_flash_kernel_raises_for_a_tensor_off_a_16_byte_boundary(cuda_device):
    # the kernel stages rows by 16-byte copies
    q = torch.zeros(2 * 64 * 4 * 128 + 1, device=cuda_device)[1:].view(2, 64, 4, 128)
    k = torch.zeros(2, 64, 4, 128, device=cuda_device)
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention.flash_attention_partials(q, k, k, 0, 0, True)


@pytest.mark.cuda
@pytest.mark.parametrize('d', [513, 512, 130, 2049, 7])
def test_ns_kernel_matches_plain_on_card(cuda_device, d):
    # as the solver meets it: a damped factor, the Gershgorin start and two
    # plain iterations. A square `a` keeps the residual far from the f32
    # floor, where a relative tolerance on it would compare rounding noise.
    g = torch.Generator(cuda_device).manual_seed(3)
    a = torch.randn(d, d, generator=g, device=cuda_device)
    eye = torch.eye(d, device=cuda_device)
    m = a.T @ a / d + 0.003 * eye
    lam_max = m.abs().sum(-1).max()
    x, mx = eye / lam_max, m / lam_max
    for _ in range(2):
        x, mx, _ = ns_lib.fused_ns_step_plain(m, x, mx)
    before = ns_lib.fused_ns_step.launches
    got = ns_lib.fused_ns_step(m, x, mx)
    assert ns_lib.fused_ns_step.launches == before + 1
    want = ns_lib.fused_ns_step_plain(m, x, mx)
    for o, w in zip(got[:2], want[:2]):
        assert (o - w).abs().max() <= 3e-5 * w.abs().max()
    assert abs(float(got[2]) - float(want[2])) <= 3e-5 * float(want[2])
    again = ns_lib.fused_ns_step(m, x, mx)  # no atomics: repeatable
    assert all(torch.equal(o, p) for o, p in zip(got, again))
