"""The port's hand-written kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch; there, run it without the JAX test
configuration::

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Tolerances, the same as ``chip_smoke.py``'s, which also checks that each
one rejects the plain version at reduced precision (TF32 or bf16): the
covariance within 1e-5 x max|C| (8192-row f32 sums in another order) and
exactly symmetric; the kl-clip dot within 1e-7 x sum|p*g| and identical
from run to run; the kl-clip scale exact; the attention partials within
1e-5 x max|x| of each output; the Newton-Schulz step within 3e-5 x max of
x_new and of mx_new and 3e-5 of the residual, every output identical from
run to run.
"""

import pytest
import torch

from kfac_tpu_torch.ops import flash_attention, klclip
from kfac_tpu_torch.ops import newton_schulz as ns_lib
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8192, 513), (1000, 70), (77, 2049)])
def test_sym_cov_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(0)
    a = torch.randn(shape, generator=g, device=cuda_device)
    got = sym_cov_lib.sym_cov(a)
    want = sym_cov_lib.sym_cov_plain(a)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
@pytest.mark.parametrize(
    'q_off,k_off,s,d',
    [(0, 0, 512, 128), (64, 0, 100, 128), (0, 256, 128, 128), (16, 0, 192, 128)],
)
def test_flash_kernel_matches_plain_on_card(cuda_device, q_off, k_off, s, d):
    g = torch.Generator(cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, s, 4, d, generator=g, device=cuda_device) for _ in range(3))
    got = flash_attention.flash_attention_partials(q, k, v, q_off, k_off, True)
    want = flash_attention.attend_partials_einsum(q, k, v, q_off, k_off, True)
    for x, w in zip(got, want):
        assert (x - w).abs().max() <= 1e-5 * w.abs().max().clamp(max=1e6) + 1e-6


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
