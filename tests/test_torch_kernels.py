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
1e-5 x max|x| of each output.
"""

import pytest
import torch

from kfac_tpu_torch.ops import flash_attention, klclip
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
