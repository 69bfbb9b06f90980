"""Package rules of the PyTorch port.

- ``kfac_tpu_torch`` and ``chip_smoke.py`` import neither JAX (``jax``,
  ``flax``, ``optax``), nor orbax, nor anything of ``kfac_tpu``, checked on
  the ASTs; the checkpoint and resilience modules among them, and the
  tensor and sequence parallel ones.
- Entry points default to CUDA: without a GPU they raise unless the caller
  passes ``device='cpu'``.
- Nothing imports ``triton`` when a module is imported.
"""

import ast
import importlib
import os
import pathlib
import sys

import pytest
import torch

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kfac_tpu'}
PORT_FILES = sorted((ROOT / 'kfac_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split('.')[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, 'attr', getattr(node.func, 'id', None))
            in ('import_module', '__import__')
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split('.')[0])
    return roots


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_kfac_tpu(path):
    assert path.exists()
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize('rel', [
    'checkpoint.py', 'convert.py', 'resilience/__init__.py', 'resilience/signals.py',
    'resilience/manager.py', 'resilience/worker.py', 'parallel/multihost.py',
    'async_inverse/__init__.py', 'async_inverse/config.py', 'async_inverse/slots.py',
    'async_inverse/sliced.py', 'async_inverse/host.py', 'hyperparams.py', 'layers/registry.py',
    'assignment.py', 'enums.py', 'parallel/__init__.py', 'parallel/collectives.py',
    'parallel/mesh.py', 'parallel/kaisa.py', 'parallel/launch.py', 'observability/comms.py',
    'ops/cov.py', 'layers/helpers.py', 'models/layers.py', 'models/resnet.py', 'data.py',
    'bench_accuracy.py', 'bench_resnet.py', 'training.py', 'compression/__init__.py',
    'compression/config.py', 'compression/quant.py', 'compression/offload.py', 'bench_lm.py',
    'parallel/tensor_parallel.py', 'models/attention.py', 'models/transformer.py',
    'ops/losses.py', 'layers/capture.py', 'amp.py', 'examples/train_amp.py', 'models/mlp.py',
    'ops/sym_cov.py', 'ops/flash_attention.py', 'ops/factors.py', 'preconditioner.py',
])
def test_checkpoint_and_resilience_modules_are_covered(rel):
    path = ROOT / 'kfac_tpu_torch' / rel
    assert path in PORT_FILES
    assert not imported_roots(path) & FORBIDDEN


def test_ast_check_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / 'bad.py'
    bad.write_text('import torch\nfrom kfac_tpu.ops import cov\nimport jax.numpy as jnp\n')
    assert imported_roots(bad) & FORBIDDEN == {'kfac_tpu', 'jax'}


def test_port_modules_import_without_triton():
    names = [
        'kfac_tpu_torch.' + '.'.join(p.relative_to(ROOT / 'kfac_tpu_torch').with_suffix('').parts)
        for p in sorted((ROOT / 'kfac_tpu_torch').rglob('*.py'))
        if p.name != '__init__.py'
    ]
    had_triton = 'triton' in sys.modules
    for name in names:
        importlib.import_module(name)
    assert ('triton' in sys.modules) == had_triton


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    from kfac_tpu_torch import KFACPreconditioner, register_model
    from kfac_tpu_torch.models import TransformerLM

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(vocab_size=16, d_model=8, num_heads=2, num_layers=1, max_len=4)
    model = TransformerLM(
        vocab_size=16, d_model=8, num_heads=2, num_layers=1, max_len=4, device='cpu'
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        register_model(model)
    reg = register_model(model, device='cpu')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KFACPreconditioner(reg)
    kfac = KFACPreconditioner(reg, device='cpu')
    assert all(t.device.type == 'cpu' for t in kfac.init().a.values())

    from kfac_tpu_torch import bench_lm
    from kfac_tpu_torch.training import Trainer

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, opt, lambda ms, b: (model(b).sum(), ms), kfac=kfac)
    trainer = Trainer(model, opt, lambda ms, b: (model(b).sum(), ms), kfac=kfac, device='cpu')
    assert trainer.init().kfac_state.step == 0
    # the bench entry runs with --device cpu (tests/test_torch_bench_lm.py)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_lm.main(['--config', 'tiny'])


def test_conv_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    from kfac_tpu_torch import bench_accuracy, bench_resnet
    from kfac_tpu_torch.models import resnet

    for make in (resnet.resnet20, resnet.resnet50, bench_accuracy.SmallCNN):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert next(resnet.resnet20(device='cpu').parameters()).device.type == 'cpu'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_resnet.main(['--config', 'resnet32_cifar'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_accuracy.task_digits_cnn()


def test_register_model_rejects_a_model_on_another_device():
    from kfac_tpu_torch import register_model

    model = torch.nn.Linear(3, 2)
    with pytest.raises(ValueError, match='cpu'):
        register_model(model, device='meta')


def test_amp_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    from kfac_tpu_torch import amp
    from kfac_tpu_torch.examples import train_amp

    for make in (amp.init, train_amp.ConvNet, lambda: train_amp.main(['--steps', '1'])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert amp.init(device='cpu').scale.device.type == 'cpu'
