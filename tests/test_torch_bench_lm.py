"""The port's bench LM stage (``kfac_tpu_torch.bench_lm``) on the CPU.

A 1 + 3 step window (and 3 scan steps) of the ``tiny`` config: the record
carries the keys of the bench's LM stage (the async spike probe's too), the
plain versions ran, and no device metric is filled from a CPU run. Its FLOP count is held against the
bench's formula applied to the JAX model's parameters.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu_torch import bench_lm

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

KEYS = {
    'stage', 'platform', 'device_kind', 'model_config', 'sgd_tokens_per_sec',
    'eager_tokens_per_sec', 'scan_tokens_per_sec', 'value', 'vs_baseline',
    'n_params', 'mfu', 'sgd_mfu', 'fused_kernel_probe',
}


@pytest.fixture(scope='module')
def record():
    return bench_lm.main(
        ['--config', 'tiny', '--device', 'cpu', '--warmup', '1', '--iters', '3', '--scan-steps', '3']
    )


def test_cpu_record_has_the_bench_keys(record, capsys):
    assert KEYS <= set(record)
    assert record['stage'] == 'lm_tiny' and record['platform'] == 'cpu'
    assert record['model_config'] == 'cpu_smoke_L2_d128_s128_b4_v512'
    assert record['mfu'] is None and record['sgd_mfu'] is None
    assert record['compute_method'] == 'EIGEN'
    for key in ('sgd_tokens_per_sec', 'eager_tokens_per_sec', 'scan_tokens_per_sec', 'value'):
        assert record[key] > 0
    assert record['value'] == max(record['eager_tokens_per_sec'], record['scan_tokens_per_sec'])
    assert record['vs_baseline'] == pytest.approx(record['value'] / record['sgd_tokens_per_sec'])
    assert all(torch.isfinite(torch.tensor(v)) for v in record['last_loss'].values())


def test_cpu_probe_ran_the_plain_versions(record):
    probe = record['fused_kernel_probe']
    assert probe['config'] == 'd256_rows512' and probe['plain_versions']
    for fam in ('cov_ema', 'ns', 'klclip'):
        row = probe[fam]
        assert 'fused_error' not in row
        assert row['fused_p50_ms'] > 0 and row['unfused_p50_ms'] > 0
    assert 'device_ms' not in probe


def test_cpu_record_has_the_async_spike_probe(record):
    """The port of ``bench._async_spike_probe``: its keys, at its MLP."""
    probe = record['async_spike_probe']
    keys = {f'{k}{s}' for k in ('step_p50_ms', 'step_p95_ms', 'step_max_ms', 'refresh_spike_ratio')
            for s in ('', '_sync')}
    assert set(probe) == keys | {'async_probe_config'}
    assert probe['async_probe_config'] == 'mlp_d512_b256_w8'
    for s in ('', '_sync'):
        assert 0 < probe[f'step_p50_ms{s}'] <= probe[f'step_p95_ms{s}'] <= probe[f'step_max_ms{s}']
        assert probe[f'refresh_spike_ratio{s}'] >= 1.0


def test_flops_and_params_follow_the_bench_formula(record):
    cfg = bench_lm.LM_CONFIGS['tiny']
    model = JaxLM(vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=4,
                  num_layers=cfg['layers'], max_len=cfg['seq'])
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg['seq']), jnp.int32))['params']
    n_params = n_matmul = 0
    for path, p in jax.tree_util.tree_flatten_with_path(params)[0]:
        n_params += int(p.size)
        if not any('embed' in str(k).lower() for k in path):
            n_matmul += int(p.size)
    flops = cfg['batch'] * cfg['seq'] * (
        6 * n_matmul + 12 * cfg['layers'] * cfg['d_model'] * cfg['seq']
    )
    assert record['n_params'] == n_params
    assert record['flops_per_step'] == flops


@pytest.mark.parametrize('name', sorted(bench._LM_CONFIGS))
def test_lm_configs_are_the_bench_configs(name):
    assert set(bench_lm.LM_CONFIGS) == set(bench._LM_CONFIGS)
    assert bench_lm.LM_CONFIGS[name] == bench._LM_CONFIGS[name]


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_lm.main(['--config', 'tiny'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_lm.run_lm_stage('tiny')


def test_device_runs_split_at_marker_kernels():
    """Each scope's device time is the events between its two markers,
    however long the idle time between two of its kernels."""
    gemm, ew, mark = 'sm80_xmma_gemm', 'elementwise_kernel', 'at::native::bitwise_not_kernel_cuda'
    events = [
        (0.0, 1.0, ew), (2.0, 3.0, mark),  # before the first marker: no scope's
        (4.0, 8.0, gemm), (5000.0, 5002.0, ew), (5003.0, 5004.0, mark),  # a 5 ms stall
        (5010.0, 5013.0, 'sym_cov_ema_kernel<2>'), (5014.0, 5015.0, mark),
    ]
    out = bench_lm.split_device_runs(list(reversed(events)), ['a', 'b'])
    assert out == {'device_ms': {'a': 0.006, 'b': 0.003}, 'device_events': {'a': 2, 'b': 1}}
    assert 'trace_error' in bench_lm.split_device_runs(events[:-1], ['a', 'b'])
    assert 'trace_error' in bench_lm.split_device_runs(events[:1] + events[2:], ['a', 'b'])
    assert 'trace_error' in bench_lm.split_device_runs(events[:4] + events[5:], ['a', 'b'])


def test_device_runs_leave_out_the_pad_after_the_last_marker():
    """Kernels after the last marker are the pass's end pad, no scope's;
    a pass that lost its last marker is still refused."""
    mark, pad = 'bitwise_not_kernel_cuda', 'vectorized_elementwise_kernel'
    events = [(0.0, 1.0, pad), (2.0, 3.0, mark), (4.0, 6.0, 'gemm'), (7.0, 8.0, mark),
              (9.0, 10.0, pad), (11.0, 12.0, pad)]
    out = bench_lm.split_device_runs(events, ['a'])
    assert out == {'device_ms': {'a': 0.002}, 'device_events': {'a': 1}}
    assert 'trace_error' in bench_lm.split_device_runs(events[:3] + events[4:], ['a'])


def test_trace_check_counts_the_records_a_pass_lost():
    from kfac_tpu_torch import trace_check

    mark, pad, n = 'bitwise_not_kernel_cuda', 'add_kernel', bench_lm.PAD_KERNELS
    body = [(1000.0, 1001.0, mark), (1002.0, 1004.0, 'gemm'), (1005.0, 1006.0, mark)]
    whole = [(float(i), i + 0.5, pad) for i in range(n)] + body + [
        (2000.0 + i, 2000.5 + i, pad) for i in range(n)]
    assert trace_check.pass_losses(whole, ['a']) == dict(
        records=2 * n + 3, lost_before=0, lost_after=0, splits=True)
    assert trace_check.pass_losses(whole[7:-2], ['a']) == dict(
        records=2 * n - 6, lost_before=7, lost_after=2, splits=True)
    assert trace_check.pass_losses(whole[n + 1:], ['a'])['splits'] is False


def test_device_ms_takes_two_passes_in_a_row_that_agree(monkeypatch):
    mark = 'bitwise_not_kernel_cuda'
    full = [(0.0, 1.0, mark), (2.0, 4.0, 'gemm'), (5.0, 6.0, 'add'), (7.0, 8.0, mark)]
    short = [(0.0, 1.0, mark), (5.0, 6.0, 'add'), (7.0, 8.0, mark)]  # a record lost
    passes = iter([full[:-1], short, full, full])
    monkeypatch.setattr(bench_lm, '_profiled_pass', lambda variants, device: next(passes))
    out = bench_lm._device_ms({'a': None}, torch.device('cpu'))
    assert out == {'device_ms': {'a': 0.003}, 'device_events': {'a': 2}, 'device_passes': 4}
    passes = iter([full[:-1], short, full, short])
    out = bench_lm._device_ms({'a': None}, torch.device('cpu'))
    assert 'trace_error' in out and out['device_passes'] == 4
