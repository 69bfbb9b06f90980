"""The bench's LM stage on the port (counterpart of ``run_lm_stage`` and
``_fused_kernel_probe`` in ``bench.py``, which this module does not import).

Run::

    python -m kfac_tpu_torch.bench_lm --config {tiny,flagship,large,longctx} [--device cuda]

On one seeded batch (tokens from seed 0, weights from seed 1), 4 heads,
bf16 on the card and f32 on the CPU, as the bench runs its LM
(``bench.py:1227``; ``--dtype`` overrides), ``lm_head`` skipped, damping 0.003, lr 0.1, cadence 10/100,
SGD(0.1, momentum 0.9), the compute method left to the platform default
(EIGEN on CUDA), it times:

- an SGD baseline through ``Trainer(kfac=None).step``;
- eager K-FAC steps through ``Trainer.step``;
- ``Trainer.scan_steps``: ``scan_steps`` steps to warm up, then as many timed.

The step windows are the bench's: 5 warm-up steps, then 100 timed steps
(5..104), so the timed window holds 10 captures and the refresh at step
100. Then the fused-kernel probe: the port's fused kernels (cov+EMA,
Newton-Schulz, kl-clip) against the plain expressions they fuse; and the
async refresh spike probe (``async_spike_probe``, the port of the bench's
``_async_spike_probe``): per-step times of an MLP under the synchronous
refresh and under ``async_inverse='sliced'``; and the compression probe
(``compression_probe``, the port of the bench's ``_compression_probe``):
a ``DistributedKFAC`` in a world of one rank at the f32 and the int8 wire,
and a dense offload Trainer's counters.

Prints the card's name and power limit (``nvidia-smi``) on CUDA, then one
JSON line. MFU is read against the peak of the dtype the step computes in
(``PEAK_FLOPS``). On the CPU the kernels' plain versions run and the
record says so; its times are the CPU's and no MFU is given.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import subprocess
import tempfile
import time
from typing import Any, Iterator

import numpy as np
import torch

from kfac_tpu_torch.compression import OffloadConfig
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers.capture import CurvatureCapture
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models import MLP, TransformerLM, lm_loss
from kfac_tpu_torch.ops import cov_ema, klclip, newton_schulz
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

LM_CONFIGS = {
    'tiny': dict(batch=4, seq=128, d_model=128, layers=2, vocab=512),
    'flagship': dict(batch=16, seq=512, d_model=512, layers=6, vocab=8192),
    # the bench's manual configs: `large` (head dim 256) and `longctx`
    # (2048-token attention)
    'large': dict(batch=8, seq=1024, d_model=1024, layers=8, vocab=8192),
    'longctx': dict(batch=4, seq=2048, d_model=512, layers=6, vocab=8192),
}
NUM_HEADS = 4
# MFU is against the H100 SXM's published peak for the dtype the model
# computes in (NVIDIA's data sheet, dense, at a 700 W limit): f32 outside
# the tensor cores (the port's f32 products are full f32), bf16 and f16 on
# the tensor cores
PEAK_FLOPS = {
    torch.float32: (67e12, 'H100 SXM f32 without tensor cores, 67 TFLOP/s'),
    torch.bfloat16: (989e12, 'H100 SXM bf16 dense tensor cores, 989 TFLOP/s'),
    torch.float16: (989e12, 'H100 SXM f16 dense tensor cores, 989 TFLOP/s'),
}
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16, 'f16': torch.float16}


def default_dtype(device: torch.device) -> torch.dtype:
    """The bench's LM dtype: bf16 on an accelerator, f32 on the CPU."""
    return torch.bfloat16 if device.type == 'cuda' else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lm_batch(cfg: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens from seed 0 and their next-token targets."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
    return tokens.to(device), torch.roll(tokens, -1, dims=1).to(device)


def lm_trainer(
    cfg: dict, device: torch.device, kfac: bool, dtype: torch.dtype = torch.float32,
    **kfac_kw: Any,
) -> Trainer:
    """The bench's LM computing in ``dtype``, weights from seed 1, under
    K-FAC (the bench's settings, ``kfac_kw`` over them) or plain SGD."""
    model = TransformerLM(
        vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=NUM_HEADS,
        num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device, dtype=dtype,
    )
    engine = None
    if kfac:
        # the output head is excluded from K-FAC, as in the bench (its G
        # factor is vocab x vocab); its gradient still flows
        reg = register_model(model, skip_layers=['lm_head'], device=device)
        settings = dict(damping=0.003, lr=0.1, factor_update_steps=10, inv_update_steps=100)
        engine = KFACPreconditioner(reg, **{**settings, **kfac_kw}, device=device)
    loss = lm_loss(model)
    return Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        lambda ms, batch: (loss(batch), ms), kfac=engine, device=device,
    )


def time_steps(trainer: Trainer, batch, warmup: int, iters: int) -> tuple[float, float]:
    """(seconds per step over steps ``warmup .. warmup + iters - 1``, the
    last loss)."""
    device = trainer.device
    state = trainer.init()
    for _ in range(warmup):
        state, loss = trainer.step(state, batch)
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        state, loss = trainer.step(state, batch)
    _sync(device)
    return (time.perf_counter() - start) / iters, float(loss)


def time_scan(trainer: Trainer, batch, steps: int) -> tuple[float, float]:
    """(seconds per step of a second ``scan_steps`` call of ``steps``
    steps, after one to warm up; the last loss)."""
    device = trainer.device
    batches = tuple(x.expand(steps, *x.shape) for x in batch)
    state, _ = trainer.scan_steps(trainer.init(), batches)
    _sync(device)
    start = time.perf_counter()
    state, losses = trainer.scan_steps(state, batches)
    _sync(device)
    return (time.perf_counter() - start) / steps, float(losses[-1])


def fused_kernel_probe(device: torch.device, d: int = 256, rows: int = 512) -> dict[str, Any]:
    """Fused kernels against the plain expressions they fuse, per family
    (``cov_ema``, ``ns``, ``klclip``): the p50 of 9 synchronised calls
    after one warm call, and each variant's device milliseconds from
    ``torch.profiler`` passes (:func:`_device_ms`) with a
    ``fused_probe.{family}_{variant}`` scope around it. On the CPU both variants are plain versions
    (``plain_versions``) and no device time is taken."""
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(rows, d, generator=gen).to(device)
    eye = torch.eye(d, device=device)
    cov = a.T @ a / rows + 0.003 * eye
    x0 = eye / torch.trace(cov)
    mx0 = cov @ x0
    gmat = 0.5 * cov + 0.1 * eye
    beta, coeff = 0.95, 0.05 / rows

    def ema_unfused(f, x):
        return beta * f + coeff * (x.T @ x)

    def ns_unfused(m, x, mx):
        y = x @ (2.0 * eye - mx)
        my = m @ y
        return y, my, torch.linalg.norm(eye - my) / math.sqrt(d)

    def kl_unfused(p, g):
        return p * torch.sum(p * g)

    def kl_fused(p, g):
        return klclip.klclip_scale(p, klclip.klclip_dot(p, g))

    families = {
        'cov_ema': (ema_unfused, lambda f, x: cov_ema.sym_cov_ema(f, x, beta, coeff), (eye, a)),
        'ns': (ns_unfused, newton_schulz.fused_ns_step, (cov, x0, mx0)),
        'klclip': (kl_unfused, kl_fused, (cov, gmat)),
    }

    def p50_ms(fn, args, n=9):
        fn(*args)
        _sync(device)
        times = []
        for _ in range(n):
            _sync(device)
            t0 = time.perf_counter()
            fn(*args)
            _sync(device)
            times.append(time.perf_counter() - t0)
        return sorted(times)[n // 2] * 1e3

    out: dict[str, Any] = {
        'config': f'd{d}_rows{rows}', 'plain_versions': device.type != 'cuda',
    }
    variants = {}
    for fam, (unfused, fused, args) in families.items():
        variants[f'fused_probe.{fam}_unfused'] = (unfused, args)
        row = {'unfused_p50_ms': p50_ms(unfused, args)}
        try:
            row['fused_p50_ms'] = p50_ms(fused, args)
            row['speedup'] = row['unfused_p50_ms'] / row['fused_p50_ms']
            variants[f'fused_probe.{fam}_fused'] = (fused, args)
        except Exception as exc:  # one variant's failure costs one row
            row['fused_error'] = f'{type(exc).__name__}: {exc}'
        out[fam] = row
    if device.type == 'cuda':
        out.update(_device_ms(variants, device))
    return out


# the kernel of ``marker.bitwise_not_()`` on an int32 tensor, which no
# variant launches: it bounds each variant's run on the device's timeline
MARKER_KERNEL = 'bitwise_not'


def split_device_runs(events: list[tuple[float, float, str]], scopes: list[str]) -> dict[str, Any]:
    """``{'device_ms': {scope: ms}, 'device_events': {scope: n}}`` from
    device events ``(start_us, end_us, name)`` of one stream: in time
    order, the events between two marker kernels are one scope's, and those
    before the first marker or after the last are none's. ``trace_error``
    unless there are ``len(scopes) + 1`` markers and no scope's run is
    empty."""
    runs: list[list[float]] = []
    for start, end, name in sorted(events):
        if MARKER_KERNEL in name:
            runs.append([])
        elif runs:
            runs[-1].append(end - start)
    if len(runs) != len(scopes) + 1 or not all(runs[:-1]):
        return {'trace_error': (
            f'{len(runs)} markers for {len(scopes)} scopes; device events after '
            f'each: {[len(r) for r in runs]}'
        )}
    runs.pop()
    return {
        'device_ms': {name: sum(run) / 1e3 for name, run in zip(scopes, runs)},
        'device_events': {name: len(run) for name, run in zip(scopes, runs)},
    }


# profiled passes of the probe's variants at most: the trace of one pass
# can lack device records, so two passes in a row must agree
DEVICE_PASSES = 4
# kernels launched at the start of a pass's active cycle, before its first
# marker, and at its end, after its last, each after or before this many
# idle seconds: on the card a trace has lacked its first device records
# (more than a hundred) and its last few
PAD_KERNELS = 100
PAD_SECONDS = 0.01


def _device_ms(variants: dict, device: torch.device) -> dict[str, Any]:
    """Each variant's device milliseconds from ``torch.profiler`` passes.

    The profiler does not link the kernels launched through ``ctypes`` or
    Triton's launcher to the enclosing ``record_function``, and its host
    and device clocks are not aligned to the microsecond. So a marker
    kernel comes before the first variant and after each, on the same
    stream, and the device's own timeline is split at the markers
    (:func:`split_device_runs`). Traces on the card have lacked their
    first device records (the first marker and the first scope's kernels)
    and their last (from within the last scopes on): each pass starts and
    ends with ``PAD_SECONDS`` idle and ``PAD_KERNELS`` kernels of no
    scope's, and counts only when the pass before it found as many kernels
    in every scope.
    ``device_passes`` says how many passes ran.
    """
    last: dict[str, Any] = {}
    for passes in range(1, DEVICE_PASSES + 1):
        try:
            split = split_device_runs(_profiled_pass(variants, device), list(variants))
        except Exception as exc:  # the timing rows stand without the trace
            return {'trace_error': f'{type(exc).__name__}: {exc}', 'device_passes': passes}
        if 'device_ms' in split and split['device_events'] == last.get('device_events'):
            return {**split, 'device_passes': passes}
        last = split
    return {
        'trace_error': f'no two passes in a row of {DEVICE_PASSES} agreed; last: {last}',
        'device_passes': DEVICE_PASSES,
    }


def _profiled_pass(
    variants: dict, device: torch.device, pad_seconds: float = PAD_SECONDS
) -> list[tuple[float, float, str]]:
    """Device events ``(start_us, end_us, name)`` of one call of each
    variant in its ``record_function`` scope, a marker kernel before the
    first and after each. A warm-up cycle of the profiler and
    ``pad_seconds`` idle and ``PAD_KERNELS`` kernels come first, and
    ``PAD_KERNELS`` kernels and ``pad_seconds`` idle last."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    marker = torch.zeros(1, dtype=torch.int32, device=device)
    pad = torch.zeros(1, device=device)
    events: list[tuple[float, float, str]] = []

    def keep(prof) -> None:  # the active cycle's device activity, less the
        # annotations the scopes and the profiler's step leave on the device
        events.extend(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if str(e.device_type).endswith('CUDA')
            and not getattr(e, 'is_user_annotation', False)
            and e.name not in variants and not e.name.startswith('ProfilerStep')
        )

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=keep,
    ) as prof:
        marker.bitwise_not_()
        _sync(device)
        prof.step()  # the warm-up cycle ends
        time.sleep(pad_seconds)
        for _ in range(PAD_KERNELS):
            pad.add_(1.0)
        _sync(device)
        marker.bitwise_not_()
        for name, (fn, args) in variants.items():
            with record_function(name):
                fn(*args)
            marker.bitwise_not_()
        for _ in range(PAD_KERNELS):
            pad.add_(1.0)
        _sync(device)
        time.sleep(pad_seconds)
        prof.step()  # the active cycle ends and ``keep`` reads it
    return events


def probe_trainer(
    device: torch.device, d: int = 512, window: int = 8, **kfac_kw: Any
) -> tuple[Trainer, tuple[torch.Tensor, torch.Tensor]]:
    """The async spike probe's loop: an MLP with features ``(d, d, d)`` and
    32 classes (weights from seed 5), one batch of 256 (inputs and targets
    from seeds 3 and 4), MSE, SGD(0.05), K-FAC with damping 1e-3, lr 0.1
    and cadence ``window``/``window``, and ``kfac_kw``. Returns the Trainer
    and the batch."""
    model = MLP(d, (d, d, d), 32, seed=5, device=device)
    x = torch.randn(256, d, generator=torch.Generator().manual_seed(3)).to(device)
    y = torch.randn(256, 32, generator=torch.Generator().manual_seed(4)).to(device)
    kfac = KFACPreconditioner(
        register_model(model, device=device), damping=1e-3, lr=0.1,
        factor_update_steps=window, inv_update_steps=window, device=device, **kfac_kw,
    )

    def loss_fn(ms, batch):
        return torch.mean((model(batch[0]) - batch[1]) ** 2), ms

    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.05), loss_fn, kfac=kfac, device=device,
    )
    return trainer, (x, y)


def async_spike_probe(
    device: torch.device, d: int = 512, window: int = 8, windows: int = 3
) -> dict[str, Any]:
    """Per-step times of :func:`probe_trainer`'s loop under the synchronous
    refresh and under ``async_inverse='sliced'``: one warm window (and
    step), then ``windows`` timed windows, each step between two
    synchronises.

    Returns the bench's keys: ``step_{p50,p95,max}_ms`` and
    ``refresh_spike_ratio`` (max step over median step) of the sliced
    series, the same with ``_sync`` of the synchronous one, and
    ``async_probe_config``.
    """

    def series(async_inverse) -> np.ndarray:
        trainer, batch = probe_trainer(device, d, window, async_inverse=async_inverse)
        state = trainer.init()
        for _ in range(window + 1):  # one full warm window
            state, _ = trainer.step(state, batch)
        _sync(device)
        times = []
        for _ in range(window * windows):
            t0 = time.perf_counter()
            state, _ = trainer.step(state, batch)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(times)

    t_sync = series(None)
    t_sliced = series('sliced')

    def stats(suffix: str, ts: np.ndarray) -> dict[str, float]:
        return {
            f'step_p50_ms{suffix}': float(np.percentile(ts, 50)),
            f'step_p95_ms{suffix}': float(np.percentile(ts, 95)),
            f'step_max_ms{suffix}': float(np.max(ts)),
            f'refresh_spike_ratio{suffix}': float(np.max(ts) / np.median(ts)),
        }

    return {
        'async_probe_config': f'mlp_d{d}_b256_w{window}',
        **stats('', t_sliced), **stats('_sync', t_sync),
    }


@contextlib.contextmanager
def one_rank_world(device: torch.device) -> Iterator[None]:
    """A ``torch.distributed`` world of this process alone, joined by a
    ``file://`` store in a temporary directory as ``spawn_world`` joins
    its ranks (NCCL on a card, gloo on the CPU), destroyed on exit, so it
    does not outlive the caller. Refuses to run inside another world."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError('one_rank_world needs no torch.distributed world to be running')
    with tempfile.TemporaryDirectory(prefix='kfac_probe_') as tmp:
        dist.init_process_group(
            'nccl' if device.type == 'cuda' else 'gloo',
            init_method='file://' + os.path.join(tmp, 'rendezvous'), world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=300),
        )
        try:
            yield
        finally:
            dist.destroy_process_group()


def compression_probe(device: torch.device, d: int = 256, steps: int = 24) -> dict[str, Any]:
    """The compressed transport and the cold-factor offload, as the bench's
    ``_compression_probe``: an MLP with features ``(d, d)`` and 16 classes
    (weights from seed 8, a batch of 128 from seeds 6 and 7), MSE.

    A ``DistributedKFAC`` (COMM-OPT, ``allreduce_bucketed``, damping 1e-3,
    lr 0.1, cadence 1/1) in a world of one rank (:func:`one_rank_world`)
    at the f32 and the int8 wire: the static wire ratio and bytes of
    ``comms_report()``, and the median of 10 eager steps (capture and
    engine step, fixed weights) after one untimed. Then a dense offload
    Trainer (cadence 8/8, ``min_cold_steps=2``, ``prefetch_lead=1``,
    SGD(0.05)) for ``steps`` steps, and its offload counters with
    ``prefetch_hit_rate``."""
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh

    model = MLP(d, (d, d), 16, seed=8, device=device)
    x = torch.randn(128, d, generator=torch.Generator().manual_seed(6)).to(device)
    y = torch.randn(128, 16, generator=torch.Generator().manual_seed(7)).to(device)
    reg = register_model(model, device=device)

    def loss_fn(ms, batch):
        return torch.mean((model(batch[0]) - batch[1]) ** 2), ms

    run = CurvatureCapture(reg).value_stats_and_grad(loss_fn, has_aux=True)
    out: dict[str, Any] = {'compression_probe_config': f'mlp_d{d}_b128_bucketed'}
    with one_rank_world(device):
        mesh = kaisa_mesh(1.0, device=device)
        series = {}
        for name, comp in (('f32', None), ('int8', 'int8')):
            eng = DistributedKFAC(KFACPreconditioner(
                reg, damping=1e-3, lr=0.1, allreduce_method='allreduce_bucketed',
                stat_compression=comp, device=device,
            ), mesh)
            state = eng.init()
            times = []
            for i in range(11):
                _sync(device)
                t0 = time.perf_counter()
                (loss, _), grads, stats = run(None, (x, y))
                state, pg = eng.step(state, grads, stats, loss=loss)
                _sync(device)
                if i:  # the first step is the untimed warm-up
                    times.append((time.perf_counter() - t0) * 1e3)
            series[name] = (float(np.median(times)), eng.comms_report()['stat_transport'])
    out.update(
        wire_ratio_int8=round(series['int8'][1]['raw_bytes'] / series['int8'][1]['wire_bytes'], 3),
        stat_wire_bytes_f32=series['f32'][1]['wire_bytes'],
        stat_wire_bytes_int8=series['int8'][1]['wire_bytes'],
        step_p50_ms_f32_wire=round(series['f32'][0], 3),
        step_p50_ms_int8_wire=round(series['int8'][0], 3),
    )
    kfac = KFACPreconditioner(
        reg, damping=1e-3, lr=0.1, factor_update_steps=8, inv_update_steps=8,
        offload=OffloadConfig(min_cold_steps=2, prefetch_lead=1), device=device,
    )
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.05), loss_fn, kfac=kfac, device=device,
    )
    tstate = trainer.init()
    for _ in range(steps):
        tstate, _ = trainer.step(tstate, (x, y))
    _sync(device)
    counters = dict(kfac._offload_manager.stats)
    attempts = counters['prefetch_hits'] + counters['prefetch_misses']
    counters['prefetch_hit_rate'] = round(counters['prefetch_hits'] / attempts, 3) if attempts else None
    out['offload'] = counters
    return out


def flops_per_step(model: torch.nn.Module, cfg: dict) -> tuple[int, float]:
    """(parameter count, model FLOPs of one step): 6 per matmul parameter
    per token (forward and backward) plus 12 L d S per token for the
    attention scores and values, as the bench counts. The embedding tables
    are gathers, not matmuls; the output head is a matmul and counts."""
    n_params = n_matmul = 0
    for name, p in model.named_parameters():
        n_params += p.numel()
        if 'embed' not in name:
            n_matmul += p.numel()
    tokens = cfg['batch'] * cfg['seq']
    return n_params, tokens * (6 * n_matmul + 12 * cfg['layers'] * cfg['d_model'] * cfg['seq'])


def run_lm_stage(
    config_name: str,
    device: str | torch.device = 'cuda',
    warmup: int = 5,
    iters: int = 100,
    scan_steps: int = 100,
    dtype: torch.dtype | None = None,
    probes: bool = True,
) -> dict[str, Any]:
    """Measure SGD vs K-FAC LM throughput at one config in ``dtype`` (None:
    :func:`default_dtype`); returns the record. ``probes=False`` leaves out
    the fused-kernel, async spike and compression probes."""
    device = resolve_device(device)
    cfg = LM_CONFIGS[config_name]
    on_cuda = device.type == 'cuda'
    dtype = default_dtype(device) if dtype is None else dtype
    peak, peak_name = PEAK_FLOPS[dtype]
    result: dict[str, Any] = {
        'stage': f'lm_{config_name}',
        'platform': 'gpu' if on_cuda else 'cpu',
        'device_kind': torch.cuda.get_device_name(device) if on_cuda else 'cpu',
        'model_config': (
            f'{"gpu_lm" if on_cuda else "cpu_smoke"}_L{cfg["layers"]}_d{cfg["d_model"]}'
            f'_s{cfg["seq"]}_b{cfg["batch"]}_v{cfg["vocab"]}'
        ),
        'dtype': str(dtype).removeprefix('torch.'),
        'window': dict(warmup=warmup, iters=iters, scan_steps=scan_steps),
    }
    batch = lm_batch(cfg, device)
    tokens = cfg['batch'] * cfg['seq']

    t_sgd, sgd_loss = time_steps(
        lm_trainer(cfg, device, kfac=False, dtype=dtype), batch, warmup, iters
    )
    kfac_trainer = lm_trainer(cfg, device, kfac=True, dtype=dtype)
    t_kfac, eager_loss = time_steps(kfac_trainer, batch, warmup, iters)
    t_scan, scan_loss = time_scan(
        lm_trainer(cfg, device, kfac=True, dtype=dtype), batch, scan_steps
    )
    n_params, flops = flops_per_step(kfac_trainer.model, cfg)

    # headline: the faster K-FAC stepping mode; both are recorded
    t_best = min(t_kfac, t_scan)
    result.update(
        sgd_tokens_per_sec=tokens / t_sgd,
        eager_tokens_per_sec=tokens / t_kfac,
        scan_tokens_per_sec=tokens / t_scan,
        value=tokens / t_best,
        vs_baseline=t_sgd / t_best,
        step_ms=dict(sgd=t_sgd * 1e3, eager=t_kfac * 1e3, scan=t_scan * 1e3),
        last_loss=dict(sgd=sgd_loss, eager=eager_loss, scan=scan_loss),
        n_params=n_params,
        flops_per_step=flops,
        mfu=flops / t_best / peak if on_cuda else None,
        sgd_mfu=flops / t_sgd / peak if on_cuda else None,
        mfu_peak=peak_name if on_cuda else None,
        compute_method=kfac_trainer.kfac.compute_method.name,
    )
    if not probes:
        return result
    result['fused_kernel_probe'] = fused_kernel_probe(device)
    result['async_spike_probe'] = async_spike_probe(device)
    result['compression_probe'] = compression_probe(device)
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', choices=sorted(LM_CONFIGS), default='tiny')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--warmup', type=int, default=5)
    parser.add_argument('--iters', type=int, default=100)
    parser.add_argument('--scan-steps', type=int, default=100)
    parser.add_argument(
        '--dtype', choices=sorted(DTYPES), default=None,
        help='the model\'s compute dtype (default: bf16 on cuda, f32 on the cpu)',
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        print(nvidia_smi(), flush=True)
    record = run_lm_stage(
        args.config, device, args.warmup, args.iters, args.scan_steps,
        None if args.dtype is None else DTYPES[args.dtype],
    )
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
