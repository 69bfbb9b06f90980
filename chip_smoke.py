#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``env``: torch and CUDA versions, the card, TF32 off for matmul and
   cuDNN (every f32 product here is full f32).
2. ``build``: the CUDA kernels built from ``kfac_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and the time it took.
3. ``kernel``: each hand-written kernel, called through the wrapper the
   model calls, at the flagship shapes its main path gives it, held
   against its plain PyTorch version with the stated tolerance, and timed
   with CUDA events beside the plain version, one PyTorch library call as
   a yardstick, and the least time the H100 could take (bytes over 3.35
   TB/s or f32 FLOPs over 67 TFLOP/s, whichever is larger). Each tolerance
   must also reject a control: the plain version at reduced precision
   (TF32 matmuls, or bf16 products), so a kernel that drops below f32
   fails the check.
4. ``reference``: a two-layer model trained three steps on the card
   (kernels) and on the CPU (plain versions) from the same weights; losses
   and preconditioned gradients must agree.
5. ``main_path``: the flagship TransformerLM (batch 16, seq 512, d_model
   512, 6 layers, 4 heads, vocab 8192, f32) through register_model ->
   CurvatureCapture -> KFACPreconditioner(damping 0.003, lr 0.1, cadence
   10/100, EIGEN) -> SGD(0.1, momentum 0.9) for 20 steps on one seeded
   batch, with the kernels' launch counts set to 0 just before and read
   just after; then one more capture step and one plain step under
   torch.profiler (``profile``: device time by kernel, idle share).

Then the card's name and power limit as nvidia-smi prints them, the
``kernels`` line, and ``{"ok": true, "device": ...}`` as the last line.
Any failed phase makes the exit code 1 and suppresses the last line; no
CUDA card, or no package beside this script, exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores

FLAGSHIP = dict(batch=16, seq=512, d_model=512, layers=6, heads=4, vocab=8192)
STEPS = 20
# K-FAC layers of the flagship: q, k, v, out, fc1 and fc2 of every block
# (lm_head is skipped), fixed by the configuration, not read from the code
KFAC_LAYERS = 6 * FLAGSHIP['layers']


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_ms(fn) -> float:
    """Mean ms per call over a run of back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) / 3
    iters = max(5, min(200, int(0.2 / max(est, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ kernels


def tf32(fn):
    """``fn`` run with TF32 matmuls allowed: a reduced-precision control."""

    def run():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    return run


def max_err(got, want):
    """(max |got - want|, max |want|)."""
    return float((got - want).abs().max()), float(want.abs().max())


def kernel_cases():
    """One dict per (kernel, flagship shape): the wrapper's call, the plain
    and library calls, ``compare(got, want) -> (max abs error, reference
    scale)``, an invariant the kernel's result must hold, the relative
    tolerance against that scale, a reduced-precision control the
    tolerance must reject, and the bytes and FLOPs of the bound."""
    from kfac_tpu_torch.ops import flash_attention, klclip, sym_cov

    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = []
    # rows are the 8192 tokens of a step; A factors carry the bias column
    for d in (513, 2049, 512, 2048):
        a = randn(8192, d)
        cases.append(dict(
            name='sym_cov', shape=[8192, d],
            kernel=lambda a=a: sym_cov.sym_cov(a),
            plain=lambda a=a: sym_cov.sym_cov_plain(a),
            library=lambda a=a: torch.matmul(a.T, a),
            compare=max_err, invariant=lambda got: torch.equal(got, got.T),
            rtol=1e-5, tol_rule='1e-5 x max|C|, and exactly symmetric',
            control=tf32(lambda a=a: sym_cov.sym_cov_plain(a)),
            control_rule='plain version with TF32 matmuls',
            nbytes=4 * (8192 * d + d * d), flops=8192 * d * (d + 1),
        ))
    for r, c in ((512, 513), (2048, 513), (512, 2049)):
        p, g = randn(r, c), randn(r, c)
        s = torch.tensor(0.37, device=dev)

        def cmp_dot(got, want, p=p, g=g):
            return abs(float(got - want)), float((p * g).abs().sum())

        cases.append(dict(
            name='klclip_dot', shape=[r, c],
            kernel=lambda p=p, g=g: klclip.klclip_dot(p, g),
            plain=lambda p=p, g=g: klclip.klclip_dot_plain(p, g),
            library=lambda p=p, g=g: torch.sum(p * g),
            compare=cmp_dot, rtol=1e-7,
            # bit for bit from run to run
            invariant=lambda got, p=p, g=g: torch.equal(got, klclip.klclip_dot(p, g)),
            tol_rule='1e-7 x sum|p*g|, and run-to-run identical',
            control=lambda p=p, g=g: (p.bfloat16() * g.bfloat16()).float().sum(),
            control_rule='bf16 products, f32 sum',
            nbytes=4 * (2 * r * c + 1), flops=2 * r * c,
        ))
        cases.append(dict(
            name='klclip_scale', shape=[r, c],
            kernel=lambda p=p, s=s: klclip.klclip_scale(p, s),
            plain=lambda p=p, s=s: klclip.klclip_scale_plain(p, s),
            library=lambda p=p, s=s: p * s,
            compare=max_err, rtol=0.0, tol_rule='exact',
            control=lambda p=p, s=s: (p.bfloat16() * s).float(),
            control_rule='bf16 product',
            nbytes=4 * (2 * r * c + 1), flops=r * c,
        ))
    b, s_, h, dh = FLAGSHIP['batch'], FLAGSHIP['seq'], FLAGSHIP['heads'], 128
    q, k, v = randn(b, s_, h, dh), randn(b, s_, h, dh), randn(b, s_, h, dh)

    def cmp_flash(got, want):
        # the worst of acc, m and l relative to its own max
        return max(map(max_err, got, want), key=lambda p: p[0] / p[1])

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True
        )

    pairs = s_ * (s_ + 1) // 2  # visible (query, key) pairs of a causal row set
    cases.append(dict(
        name='flash_attention_partials', shape=[b, s_, h, dh],
        kernel=lambda: flash_attention.flash_attention_partials(q, k, v, 0, 0, True),
        plain=lambda: flash_attention.attend_partials_einsum(q, k, v, 0, 0, True),
        library=sdpa, compare=cmp_flash, rtol=1e-5,
        tol_rule='1e-5 x max|x| for each of acc, m, l',
        control=tf32(lambda: flash_attention.attend_partials_einsum(q, k, v, 0, 0, True)),
        control_rule='plain version with TF32 matmuls',
        nbytes=4 * (4 * b * s_ * h * dh + 2 * b * h * s_),
        flops=4 * dh * pairs * b * h,
    ))
    return cases


def run_kernels(results) -> bool:
    ok = True
    for case in kernel_cases():
        got = case['kernel']()
        torch.cuda.synchronize()
        want = case['plain']()
        err, ref = case['compare'](got, want)
        tol = case['rtol'] * ref
        holds = case.get('invariant', lambda got: True)(got)
        control_err, _ = case['compare'](case['control'](), want)
        rejects_control = control_err > tol
        passed = err <= tol and holds and rejects_control
        ms = time_ms(case['kernel'])
        plain_ms = time_ms(case['plain'])
        library_ms = time_ms(case['library'])
        bms, by = bound_ms(case['nbytes'], case['flops'])
        row = dict(
            phase='kernel', name=case['name'], shape=case['shape'],
            max_abs_err=err, max_rel_err=err / ref if ref else err, tol=tol,
            tol_rule=case['tol_rule'], invariant_holds=holds,
            control_rule=case['control_rule'],
            control_max_rel_err=control_err / ref if ref else control_err,
            rejects_control=rejects_control, passed=passed,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by,
        )
        emit(row)
        results.append(row)
        ok &= passed
    return ok


# --------------------------------------------------------------- main path


class LMTrainer:
    """The bench's K-FAC LM loop on one seeded batch, weights from seed 1:
    a capture step every ``capture_every`` steps, a plain step otherwise."""

    def __init__(self, cfg, device, capture_every, inv_every):
        import kfac_tpu_torch as kt
        from kfac_tpu_torch.layers.capture import value_and_grad
        from kfac_tpu_torch.models import TransformerLM, lm_loss

        self.kt, self.device = kt, device
        self.capture_every = capture_every
        self.model = TransformerLM(
            vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
            num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device,
        )
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        self.batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
        self.registry = kt.register_model(self.model, skip_layers=['lm_head'], device=device)
        self.kfac = kt.KFACPreconditioner(
            self.registry, damping=0.003, lr=0.1, factor_update_steps=capture_every,
            inv_update_steps=inv_every, device=device,
        )
        loss_fn = lm_loss(self.model)
        self.capture = kt.CurvatureCapture(self.registry).value_stats_and_grad(loss_fn)
        self.plain = value_and_grad(self.model, loss_fn)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9)
        self.state = self.kfac.init()

    def step(self, i):
        """Step ``i``; returns (loss, preconditioned grads, seconds)."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i % self.capture_every == 0:
            (loss, _), grads, stats = self.capture(self.batch)
        else:
            (loss, grads), stats = self.plain(self.batch), None
        self.state, pg = self.kfac.step(self.state, grads, stats)
        self.kt.set_grads(self.model, pg)
        self.opt.step()
        loss = float(loss)  # waits for the step's work
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        return loss, pg, time.perf_counter() - t0


def train(trainer, steps):
    """(losses, preconditioned grads, step seconds) of ``steps`` steps."""
    out = [trainer.step(i) for i in range(steps)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def profile_step(trainer, i) -> dict:
    """Device time by kernel over step ``i``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, seconds = trainer.step(i)
    kernels = [
        (evt.key, evt.self_device_time_total / 1e3, evt.count)
        for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    wall = seconds * 1e3
    return dict(
        step=i, kind='capture' if i % trainer.capture_every == 0 else 'plain',
        wall_ms_profiled=wall, device_busy_ms=busy,
        idle_share=(1 - busy / wall) if busy else 'not measured',
        top=[dict(kernel=k[:90], ms=ms, count=n) for k, ms, n in kernels[:15]],
    )


def run_reference() -> bool:
    """Kernels on the card vs plain versions on the CPU, small model."""
    cfg = dict(batch=4, seq=128, d_model=256, layers=2, heads=2, vocab=512)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    gl, gp, _ = train(LMTrainer(cfg, cuda, 2, 2), 3)
    cl, cp, _ = train(LMTrainer(cfg, cpu, 2, 2), 3)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = 0.0
    for g_step, c_step in zip(gp, cp):
        scale = max(float(v.abs().max()) for v in c_step.values())
        for n, c in c_step.items():
            grad_err = max(grad_err, float((g_step[n].cpu() - c).abs().max()) / scale)
    passed = loss_err <= 1e-4 and grad_err <= 1e-3
    emit(dict(
        phase='reference', config=cfg, steps=3, losses_cuda=gl, losses_cpu=cl,
        loss_rel_err=loss_err, loss_tol=1e-4, pgrad_err_rel_to_max=grad_err,
        pgrad_tol=1e-3, passed=passed,
    ))
    return passed


def run_main_path(launches) -> bool:
    from kfac_tpu_torch.ops import flash_attention, klclip, sym_cov

    wrappers = {
        'sym_cov': sym_cov.sym_cov,
        'klclip_dot': klclip.klclip_dot,
        'klclip_scale': klclip.klclip_scale,
        'flash_attention_partials': flash_attention.flash_attention_partials,
    }
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    trainer = LMTrainer(FLAGSHIP, torch.device('cuda'), 10, 100)
    losses, _, seconds = train(trainer, STEPS)
    launches.update({n: w.launches for n, w in wrappers.items()})
    layers, captures = len(trainer.registry), len(range(0, STEPS, 10))
    expected = {
        'sym_cov': 2 * KFAC_LAYERS * captures,
        'klclip_dot': KFAC_LAYERS * STEPS,
        'klclip_scale': KFAC_LAYERS * STEPS,
        'flash_attention_partials': FLAGSHIP['layers'] * STEPS,
    }
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    plain_ms = sorted(s * 1e3 for i, s in enumerate(seconds) if i % 10 and i > 10)
    passed = finite and falling and layers == KFAC_LAYERS and launches == expected
    emit(dict(
        phase='main_path', config=FLAGSHIP, steps=STEPS, registered_layers=layers,
        expected_layers=KFAC_LAYERS,
        losses=losses, finite=finite, loss_falls=falling,
        step_ms=[s * 1e3 for s in seconds],
        capture_step_ms=seconds[10] * 1e3,
        plain_step_ms_median=plain_ms[len(plain_ms) // 2],
        tokens_per_step=FLAGSHIP['batch'] * FLAGSHIP['seq'],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, expected_launches=expected, passed=passed,
    ))
    # after the counted run: one more capture step and one plain step
    emit(dict(phase='profile', steps=[
        profile_step(trainer, STEPS), profile_step(trainer, STEPS + 1),
    ]))
    return passed


SOURCES = {
    'sym_cov': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov.py:88', [8192, 2049]),
    'klclip_dot': ('triton', 'kfac_tpu_torch/ops/klclip_triton.py', 'kfac_tpu/ops/pallas_ns.py:219', [2048, 513]),
    'klclip_scale': ('triton', 'kfac_tpu_torch/ops/klclip_triton.py', 'kfac_tpu/ops/pallas_ns.py:244', [2048, 513]),
    'flash_attention_partials': ('cuda', 'kfac_tpu_torch/csrc/flash_attn.cu', 'kfac_tpu/ops/pallas_attention.py:257', [16, 512, 4, 128]),
}


def kernels_line(results, launches) -> dict:
    out = []
    for name, (route, source, replaces, shape) in SOURCES.items():
        rows = [r for r in results if r['name'] == name]
        row = next((r for r in rows if r['shape'] == shape), None)
        if row is None:
            continue
        out.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=max(r['max_abs_err'] for r in rows), shape=shape,
            ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
            bound_by=row['bound_by'], library_ms=row['library_ms'],
        ))
    return {'kernels': out}


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kfac_tpu_torch.ops import build
    except ImportError as exc:
        print(f'chip_smoke: the kfac_tpu_torch package is missing: {exc}', file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(dict(
        phase='env', torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
    ))

    ok = True
    results: list[dict] = []
    launches: dict[str, int] = {}

    def phase(name, fn, *args):
        nonlocal ok
        try:
            passed = fn(*args)
        except Exception:  # report the phase's failure and go on to the next
            traceback.print_exc()
            emit(dict(phase=name, passed=False, error=traceback.format_exc(limit=3)))
            passed = False
        ok &= bool(passed)

    def do_build():
        t0 = time.perf_counter()
        report = build.build()
        ptxas = {
            n: [ln for ln in r['ptxas'].splitlines() if 'registers' in ln or 'spill' in ln]
            for n, r in report.items()
        }
        emit(dict(phase='build', seconds=time.perf_counter() - t0, ptxas=ptxas, passed=True))
        return True

    phase('build', do_build)
    phase('kernel', run_kernels, results)
    phase('reference', run_reference)
    phase('main_path', run_main_path, launches)
    print(smi, flush=True)
    emit(kernels_line(results, launches))
    if not ok:
        print('chip_smoke: a phase failed', file=sys.stderr)
        return 1
    emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }})
    return 0


if __name__ == '__main__':
    sys.exit(main())
