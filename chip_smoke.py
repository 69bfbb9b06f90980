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
   model calls, at the shapes its main path gives it, held
   against its plain PyTorch version with the stated tolerance, and timed
   with CUDA events beside the plain version, one PyTorch library call as
   a yardstick, and the least time the H100 could take (bytes over 3.35
   TB/s or f32 FLOPs over 67 TFLOP/s, whichever is larger; for the kernels
   on the tensor cores, ``sym_cov``, ``sym_cov_ema``, the flash partials
   and ``fused_ns_step``, the operations are their 3xTF32 work at 495
   TFLOP/s, with the f32 bound beside; the covariance kernels' time at
   the other form of the split, unsplit or split, beside the planned one;
   the Newton-Schulz step's output tile). Each tolerance must also reject
   a control: the plain version at reduced precision (TF32 matmuls, or
   bf16 products), so a kernel that drops below f32 fails the check. The
   kl-clip kernels also report their device ms from torch.profiler: back
   to back, their CUDA-event times are the host's enqueue. Both are timed
   at each layer's shape and as the engine calls them, once over the
   flagship's 36 layers: the dot with its terms' sum and the scale
   (``library_ms`` is then the 36 ``torch.sum(p * g)`` calls it replaces),
   the scale in place (out of place and ``_foreach_mul_`` beside).
4. ``reference``: a two-layer model trained three steps through
   ``Trainer.step`` on the card (kernels) and on the CPU (plain versions)
   from the same weights, once with EIGEN, once with INVERSE +
   Newton-Schulz and once with INVERSE + 'auto' (cadence 2/2, so the
   refresh at step 2 warm-starts); then EIGEN through
   ``Trainer.scan_steps`` and through ``Trainer.step_accumulate`` over two
   micro-batches. Losses and preconditioned grads must agree.
5. ``main_path``: the flagship TransformerLM (batch 16, seq 512, d_model
   512, 6 layers, 4 heads, vocab 8192, f32) through register_model ->
   KFACPreconditioner(damping 0.003, lr 0.1, cadence 10/100, EIGEN) ->
   ``Trainer.step`` (capture on cadence, SGD(0.1, momentum 0.9)) for 20
   steps on one seeded batch, with the kernels' launch counts set to 0
   just before and read just after; then one more capture step and one
   plain step under torch.profiler (``profile``: device time by kernel,
   idle share).
6. ``main_path_ns``: the same flagship with INVERSE + Newton-Schulz for
   110 steps, so the inverse refreshes at step 0 (cold start) and step 100
   (warm start from the step-0 inverses), counts set to 0 just before and
   read just after; every factor's inverse is checked after each refresh
   by an independent residual. Then the step-100 refresh is repeated from
   the same factors and starting inverses, once timed and once under
   torch.profiler (``profile_ns``).
7. ``bench_lm``: the bench's LM stage (``kfac_tpu_torch.bench_lm``) in
   process for ``tiny`` and then ``flagship``, counts set to 0 before each
   and read after: every rate finite and positive, every fused-kernel
   probe family timed without error, and every kernel launched exactly as
   often as the configuration says (``sym_cov_ema`` by the probe).

Then the card's name and power limit as nvidia-smi prints them, the
``kernels`` line, and ``{"ok": true, "device": ...}`` as the last line.
Any failed phase makes the exit code 1 and suppresses the last line; no
CUDA card, or no package beside this script, exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense

FLAGSHIP = dict(batch=16, seq=512, d_model=512, layers=6, heads=4, vocab=8192)
STEPS = 20
NS_STEPS = 110  # inverse refreshes at 0 (cold) and 100 (warm)
# NS kernel vs plain, relative, for x_new, mx_new and the residual: between
# the f32 kernel's worst reading (6.2e-6) and the TF32 control's least
# (5.9e-4 of max|x_new|) on an H100 (PERF.md, Findings)
NS_RTOL = 3e-5
# K-FAC layers of the flagship: q, k, v, out, fc1 and fc2 of every block
# (lm_head is skipped), fixed by the configuration, not read from the code
KFAC_LAYERS = 6 * FLAGSHIP['layers']
# their preconditioned gradients, (d_out, d_in + bias): q, k, v and out of
# each block, then fc1, then fc2
FLAGSHIP_PMATS = [(512, 513)] * 24 + [(2048, 513)] * 6 + [(512, 2049)] * 6
# the grouped kl-clip dot's two kernels (csrc/klclip.cu)
DOT_KERNELS = ('klclip_dot_multi_kernel', 'klclip_dot_final_kernel')


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(
    nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S
) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def with_plan(fn, forced):
    """``fn`` run with ``sym_cov.plan`` giving ``forced``: the wrapper's own
    call, host work included, at another split."""
    from kfac_tpu_torch.ops import sym_cov

    def run():
        planned = sym_cov.plan
        sym_cov.plan = lambda n, d, sms: forced
        try:
            return fn()
        finally:
            sym_cov.plan = planned

    return run


def kernel_cases():
    """One dict per (kernel, flagship shape): the wrapper's call, the plain
    and library calls, ``compare(got, want) -> (max abs error, reference
    scale)``, an invariant the kernel's result must hold, the relative
    tolerance against that scale, a reduced-precision control the
    tolerance must reject, and the bytes and FLOPs of the bound."""
    from kfac_tpu_torch.ops import cov_ema, flash_attention, klclip, newton_schulz, sym_cov

    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = []
    sms = sym_cov.sm_count(torch.cuda.current_device())

    def split_fields(n, d, kernel):
        """The plan's split, and ``also_timed``: the same wrapper call with
        all N rows in one slice where the plan splits (``ms_unsplit``), or
        with ``wave_plan``'s split where the plan leaves it whole
        (``ms_split``)."""
        p = sym_cov.plan(n, d, sms)
        whole = sym_cov.CovPlan(n, d, 1, -(-n // sym_cov.SLAB_ROWS) * sym_cov.SLAB_ROWS)
        wave = sym_cov.wave_plan(n, d, sms)
        if p.splits > 1:
            timed = dict(ms_unsplit=with_plan(kernel, whole))
        else:
            timed = {} if wave.splits == 1 else dict(ms_split=with_plan(kernel, wave))
        return dict(splits=p.splits, scratch_mib=p.scratch_bytes / 2**20), timed

    # rows are the 8192 tokens of a step; A factors carry the bias column.
    # (77, 130): ragged N and D, three 64-wide tiles, one slice per 32-row
    # slab. (512, 129) and (512, 513): the tiny bench's factors; (1024, 129):
    # the shortest N the plan splits.
    for n, d in ((8192, 513), (8192, 2049), (8192, 512), (8192, 2048), (77, 130),
                 (512, 129), (512, 513), (1024, 129)):
        a = randn(n, d)
        extra, also_timed = split_fields(n, d, lambda a=a: sym_cov.sym_cov(a))
        cases.append(dict(
            name='sym_cov', shape=[n, d],
            kernel=lambda a=a: sym_cov.sym_cov(a),
            plain=lambda a=a: sym_cov.sym_cov_plain(a),
            library=lambda a=a: torch.matmul(a.T, a),
            compare=max_err, rtol=1e-5,
            tol_rule='1e-5 x max|C|, exactly symmetric and run-to-run identical',
            control=tf32(lambda a=a: sym_cov.sym_cov_plain(a)),
            control_rule='plain version with TF32 matmuls',
            nbytes=4 * (n * d + d * d), flops=n * d * (d + 1), tf32x3=True,
            # bit for bit from run to run as well
            invariant=lambda got, a=a: (
                torch.equal(got, got.T) and torch.equal(got, sym_cov.sym_cov(a))
            ),
            extra=extra, also_timed=also_timed,
        ))
    # the flagship's factor widths, the fused-kernel probe's (512, 256) and a
    # ragged shape. F is a covariance, so symmetric, as the contract asks.
    # The blend scales the product's error by coeff, so the tolerance is
    # relative to max|coeff a^T a|, not to max|out| (which F dominates).
    for n, d in ((8192, 513), (8192, 2049), (512, 256), (77, 130)):
        a, f = randn(n, d), sym_cov.sym_cov_plain(randn(n, d))
        beta, coeff = 0.95, 0.05 / n
        scale = float((coeff * (a.T @ a)).abs().max())
        extra, also_timed = split_fields(
            n, d, lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema(f, a, b, c)
        )

        def cmp_ema(got, want, scale=scale):
            return float((got - want).abs().max()), scale

        cases.append(dict(
            name='sym_cov_ema', shape=[n, d],
            kernel=lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema(f, a, b, c),
            plain=lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema_plain(f, a, b, c),
            library=lambda a=a, f=f, b=beta, c=coeff: torch.addmm(f, a.T, a, beta=b, alpha=c),
            compare=cmp_ema,
            # bit for bit from run to run as well
            invariant=lambda got, a=a, f=f, b=beta, c=coeff: (
                torch.equal(got, got.T) and torch.equal(got, cov_ema.sym_cov_ema(f, a, b, c))
            ),
            rtol=1e-5,
            tol_rule='1e-5 x max|coeff a^T a|, exactly symmetric and run-to-run identical',
            control=tf32(lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema_plain(f, a, b, c)),
            control_rule='plain version with TF32 matmuls',
            # a and the upper triangle of the symmetric F read once, the
            # output written once; the upper triangle's products and the
            # blend of each upper element
            nbytes=4 * (n * d + d * (d + 1) // 2 + d * d),
            flops=n * d * (d + 1) + 3 * d * (d + 1) // 2, tf32x3=True,
            extra=extra, also_timed=also_timed,
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
            # one sum's rounding errors can cancel by chance (the bf16 dot
            # once read 6.9e-8 of sum|p*g| at (2048, 513)), so the control is
            # held to the rule on each of 8 row blocks and the worst counts
            control=lambda p=p, g=g: [
                (x.bfloat16() * y.bfloat16()).float().sum() for x, y in zip(p.chunk(8), g.chunk(8))
            ],
            control_compare=lambda ctrl, p=p, g=g: max(
                abs(float(b - klclip.klclip_dot_plain(x, y))) / float((x * y).abs().sum())
                for b, x, y in zip(ctrl, p.chunk(8), g.chunk(8))
            ),
            control_rule='bf16 products, f32 sum, worst of 8 row blocks',
            nbytes=4 * (2 * r * c + 1), flops=2 * r * c,
            device_kernels=DOT_KERNELS,
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
            device_kernels=('klclip_scale_multi_kernel',),
        ))
    # the engine's one launch a step: every K-FAC layer's preconditioned
    # gradient of the flagship (q, k, v, out; fc1; fc2 of 6 blocks)
    ps = [randn(*shape) for shape in FLAGSHIP_PMATS]
    gs = [randn(*shape) for shape in FLAGSHIP_PMATS]
    s = torch.tensor(0.37, device=dev)
    numel = sum(p.numel() for p in ps)
    lr, kl_clip = 0.1, 0.001  # the flagship's

    def cmp_grouped(got, want):
        # vg_sum against the sum over the layers of lr^2 sum|p*g|
        ref = sum(float((p * g).abs().sum()) for p, g in zip(ps, gs)) * lr**2
        return abs(float(got[1] - want[1])), ref

    def grouped_holds(got):
        terms, vg, scale = got
        again = klclip.klclip_dot_many(ps, gs, lr, kl_clip)
        fold = sum(terms.unbind())  # Python's sum, as the engine's plain path
        return (
            all(torch.equal(x, y) for x, y in zip(got, again))
            and torch.equal(vg, fold)
            and torch.equal(scale, klclip.kl_clip_scale_plain(fold, kl_clip))
        )

    cases.append(dict(
        name='klclip_dot', shape=[len(ps), numel],
        kernel=lambda: klclip.klclip_dot_many(ps, gs, lr, kl_clip),
        plain=lambda: klclip.klclip_dot_many_plain(ps, gs, lr, kl_clip),
        # one PyTorch call a layer, the engine's expression before this kernel
        library=lambda: [torch.sum(p * g) for p, g in zip(ps, gs)],
        extra=dict(library_call='torch.sum(p * g), once for each of the 36 layers'),
        compare=cmp_grouped, rtol=1e-7, invariant=grouped_holds,
        tol_rule='vg_sum within 1e-7 x sum of lr^2 sum|p*g|; terms, vg_sum and scale '
                 'run-to-run identical; vg_sum the fold of the terms and the scale the '
                 'plain expression over it, bit for bit',
        control=lambda: [(p.bfloat16() * g.bfloat16()).float().sum() for p, g in zip(ps, gs)],
        control_compare=lambda ctrl: max(
            abs(float(b - klclip.klclip_dot_plain(p, g))) / float((p * g).abs().sum())
            for b, p, g in zip(ctrl, ps, gs)
        ),
        control_rule='bf16 products, f32 sum, worst of the 36 layers',
        # p and g read once; the terms, vg_sum and scale written once
        nbytes=4 * (2 * numel + len(ps) + 2), flops=2 * numel,
        device_kernels=DOT_KERNELS,
    ))
    # timed in place on copies, as the engine calls it: a scale of 1 keeps
    # repeated calls exact
    work, lib_work = [p.clone() for p in ps], [p.clone() for p in ps]
    one = torch.ones((), device=dev)

    def cmp_many(got, want):
        return max(map(max_err, got, want), key=lambda e: e[0])

    cases.append(dict(
        name='klclip_scale', shape=[len(ps), numel],
        kernel=lambda: klclip.klclip_scale_many([p.clone() for p in ps], s, in_place=True),
        timed=lambda: klclip.klclip_scale_many(work, one, in_place=True),
        plain=lambda: klclip.klclip_scale_many_plain(ps, s),
        library=lambda: torch._foreach_mul(ps, s),
        compare=cmp_many, rtol=0.0, tol_rule='exact, out of place as well',
        invariant=lambda got: all(map(torch.equal, klclip.klclip_scale_many(ps, s), got)),
        control=lambda: [(p.bfloat16() * s).float() for p in ps],
        control_rule='bf16 products',
        nbytes=4 * (2 * numel + 1), flops=numel,
        device_kernels=('klclip_scale_multi_kernel',),
        also_timed=dict(
            # new outputs, allocated a tensor at a time by the wrapper
            ms_out_of_place=lambda: klclip.klclip_scale_many(ps, s),
            library_in_place_ms=lambda: torch._foreach_mul_(lib_work, one),
        ),
    ))
    def cmp_flash(got, want):
        # the worst of acc, m and l relative to its own max
        return max(map(max_err, got, want), key=lambda p: p[0] / p[1])

    # the flagship's (head dim 128), the bench's tiny LM's (head dim 32) and
    # its `large` LM's (head dim 256)
    for b, s_, h, dh in ((FLAGSHIP['batch'], FLAGSHIP['seq'], FLAGSHIP['heads'], 128),
                         (4, 128, 4, 32), (8, 1024, 4, 256)):
        q, k, v = randn(b, s_, h, dh), randn(b, s_, h, dh), randn(b, s_, h, dh)

        def sdpa(q=q, k=k, v=v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True
            )

        pairs = s_ * (s_ + 1) // 2  # visible (query, key) pairs of a causal row set
        cases.append(dict(
            name='flash_attention_partials', shape=[b, s_, h, dh],
            kernel=lambda q=q, k=k, v=v: flash_attention.flash_attention_partials(q, k, v, 0, 0, True),
            plain=lambda q=q, k=k, v=v: flash_attention.attend_partials_einsum(q, k, v, 0, 0, True),
            library=sdpa, compare=cmp_flash, rtol=1e-5,
            tol_rule='1e-5 x max|x| for each of acc, m, l',
            control=tf32(
                lambda q=q, k=k, v=v: flash_attention.attend_partials_einsum(q, k, v, 0, 0, True)
            ),
            control_rule='plain version with TF32 matmuls',
            nbytes=4 * (4 * b * s_ * h * dh + 2 * b * h * s_),
            flops=4 * dh * pairs * b * h, tf32x3=True,
        ))
    def ns_errors(got, want):
        # x_new and mx_new relative to their own max, the residual relative
        # to itself
        r_err = abs(float(got[2]) - float(want[2]))
        return [max_err(got[0], want[0]), max_err(got[1], want[1]), (r_err, float(want[2]))]

    def cmp_ns(got, want):
        return max(ns_errors(got, want), key=lambda p: p[0] / p[1])

    def detail_ns(got, want):
        return dict(zip(('x_new', 'mx_new', 'resid'), (e / r for e, r in ns_errors(got, want))))

    # one NS iteration as the solver meets it: m = a^T a / 8192 + 0.003 I,
    # the Gershgorin x0, then two plain iterations
    for d in (513, 2049, 512, 2048):
        a = randn(8192, d)
        eye = torch.eye(d, device=dev)
        m = a.T @ a / 8192 + 0.003 * eye
        lam_max = m.abs().sum(-1).max()
        x, mx = eye / lam_max, m / lam_max
        for _ in range(2):
            x, mx, _ = newton_schulz.fused_ns_step_plain(m, x, mx)
        tile = newton_schulz.plan(d, sms)

        def library(m=m, x=x, mx=mx, eye=eye, d=d):
            x_new = torch.matmul(x, 2.0 * eye - mx)
            mx_new = torch.matmul(m, x_new)
            return x_new, mx_new, torch.linalg.norm(eye - mx_new) / math.sqrt(d)

        cases.append(dict(
            name='fused_ns_step', shape=[d, d],
            kernel=lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step(m, x, mx),
            plain=lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step_plain(m, x, mx),
            library=library, compare=cmp_ns, detail=detail_ns, rtol=NS_RTOL,
            # no atomics: every output bit for bit from run to run
            invariant=lambda got, m=m, x=x, mx=mx: all(
                torch.equal(g, h) for g, h in zip(got, newton_schulz.fused_ns_step(m, x, mx))
            ),
            tol_rule=f'{NS_RTOL:g} x max|x_new|, max|mx_new| and resid; run-to-run identical',
            control=tf32(lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step_plain(m, x, mx)),
            control_rule='plain version with TF32 matmuls',
            # inputs m, x, mx read once, x_new, mx_new and resid written once
            nbytes=4 * (5 * d * d + 1), flops=4 * d**3, tf32x3=True,
            extra=dict(
                tile=tile, ctas=math.prod(newton_schulz.grid(d, tile)),
                resid=float(newton_schulz.fused_ns_step_plain(m, x, mx)[2]),
            ),
        ))
    return cases


def profiled_device_ms(fn, names, calls=20):
    """Device ms of one ``fn()`` from torch.profiler: per kernel whose name
    holds one of ``names``, its device time over its launches, summed. 100
    lead kernels go first (a trace can lose a pass's first records)."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, device='cuda')
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            lead.add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [
        (evt.self_device_time_total / 1e3, evt.count) for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.count
        and any(n in evt.key for n in names)
    ]
    if not found:
        return 'not measured', 0
    return sum(ms / count for ms, count in found), sum(count for _, count in found)


def run_kernels(results) -> bool:
    ok = True
    for case in kernel_cases():
        got = case['kernel']()
        torch.cuda.synchronize()
        want = case['plain']()
        err, ref = case['compare'](got, want)
        tol = case['rtol'] * ref
        holds = case.get('invariant', lambda got: True)(got)
        extra = dict(case.get('extra', {}))
        control = case['control']()
        if 'control_compare' in case:  # the worst relative error of its parts
            control_rel = case['control_compare'](control)
            rejects_control = control_rel > case['rtol']
        else:
            control_err, _ = case['compare'](control, want)
            control_rel = control_err / ref if ref else control_err
            rejects_control = control_err > tol
        if 'detail' in case:
            extra['rel_err'] = case['detail'](got, want)
            extra['control_rel_err'] = case['detail'](control, want)
        passed = err <= tol and holds and rejects_control
        timed = case.get('timed', case['kernel'])
        if 'device_kernels' in case:
            # back-to-back CUDA events time host enqueue at these sizes
            extra['device_ms'], extra['device_launches_seen'] = profiled_device_ms(
                timed, case['device_kernels']
            )
        ms = time_ms(timed)
        plain_ms = time_ms(case['plain'])
        library_ms = time_ms(case['library'])
        for key, fn in case.get('also_timed', {}).items():
            extra[key] = time_ms(fn)
        for key in ('ms_unsplit', 'ms_split'):
            if key in extra:  # the plan against the other form, in turns:
                # medians of 4 planned and 4 other timings, which the host's
                # drift moves by up to a third at these sizes
                planned, other = [ms], [extra[key]]
                for _ in range(3):
                    planned.append(time_ms(timed))
                    other.append(time_ms(case['also_timed'][key]))
                extra['ms_planned_turns'] = statistics.median(planned)
                extra[key + '_turns'] = statistics.median(other)
                extra['plan_faster'] = extra['ms_planned_turns'] <= extra[key + '_turns']
        bms, by = bound_ms(case['nbytes'], case['flops'])
        if case.get('tf32x3'):
            # the work the kernel issues: 3 TF32 products per f32 product,
            # with the f32 bound beside it
            extra['bound_f32_ms'], extra['bound_f32_share'] = bms, bms / ms
            bms, by = bound_ms(case['nbytes'], 3 * case['flops'], TF32_FLOPS_PER_S)
        row = dict(
            phase='kernel', name=case['name'], shape=case['shape'],
            max_abs_err=err, max_rel_err=err / ref if ref else err, tol=tol,
            tol_rule=case['tol_rule'], invariant_holds=holds,
            control_rule=case['control_rule'],
            control_max_rel_err=control_rel,
            rejects_control=rejects_control, passed=passed,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by, bound_share=bms / ms, **extra,
        )
        emit(row)
        results.append(row)
        ok &= passed
    return ok


# --------------------------------------------------------------- main path


class LMRun:
    """The bench's K-FAC LM loop through ``Trainer.step`` on one seeded
    batch, weights from seed 1: a capture step every ``capture_every``
    steps, a plain step otherwise."""

    def __init__(self, cfg, device, capture_every, inv_every, **kfac_kw):
        import kfac_tpu_torch as kt
        from kfac_tpu_torch.models import TransformerLM, lm_loss
        from kfac_tpu_torch.training import Trainer

        self.device = device
        self.capture_every = capture_every
        model = TransformerLM(
            vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
            num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device,
        )
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        self.batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
        self.registry = kt.register_model(model, skip_layers=['lm_head'], device=device)
        self.kfac = kt.KFACPreconditioner(
            self.registry, damping=0.003, lr=0.1, factor_update_steps=capture_every,
            inv_update_steps=inv_every, device=device, **kfac_kw,
        )
        loss = lm_loss(model)
        self.trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            lambda ms, batch: (loss(batch), ms), kfac=self.kfac, device=device,
        )
        self.state = self.trainer.init()

    @property
    def kstate(self):
        return self.state.kfac_state

    def grads(self) -> dict:
        """The last step's preconditioned grads, as the optimizer read them
        from ``.grad``."""
        return {
            n: p.grad.detach().clone()
            for n, p in self.trainer.model.named_parameters() if p.grad is not None
        }

    def step(self):
        """One ``Trainer.step``; returns (loss, seconds)."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.state, loss = self.trainer.step(self.state, self.batch)
        loss = float(loss)  # waits for the step's work
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        return loss, time.perf_counter() - t0


def train(run, steps, grads=False):
    """(losses, preconditioned grads if ``grads``, step seconds) of
    ``steps`` steps."""
    losses, pgrads, seconds = [], [], []
    for _ in range(steps):
        loss, sec = run.step()
        losses.append(loss)
        seconds.append(sec)
        if grads:
            pgrads.append(run.grads())
    return losses, pgrads, seconds


def device_profile(fn) -> dict:
    """Wall time, device busy time and device time by kernel of ``fn()``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # a record_function scope (the Trainer's) also shows on the device as
    # an annotation spanning its kernels: not a kernel, not counted
    scopes = {evt.name for evt in prof.events() if str(evt.device_type).endswith('CPU')}
    kernels = sorted(
        (
            (evt.key, evt.self_device_time_total / 1e3, evt.count)
            for evt in prof.key_averages()
            if str(evt.device_type).endswith('CUDA') and evt.self_device_time_total > 0
            and evt.key not in scopes
        ),
        key=lambda k: -k[1],
    )
    busy = sum(k[1] for k in kernels)
    return dict(
        wall_ms_profiled=wall, device_busy_ms=busy,
        idle_share=(1 - busy / wall) if busy else 'not measured',
        top=[dict(kernel=k[:90], ms=ms, count=n) for k, ms, n in kernels[:15]],
    )


def profile_step(run, i) -> dict:
    """Device time by kernel over the run's next step, ``i``, from
    torch.profiler."""
    return dict(
        step=i, kind='capture' if i % run.capture_every == 0 else 'plain',
        **device_profile(run.step),
    )


INVERSE_NS = dict(compute_method='inverse', inverse_solver='newton_schulz')
REFERENCE_CONFIGS = ({}, INVERSE_NS, dict(compute_method='inverse', inverse_solver='auto'))


REFERENCE_CFG = dict(batch=4, seq=128, d_model=256, layers=2, heads=2, vocab=512)


def reference_errors(card, cpu) -> tuple[float, float]:
    """(max relative loss error, max preconditioned-grad error relative to
    the step's max |grad|) of the card's (losses, grads) against the CPU's."""
    (gl, gp), (cl, cp) = card, cpu
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = 0.0
    for g_step, c_step in zip(gp, cp):
        scale = max(float(v.abs().max()) for v in c_step.values())
        for n, c in c_step.items():
            grad_err = max(grad_err, float((g_step[n].cpu() - c).abs().max()) / scale)
    return loss_err, grad_err


def run_reference() -> bool:
    """Kernels on the card vs plain versions on the CPU, small model, for
    each solver configuration through ``Trainer.step``, then EIGEN through
    ``Trainer.scan_steps`` and ``Trainer.step_accumulate``."""
    from kfac_tpu_torch.ops import factors, newton_schulz

    cfg = REFERENCE_CFG
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    ok = True
    for kfac_kw in REFERENCE_CONFIGS:
        ns0, fb0 = newton_schulz.fused_ns_step.launches, factors.damped_inverse.cholesky_fallbacks
        gl, gp, _ = train(LMRun(cfg, cuda, 2, 2, **kfac_kw), 3, grads=True)
        ns_launches = newton_schulz.fused_ns_step.launches - ns0
        fallbacks_cuda = factors.damped_inverse.cholesky_fallbacks - fb0
        cl, cp, _ = train(LMRun(cfg, cpu, 2, 2, **kfac_kw), 3, grads=True)
        loss_err, grad_err = reference_errors((gl, gp), (cl, cp))
        # the NS configurations must have run the kernel on the card
        ns_ran = ns_launches > 0 if kfac_kw else ns_launches == 0
        passed = loss_err <= 1e-4 and grad_err <= 1e-3 and ns_ran
        emit(dict(
            phase='reference', config=cfg, kfac=kfac_kw or 'default (EIGEN)', steps=3,
            entry='Trainer.step', losses_cuda=gl, losses_cpu=cl, loss_rel_err=loss_err,
            loss_tol=1e-4, pgrad_err_rel_to_max=grad_err, pgrad_tol=1e-3,
            fused_ns_step_launches_cuda=ns_launches,
            cholesky_fallbacks_cuda=fallbacks_cuda,
            cholesky_fallbacks_cpu=factors.damped_inverse.cholesky_fallbacks - fb0 - fallbacks_cuda,
            passed=passed,
        ))
        ok &= passed
    for entry in ('scan_steps', 'step_accumulate'):
        out = [loop_run(entry, dev) for dev in (cuda, cpu)]
        loss_err, grad_err = reference_errors(*out)
        passed = loss_err <= 1e-4 and grad_err <= 1e-3
        emit(dict(
            phase='reference', config=cfg, kfac='default (EIGEN)', steps=3,
            entry=f'Trainer.{entry}', losses_cuda=out[0][0], losses_cpu=out[1][0],
            loss_rel_err=loss_err, loss_tol=1e-4, pgrad_err_rel_to_max=grad_err,
            pgrad_tol=1e-3, passed=passed,
        ))
        ok &= passed
    return ok


def loop_run(entry, device) -> tuple[list, list]:
    """(losses, preconditioned grads) of three steps at cadence 2/2 through
    ``Trainer.scan_steps`` (one call; the grads of its last step) or
    ``Trainer.step_accumulate`` (each step over the batch's two halves)."""
    run = LMRun(REFERENCE_CFG, device, 2, 2)
    if entry == 'scan_steps':
        batches = tuple(x.expand(3, *x.shape) for x in run.batch)
        run.state, losses = run.trainer.scan_steps(run.state, batches)
        return losses.tolist(), [run.grads()]
    half = REFERENCE_CFG['batch'] // 2
    micro = [tuple(x[:half] for x in run.batch), tuple(x[half:] for x in run.batch)]
    losses, grads = [], []
    for _ in range(3):
        run.state, loss = run.trainer.step_accumulate(run.state, micro)
        losses.append(float(loss))
        grads.append(run.grads())
    return losses, grads


def main_path_wrappers() -> dict:
    from kfac_tpu_torch.ops import cov_ema, flash_attention, klclip, newton_schulz, sym_cov

    return {
        'sym_cov': sym_cov.sym_cov,
        'sym_cov_ema': cov_ema.sym_cov_ema,
        'klclip_dot': klclip.klclip_dot,
        'klclip_scale': klclip.klclip_scale,
        'flash_attention_partials': flash_attention.flash_attention_partials,
        'fused_ns_step': newton_schulz.fused_ns_step,
    }


def expected_launches(steps: int, captures: int) -> dict:
    """Launches of every kernel but the NS step over ``steps`` steps with
    ``captures`` capture steps, from the configuration (no path of the
    engine blends the covariance into the factor: ``sym_cov_ema`` 0)."""
    return {
        'sym_cov': 2 * KFAC_LAYERS * captures,
        'sym_cov_ema': 0,
        'klclip_dot': steps,  # every layer in one launch
        'klclip_scale': steps,
        'flash_attention_partials': FLAGSHIP['layers'] * steps,
    }


def step_summary(seconds) -> dict:
    plain_ms = sorted(s * 1e3 for i, s in enumerate(seconds) if i % 10 and i > 10)
    return dict(
        step_0_ms=seconds[0] * 1e3, capture_step_ms=seconds[10] * 1e3,
        plain_step_ms_median=plain_ms[len(plain_ms) // 2],
    )


def run_main_path(launches, summary) -> bool:
    wrappers = main_path_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100)
    losses, _, seconds = train(run, STEPS)
    launches.update({n: w.launches for n, w in wrappers.items()})
    layers = len(run.registry)
    expected = dict(expected_launches(STEPS, len(range(0, STEPS, 10))), fused_ns_step=0)
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    passed = finite and falling and layers == KFAC_LAYERS and launches == expected
    summary.update(step_summary(seconds))
    emit(dict(
        phase='main_path', config=FLAGSHIP, steps=STEPS, registered_layers=layers,
        expected_layers=KFAC_LAYERS,
        losses=losses, finite=finite, loss_falls=falling,
        step_ms=[s * 1e3 for s in seconds], **summary,
        tokens_per_step=FLAGSHIP['batch'] * FLAGSHIP['seq'],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, expected_launches=expected, passed=passed,
    ))
    # after the counted run: one more capture step and one plain step
    emit(dict(phase='profile', steps=[
        profile_step(run, STEPS), profile_step(run, STEPS + 1),
    ]))
    return passed


def inverse_residuals(run) -> list[float]:
    """``||I - (F + damping I) F_inv||_F / sqrt(d)`` of every factor's
    inverse in the run's K-FAC state, by torch.matmul (f32)."""
    st, damping, out = run.kstate, run.kfac.damping, []
    for n in run.registry.layers:
        for f, f_inv in ((st.a[n], st.a_inv[n]), (st.g[n], st.g_inv[n])):
            eye = torch.eye(f.shape[0], device=f.device)
            r = torch.linalg.norm(eye - (f + damping * eye) @ f_inv) / math.sqrt(f.shape[0])
            out.append(float(r))
    return out


def run_main_path_ns(launches, eigen_summary) -> bool:
    from kfac_tpu_torch.ops import factors, newton_schulz

    wrappers = main_path_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100, **INVERSE_NS)
    losses, seconds, refreshes = [], [], []
    starts = factors.newton_schulz_inverse_info.starts
    for i in range(NS_STEPS):
        ns_before = newton_schulz.fused_ns_step.launches
        starts_before = dict(starts)
        if i == 100:
            before_refresh = run.kstate
        loss, sec = run.step()
        losses.append(loss)
        seconds.append(sec)
        if i % 100 == 0:
            resid = inverse_residuals(run)
            refreshes.append(dict(
                step=i, start='cold' if i == 0 else 'warm', step_ms=sec * 1e3,
                fused_ns_step_launches=newton_schulz.fused_ns_step.launches - ns_before,
                starts={k: v - starts_before[k] for k, v in starts.items()},
                max_independent_residual=max(resid),
                factors_over_fallback_residual=sum(
                    not r <= factors.NS_FALLBACK_RESIDUAL for r in resid
                ),
                factors=len(resid),
            ))
    launches.update({n: w.launches for n, w in wrappers.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = len(run.registry)
    expected = expected_launches(NS_STEPS, len(range(0, NS_STEPS, 10)))
    n_factors = 2 * KFAC_LAYERS
    refresh_count = len(range(0, NS_STEPS, 100))
    # at least one iteration per factor per refresh, at most the cap
    ns_range = [refresh_count * n_factors, refresh_count * n_factors * 40]
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    passed = (
        finite and falling and layers == KFAC_LAYERS
        and {n: launches[n] for n in expected} == expected
        and ns_range[0] <= launches['fused_ns_step'] <= ns_range[1]
        and sum(r['fused_ns_step_launches'] for r in refreshes) == launches['fused_ns_step']
        and all(r['factors_over_fallback_residual'] == 0 for r in refreshes)
    )
    summary = step_summary(seconds)
    emit(dict(
        phase='main_path_ns', config=FLAGSHIP, kfac=INVERSE_NS, steps=NS_STEPS,
        registered_layers=layers, losses=losses, finite=finite, loss_falls=falling,
        step_ms=[s * 1e3 for s in seconds], **summary,
        step_100_ms=seconds[100] * 1e3, eigen_path=eigen_summary,
        refreshes=refreshes, residual_limit=factors.NS_FALLBACK_RESIDUAL,
        peak_memory_gib=peak, launches=launches,
        expected_launches=dict(expected, fused_ns_step=ns_range), passed=passed,
    ))
    # after the counted run: the step-100 refresh again, from the same
    # factors (unchanged since the capture at step 100) and the same
    # starting inverses, once timed and once profiled
    redo = dataclasses.replace(
        run.kstate, step=100, a_inv=before_refresh.a_inv, g_inv=before_refresh.g_inv
    )
    ns0 = newton_schulz.fused_ns_step.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.kfac.update_inverses(redo)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    iterations = newton_schulz.fused_ns_step.launches - ns0
    emit(dict(
        phase='profile_ns', what='step-100 warm refresh (update_inverses), repeated',
        refresh_ms=refresh_ms, fused_ns_step_launches=iterations,
        profile=device_profile(lambda: run.kfac.update_inverses(redo)),
    ))
    return passed


# the probe's warm call and its 9 timed calls, before its profiled passes
PROBE_TIMED_CALLS = 10
PROBE_FAMILIES = ('cov_ema', 'ns', 'klclip')


def expected_bench_launches(cfg: dict, window: dict, probe_calls: int) -> dict:
    """Launches of every kernel over one ``bench_lm`` stage, from its
    configuration: SGD and eager K-FAC over ``warmup + iters`` steps, two
    ``scan_steps`` calls, the bench's factor cadence of 10, six K-FAC
    layers a block; the fused-kernel probe calls each fused kernel
    ``probe_calls`` times (EIGEN runs no Newton-Schulz)."""
    eager = window['warmup'] + window['iters']
    scan = 2 * window['scan_steps']
    captures = len(range(0, eager, 10)) + len(range(0, scan, 10))
    kfac_layers = 6 * cfg['layers']
    return {
        'sym_cov': 2 * kfac_layers * captures,
        'sym_cov_ema': probe_calls,
        'klclip_dot': eager + scan + probe_calls,
        'klclip_scale': eager + scan + probe_calls,
        'flash_attention_partials': cfg['layers'] * (2 * eager + scan),
        'fused_ns_step': probe_calls,
    }


def run_bench_lm(launches) -> bool:
    """The bench's LM stage in process, ``tiny`` then ``flagship``, each
    with the kernels' counts set to 0 just before and read just after."""
    from kfac_tpu_torch import bench_lm

    wrappers = main_path_wrappers()
    ok = True
    for config in ('tiny', 'flagship'):
        for w in wrappers.values():
            w.launches = 0
        record = bench_lm.run_lm_stage(config, 'cuda')
        counts = launches[f'bench_lm_{config}']
        counts.update({n: w.launches for n, w in wrappers.items()})
        probe = record['fused_kernel_probe']
        expected = expected_bench_launches(
            bench_lm.LM_CONFIGS[config], record['window'],
            PROBE_TIMED_CALLS + probe.get('device_passes', 0),
        )
        # after the counted run: one plain step of each trainer, profiled
        batch = bench_lm.lm_batch(bench_lm.LM_CONFIGS[config], torch.device('cuda'))
        profiles = {}
        for kfac in (False, True):
            trainer = bench_lm.lm_trainer(bench_lm.LM_CONFIGS[config], torch.device('cuda'), kfac)
            state, _ = trainer.step(trainer.init(), batch)  # step 0: capture, refresh
            profiles['kfac_plain_step' if kfac else 'sgd_step'] = device_profile(
                lambda: trainer.step(state, batch)
            )
        rates = [record[k] for k in (
            'sgd_tokens_per_sec', 'eager_tokens_per_sec', 'scan_tokens_per_sec', 'value',
            'vs_baseline', 'mfu', 'sgd_mfu',
        )]
        passed = (
            all(math.isfinite(r) and r > 0 for r in rates)
            and all(math.isfinite(x) for x in record['last_loss'].values())
            and all('fused_p50_ms' in probe[f] and 'fused_error' not in probe[f]
                    for f in PROBE_FAMILIES)
            and 'trace_error' not in probe
            and counts['sym_cov_ema'] > 0 and counts == expected
        )
        emit(dict(
            phase='bench_lm', config=config, record=record, launches=counts,
            expected_launches=expected, profile=profiles, passed=passed,
        ))
        ok &= passed
    return ok


SOURCES = {
    'sym_cov': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov.py:88', [8192, 2049]),
    'sym_cov_ema': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov_ema.py:110', [512, 256]),
    'klclip_dot': ('cuda', 'kfac_tpu_torch/csrc/klclip.cu', 'kfac_tpu/ops/pallas_ns.py:219', [KFAC_LAYERS, 18_902_016]),
    'klclip_scale': ('cuda', 'kfac_tpu_torch/csrc/klclip.cu', 'kfac_tpu/ops/pallas_ns.py:244', [KFAC_LAYERS, 18_902_016]),
    'flash_attention_partials': ('cuda', 'kfac_tpu_torch/csrc/flash_attn.cu', 'kfac_tpu/ops/pallas_attention.py:257', [16, 512, 4, 128]),
    'fused_ns_step': ('cuda', 'kfac_tpu_torch/csrc/newton_schulz.cu', 'kfac_tpu/ops/pallas_ns.py:127,139', [2049, 2049]),
}


def kernels_line(results, launches) -> dict:
    """``launches`` per kernel is the sum over the main paths, each path's
    count beside it."""
    out = []
    for name, (route, source, replaces, shape) in SOURCES.items():
        rows = [r for r in results if r['name'] == name]
        row = next((r for r in rows if r['shape'] == shape), None)
        if row is None:
            continue
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        out.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r['max_abs_err'] for r in rows), shape=shape,
            ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
            bound_by=row['bound_by'], bound_share=row['bound_share'],
            library_ms=row['library_ms'],
            **{k: row[k] for k in ('bound_f32_ms', 'bound_f32_share', 'device_ms', 'library_call')
               if k in row},
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
    launches: dict[str, dict[str, int]] = {
        path: {} for path in ('main_path', 'main_path_ns', 'bench_lm_tiny', 'bench_lm_flagship')
    }
    eigen_summary: dict = {}

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
    phase('main_path', run_main_path, launches['main_path'], eigen_summary)
    phase('main_path_ns', run_main_path_ns, launches['main_path_ns'], eigen_summary)
    phase('bench_lm', run_bench_lm, launches)
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
