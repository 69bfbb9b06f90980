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
   the scale in place (out of place and ``_foreach_mul_`` beside); the
   dot also in its norm instantiation (each layer's sum(g*g) and sum(p*p)
   against f64, the dot's outputs bitwise those without norms), and both
   at the digits MLP's two layers. ``sym_cov`` also at the digits MLP's
   covariances and at a rank's rows of the kaisa phase at four ranks
   (2048). ``fused_ns_step_stacked`` at each (slots, d, d) block a rank
   of the kaisa phase solves on this machine's cards, one a store (at one
   card (24, 513), (6, 513), (6, 2049), (24, 512), (6, 2048), (6, 512);
   at four a quarter of the slots, fc2's padded from 6 to 8): each slot
   within tolerance and bitwise the 2-D launch at the same tile (the
   library call: two ``torch.bmm`` and ``torch.linalg.matrix_norm``).
   The bf16 and f16 forms of ``sym_cov`` (the flagship's four factor
   widths at 8192 rows, in the padded rows its A builders give), of
   ``sym_cov_ema`` and of the flash partials (the flagship's attention, in
   bf16 also two ring steps of ``tp_sp``, on normal inputs and on
   ``flash_attention.exact_inputs``) against their plain oracles (the TPU
   kernel's function in the dtype), with tolerances from the dtype's unit
   roundoff u (``half_kernel_cases``), bounded at the 989 TFLOP/s 16-bit
   tensor-core peak and the HBM rate, beside ``matmul(a.T, a)``,
   ``addmm`` and SDPA in the dtype; each with its device ms and the
   library call's (torch.profiler; ``library_device_ms`` sums every
   kernel the call launches).
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
   idle share). The run's losses and host copies of its state after
   steps 10 and 15 are the uninterrupted reference of ``resume``.
6. ``main_path_ns``: the same flagship with INVERSE + Newton-Schulz for
   101 steps, so the inverse refreshes at step 0 (cold start) and step 100
   (warm start from the step-0 inverses), counts set to 0 just before and
   read just after; every factor's inverse is checked after each refresh
   by an independent residual. Then the step-100 refresh is repeated from
   the same factors and starting inverses, once timed and once under
   torch.profiler (``profile_ns``).
7. ``digits_mlp``: the ``digits_mlp`` accuracy recipe
   (``kfac_tpu_torch.bench_accuracy``: MLP 64 -> 64 -> 10, batch 100, lr
   0.1, SGD with momentum 0.9, K-FAC damping 0.003, cadence 5/25, 600 steps
   of each run from one seed, an evaluation every 17), counts set to 0
   before and read after: both curves, the self-calibrating target, steps
   and seconds to it and their ratios, the median step ms of each run;
   passes when both finals are finite and K-FAC reaches the target in
   fewer steps than SGD. Then ``digits_cnn``, the same for the recipe's
   CNN (two SAME convs and a dense head on the 8x8 images, lr 0.02, K-FAC
   damping 0.01).
8. ``observed``: ``main_path``'s loop with the health sentinel
   (``warn=False, skip_nonfinite=False``), metrics and the flight recorder
   on, in turns with the same loop without them: losses within 1e-6 of
   ``main_path``'s, launch counts (the kl-clip dot in its norm
   instantiation), the host syncs of every step
   (``torch.cuda.set_sync_debug_mode``: none on plain and capture steps),
   a metrics drain and a flight drain, the step ms of each kind with and
   without, and one capture and one plain step of each under
   torch.profiler; then three injected faults: a batch whose loss is NaN
   (skipped, nothing moves), a capture past the quarantine threshold (rolled
   back, damping x 10), and quarantined refreshes up to ``degrade_after``
   (the layer's grads leave as the raw gradient times the kl-clip scale).
9. ``resume``: checkpoint and preemption on the flagship (EIGEN, cadence
   10/100), held against ``main_path``'s uninterrupted run: a fresh run
   under
   ``Trainer(checkpoints=CheckpointManager(save_interval_steps=10, keep=2,
   async_save=True))`` that sends itself a real SIGTERM after step 13, so
   step 14's ``on_step`` saves an emergency checkpoint and raises
   ``Preempted`` (each step's ms, host syncs and whether it saved: none on
   a step that neither saves nor refreshes); ``checkpoint.restore`` of the
   step-10 checkpoint into a fresh Trainer (params, momentum and factors
   bitwise the uninterrupted run's, steps 10-19 within 1e-6 of its losses);
   ``Trainer.restore_latest`` at the emergency step, 5 steps within 1e-6 of
   an in-memory oracle (the uninterrupted state at step 15,
   ``rematerialize``d, stepped on); the same restore into INVERSE +
   Newton-Schulz (``fused_ns_step`` launches of the cold
   ``rematerialize``, every inverse's residual <= 5e-2); then the bytes on
   disk and the times of a blocking and an async save, of the restore
   (read and rematerialize) and of the emergency save. Counts set to 0
   before, read after.
10. ``async_refresh``: the async inverse refresh, each run with the counts
   set to 0 just before and read just after, held exactly. (a) The
   flagship (EIGEN, cadence 10/10, so the sliced refresh is bit for bit the
   synchronous one a window back) for 31 steps through ``Trainer.step``,
   once synchronous and once ``async_inverse='sliced'``: the slice plan,
   the step ms over steps 11-30 (median, max, max / median), the host
   syncs of each kind of step, the peak memory, and the oracle: the
   sliced run's decompositions after its swaps at steps 20 and 30 bit for
   bit ``compute_eigh`` on the card of its factors after steps 10 and 20
   (a stated tolerance instead only if cuSOLVER does not repeat itself on
   one input). (b) The async spike probe's MLP (``bench_lm.probe_trainer``:
   d 512, batch 256, window 8, a warm window and three more) under INVERSE
   + Newton-Schulz, ``'sliced'``: every swapped inverse's independent
   residual against the factors it came from <= 5e-2, ``fused_ns_step``
   launches inside the range the refreshes give, host syncs by step. (c)
   The same MLP under EIGEN, ``'host'``: each boundary's wait in the pump,
   the step ms while the worker runs, and after each swap the
   preconditioned grads within rtol 5e-3, atol 1e-4 of the synchronous
   engine's refresh of the factors a window back.
11. ``kaisa``: the KAISA engine (``DistributedKFAC``) over NCCL, one rank
   a visible card, spawned by ``kfac_tpu_torch.parallel.spawn_world``
   (one card: a world of one rank, which still runs NCCL, the stacked
   stores, the bucketed triangle all-reduce and the stacked Newton-Schulz
   kernel). The flagship at cadence 10/10 through ``Trainer.step`` on the
   global batch (each rank its row block): 21 steps under EIGEN at every
   gradient-worker fraction the world allows (one: 1.0; four: 1, 0.5,
   0.25), with each stat transport (ALLREDUCE, ALLREDUCE_BUCKETED); then 11
   steps under INVERSE + Newton-Schulz at every fraction. Each run's
   counts are set to 0 just before and read just after, on every rank.
   Checks: losses finite and falling, within 1e-4 relative of the dense
   ``KFACPreconditioner``'s on the same card, batch and weights, and rank
   0's last preconditioned grads within 1e-3 of their max; parameters
   identical on every rank (bitwise); launches exact on every rank
   (``sym_cov`` two a layer a capture, the grouped kl-clip dot and scale
   once a step, the flash partials once a block a step) and the stacked
   ``fused_ns_step_stacked`` inside [1, 80] a live stacked solve a
   refresh; every refresh's independent residual <= 5e-2. Each run prints
   its step ms by kind (plain median, capture + refresh, the refresh
   alone), each rank's peak memory beside ``memory_usage()``'s
   decomposition bytes, and ``comms_report()``'s bytes per collective.
12. ``kaisa_ops``: the sentinel, metrics, flight recorder and checkpoints
   of the KAISA engine, over NCCL on one rank a visible card, the flagship
   through ``Trainer.step`` with a ``DistributedKFAC`` (COMM-OPT, cadence
   10/100). (a) ``observed``'s loop with the sentinel (``warn=False,
   skip_nonfinite=False``), metrics and flight on, in turns with the loop
   without them, counts over the observed steps: launches exact (the
   kl-clip dot once a step, in its norm instantiation), no host sync on a
   plain or capture step, each rank's plain-step median with and without,
   the drains; then ``observed``'s three faults, the counters bitwise
   equal on every rank and equal to the dense engine's after the same
   faults. (b) ``Trainer(checkpoints=CheckpointManager(save_interval_steps=
   10, keep=2, async_save=True))``: rank 0 sends itself a real SIGTERM
   after step 13, every rank saves the one agreed emergency checkpoint at
   step 15 (one rotation entry beside step 10's, one ``LATEST``) and
   raises ``Preempted``; no host sync on a step that neither saves nor
   captures; a restore at the same world continues 5 steps bitwise (losses,
   parameters, factors) as the interrupted run continued in memory after
   ``rematerialize``; each rank's blocking, async-return and wait ms of a
   save, its restore ms and its shard's bytes (rank 0's extras beside).
   (c) Migrations of that checkpoint: into the dense engine, a dense
   checkpoint back into the ``DistributedKFAC``, and into bucket
   granularity 128, each with the ``migrating`` warning and its
   preconditioned grads within 1e-3 of the largest of the source engine's;
   with four cards also W = 4 -> 2 -> 4 (two more worlds).
13. ``resnet``: the convolutional family at the bench's
   ``resnet32_cifar`` (ResNet-32, batch 256 of 32x32x3 synthetic CIFAR
   images, 10 classes, f32, cuDNN's TF32 off), weights and BatchNorm
   statistics made here from a seed in the JAX package's layout and
   carried over by ``convert``, through ``Trainer.step`` with the
   statistics in ``model_state`` (damping 0.003, lr 0.1, cadence 10/100,
   SGD(0.1, momentum 0.9)), each run's counts set to 0 just before and
   read just after. (a) EIGEN, 21 steps (captures at 0, 10, 20; the
   refresh at 0): losses finite and falling, ``sym_cov`` exactly 2 x 32 a
   capture step and none on the others, the kl-clip dot and scale once a
   step, and the first 2 steps against the CPU's (plain versions): losses
   within 1e-4, the preconditioned grads after step 0 within 1e-3 of
   their max; then a plain and a capture step under torch.profiler. (b)
   INVERSE + Newton-Schulz, 11 steps: ``fused_ns_step`` launches inside the cold
   refresh's range (a factor that damping dominates takes none), every
   inverse's independent residual <= 5e-2. (c)
   ``DistributedKFAC`` (EIGEN, one NCCL rank a card: COMM-OPT on one card,
   MEM-OPT on four), 11 steps, BatchNorm over the global batch: the first
   3 losses within 1e-4 of (a)'s, rank 0's grads after step 0 within 1e-3
   of (a)'s max, parameters and statistics bitwise equal on every rank,
   launches exact on every rank. (Later steps amplify f32 rounding: they
   are reported beside a control, the dense engine from weights moved by
   1e-7, ``RESNET_COMPARED_LOSSES``.) The phase runs cuDNN's
   deterministic algorithms. Then ``compute_eigh`` on the card of three
   non-finite factors: all NaN, no error. The ``kernel`` phase holds
   ``sym_cov`` at every covariance shape of a capture step here, and the
   grouped kl-clip dot and scale at the 32 layers.
14. ``bench_lm``: the bench's LM stage (``kfac_tpu_torch.bench_lm``) in
   process for ``tiny`` and then ``flagship``, in f32, at a quarter of the bench's
   own window (25 timed steps, 25 ``scan_steps``), counts set to 0 before each
   and read after: every rate finite and positive, every fused-kernel
   probe family timed without error, the async spike probe's keys, the
   compression probe's (its int8 wire ratio >= 3, its offload's
   ``prefetch_hit_rate`` 1.0), and
   every kernel launched exactly as often as the configuration says
   (``sym_cov_ema`` by the fused-kernel probe).
15. ``engine_knobs``: the engines' last knobs. (d) first, in this
   process: the flagship on the dense engine (EIGEN, cadence 10/100,
   ``OffloadConfig(min_cold_steps=4, prefetch_lead=1)``), 21 steps, and
   the same without offload: losses bitwise ``main_path``'s (its 20
   counted steps and its profiled step 20) and the run's without,
   ``memory_allocated`` after each step (a spilled step's drop at least
   the factors' 264,462,480 bytes, less what the run without offload
   itself moves across those steps), the counters (``prefetch_hit_rate``
   1.0), the ms and host syncs (none) of the spill, prefetch and restore
   steps against the same steps without. Then one NCCL rank a visible card
   (``spawn_world``), each run's counts set to 0 just before and read just
   after on every rank: (a) the flagship on a ``DistributedKFAC``, EIGEN,
   cadence 10/10, ``async_inverse='sliced'``, 31 steps (COMM-OPT; four
   cards also MEM-OPT at 0.25): the decompositions after the swaps at 20
   and 30 bit for bit the same engine's synchronous refresh of its factors
   after 10 and 20, the step ms over steps 11-30 beside ``async_refresh``'s
   dense ones, host syncs by kind of step, peak memory; then 11 steps of
   INVERSE + Newton-Schulz, sliced: ``fused_ns_step_stacked`` inside the
   range the refreshes give, the swapped inverses' residuals against the
   factors they came from <= 5e-2. (b) The async spike probe's MLP on a
   ``DistributedKFAC``, EIGEN, ``'host'``: each rank's boundary wait in the
   pump, and after each swap the preconditioned grads within rtol 5e-3,
   atol 1e-4 of the synchronous engine's refresh of the factors a window
   back. (c) The flagship at cadence 10/10 on ALLREDUCE_BUCKETED, 21
   steps at the f32, int8 and fp8 wires: losses finite and falling, int8's
   final loss within 5 % of f32's, parameters bitwise on every rank,
   ``comms_report()``'s ``wire_bytes`` x 3 <= ``raw_bytes``, the bytes the
   transport's collectives moved in capture step 10 (on more than one card
   the int8 ring bytes below the f32 all-reduce's), the capture and plain
   step ms of each wire, and capture step 20 under torch.profiler with the
   quantize and dequantize scopes' device ms. (e) The flagship on a
   ``DistributedKFAC`` (COMM-OPT on one card, MEM-OPT on more), cadence
   10/10, 11 steps with offload and without: losses bitwise, each rank's
   ``memory_allocated`` drop at a spilled step at least its shard's factor
   bytes, less what the run without offload moves across those steps.
16. ``moe``: the flagship with switch-MoE blocks (blocks 2, 4 and 6 route
   top-1 over 4 experts at capacity factor 1.25, C = 2560 rows an expert;
   57 K-FAC layers, the 24 experts registered as routed layers; the
   load-balance loss at 0.01; expert 3 of block 2 starved by a router
   bias of -1e4), each run's counts set to 0 just before and read just
   after. (a) The dense engine, EIGEN, cadence 10/100, 21 steps through
   ``Trainer.step``: losses finite and falling, ``sym_cov`` 114 a capture
   step, the kl-clip dot and scale once a step, the flash partials once a
   block a step, no host sync on a plain or capture step, the factors'
   bytes (4 x 147,167,337), the starved expert's factors bitwise their
   identity start after every step, step ms by kind, peak memory; a plain
   and a capture step under torch.profiler. (b) Step 0's capture on the
   card and on the CPU (plain versions) from the same weights: the
   routings compared first (flips counted; where none flipped, the loss
   within 1e-4, grads and factors within 1e-3 of their max, the weights
   within 1e-6), and each expert's A factors on the card within 1e-5 of
   the oracle from its routed rows alone. (c) The dense masked dispatch, 3
   steps, against capacity = E on step 0's loss (1e-5) and preconditioned
   grads (1e-3 of max). (d) ``DistributedKFAC`` over NCCL, one rank a
   card, 11 steps: COMM-OPT on one card (losses within 1e-4 of (a)'s),
   MEM-OPT on four (each rank routes its own rows at its own capacity:
   losses finite and falling); parameters bitwise on every rank, launches
   exact, no host sync on a plain or capture step, the starved expert's
   slots bitwise.
17. ``lora``: the ``lora_finetune`` gate (``kfac_tpu_torch.bench_accuracy
   --task lora_finetune``): the digits backbone pretrained on 0-4 with SGD,
   LoRA units (rank 8) over its frozen hidden layers, 300 K-FAC steps on
   5-9 whose last 50 batch losses must have a median of at most 0.2
   (the last batch's loss printed beside it); ``sym_cov`` 10 a step (two
   units' role blocks and the head), the kl-clip dot and scale once a
   step; then the same run on the CPU from the same seed, its pretraining
   loss and first 20 fine-tune losses within 1e-4 of the card's.

18. ``tp_sp``: tensor and sequence parallelism. On any number of cards:
   the flash partials at every (q offset, k offset, shape) triple the ring
   (seq 2 and 4) and zigzag (seq 2 and 4) schedules call at flagship
   width (16 rows, 512 positions, head dim 128; 2 heads a rank beside seq
   2, 4 beside seq 4), each within 1e-5 of max of acc, m and l of the
   plain version with the TF32 control outside it, one triple of each
   shape timed (its rows join the kernel results); then each ring
   composed in one process from those partials on the card, its output
   and input grads within 1e-5 of max of dense causal attention on the
   same q, k, v. On four cards: ``spawn_world`` over NCCL runs the
   flagship through ``Trainer.step`` with a ``DistributedKFAC`` on a
   ``train_mesh`` (the LM sharded by ``TRANSFORMER_TP_RULES``, cadence
   2/6, 8 steps) in (a) dp 1, model 2, seq 2, the ring; (b) dp 1, seq 4,
   zigzag; (c) dp 2, model 2 at fractions 1 and 0.5; (d) (a) under INVERSE
   + Newton-Schulz, each job's counts set to 0 just before and read just
   after: every rank's losses within 1e-4 and its gathered preconditioned
   grads within 1e-3 of max of the one-card dense engine's run from the
   same weights and batch, its flash launches exact for its ring
   position, no host sync on a plain or capture step, the replicated
   parameters bitwise on every rank and the sharded ones across the dp
   ranks of each shard; step ms by kind, peak memory and the bytes each
   collective moves a rank.
19. ``amp``: mixed precision, each run's counts (every form's) set to 0
   just before and read just after, one line a part. (a) The flagship
   computing in bf16 (f32 masters, LayerNorms and logits in f32) through
   ``Trainer.step``, EIGEN, cadence 10/100, 20 steps: losses finite and
   falling, launches exact by form (the flash partials' bf16 form, f32
   ``sym_cov``), no host sync on a plain or capture step, step ms by kind
   beside ``main_path``'s f32 plain median, peak memory; then its plain
   step and the f32 flagship's in turns (5 rounds of f32, bf16, bf16,
   f32) with each one's device busy ms and idle share; step 0's loss and
   grads against the CPU's bf16 run from the same weights (loss within 2u,
   grads within 8u of max, u = 2^-8) with the gap's parts: attention
   through the einsum form on the card. (b) ``factor_dtype = inv_dtype =
   bf16`` on the bf16 flagship at cadence 1/2 for 3 steps on the dense
   engine and on a ``DistributedKFAC`` in a world of this process alone:
   launches exact (``sym_cov``'s bf16 form), factor and decomposition bytes
   half of (a)'s, the KAISA losses within 2u of the dense ones; then the
   f16 flagship with f16 stores for 2 steps (the f16 forms' launches). (c)
   ``kfac_tpu_torch.examples.train_amp`` in f16 with the JAX slow test's
   contract (40 steps, batch 32, init scale 2^24, growth interval 1000):
   skipped >= 1, K-FAC steps 40 - skipped, final loss < 2.3; each step's
   host syncs by kind. (d) The bench's LM stage for the flagship in bf16
   (``AMP_BENCH_WINDOW``, no probes): tokens/s, ``vs_baseline`` and MFU
   against the bf16 peak, beside ``bench_lm``'s f32 reading.

Then each phase's seconds and the script's (``timing``), the card's name
and power limit as nvidia-smi prints them, the
``kernels`` line, and ``{"ok": true, "device": ...}`` as the last line.
Any failed phase makes the exit code 1 and suppresses the last line; no
CUDA card, or no package beside this script, exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import tempfile
import signal
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import torch
from torch.utils import _pytree as pytree

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
HALF_FLOPS_PER_S = 989e12  # H100 SXM bf16 and f16 tensor cores, dense
# unit roundoff of the 16-bit forms: their tolerances are multiples of it
HALF_U = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
HALF_NAMES = {torch.bfloat16: 'bf16', torch.float16: 'f16'}

FLAGSHIP = dict(batch=16, seq=512, d_model=512, layers=6, heads=4, vocab=8192)
STEPS = 20
NS_STEPS = 101  # inverse refreshes at 0 (cold) and 100 (warm)
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
# the digits MLP (64 -> 64 -> 10, batch 100): its preconditioned gradients
# (d_out, d_in + bias) and its covariances (rows, width)
DIGITS_PMATS = [(64, 65), (10, 65)]
DIGITS_COVS = [(100, 65), (100, 64), (100, 10)]
# ResNet-32 at the bench's resnet32_cifar (batch 256, 32x32x3, 10 classes,
# f32): its K-FAC layers (31 convolutions and the head), their
# preconditioned gradients (C_out, C_in kh kw; the head (10, 64 + bias)),
# and the covariances a capture step gives sym_cov (rows, width): the
# convolutions' A over patch rows (N Ho Wo) and G over output positions,
# the head's A and G over the batch
RESNET32 = dict(depth=32, batch=256, hw=32, classes=10)
RESNET_LAYERS = 32
RESNET_PMATS = (
    [(16, 27)] + [(16, 144)] * 10 + [(32, 144)] + [(32, 288)] * 9 + [(64, 288)]
    + [(64, 576)] * 9 + [(10, 65)]
)
RESNET_COVS = [
    (262144, 27), (262144, 144), (65536, 144), (65536, 288), (16384, 288), (16384, 576),
    (262144, 16), (65536, 32), (16384, 64), (256, 65), (256, 10),
]
# sym_cov's TF32 control must fail the 1e-5 tolerance at every shape. Its
# rounding of normal inputs averages out over N (the flagship's (8192,
# 2049) read 2.5e-5 of max|C|, PERF.md) and reads too little over a few
# entries (the MoE router's (8192, 4): 6.1e-6), so past 8,192 rows and
# under 8 columns the inputs carry low mantissa bits that TF32 drops: each
# entry 2^k (1 + u 2^-11), u uniform in [0, 1), which TF32 rounds to 2^k,
# a bias of 2^-12 a factor that no N averages away
LOW_BITS_MIN_ROWS = 8192
LOW_BITS_MAX_WIDTH = 8
# the norm epilogue against f64, each sum of squares relative to itself:
# between the f32 kernel's worst reading and the bf16 control's least
# (PERF.md, Findings)
NORM_RTOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and obj.get('passed') is False:
        print(f'chip_smoke: {obj.get("phase")} failed at {failed_parts(obj)}', file=sys.stderr, flush=True)


def failed_parts(obj, path='') -> list[str]:
    """The paths in ``obj`` whose ``passed`` is False or that hold an
    ``error`` or ``trace_error``, with the error's text."""
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj) for p in failed_parts(v, f'{path}[{i}]')]
    if not isinstance(obj, dict):
        return []
    out = [path or '.'] if obj.get('passed') is False else []
    out += [f'{path}.{k}: {str(obj[k])[:300]}' for k in ('error', 'trace_error') if k in obj]
    return out + [p for k, v in obj.items() for p in failed_parts(v, f'{path}.{k}')]


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
    iters = max(5, min(200, int(0.1 / max(est, 1e-6))))
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


def grouped_dot_cases(ps, gs, lr, kl_clip):
    """The grouped kl-clip dot as the engine calls it over every layer of a
    model, without and with the norm epilogue: the wrapper's call, the plain
    version, and the checks of both (see ``kernel_cases``)."""
    from kfac_tpu_torch.ops import klclip

    numel = sum(p.numel() for p in ps)
    layers = len(ps)

    def cmp_grouped(got, want):
        # vg_sum against the sum over the layers of lr^2 sum|p*g|
        ref = sum(float((p * g).abs().sum()) for p, g in zip(ps, gs)) * lr**2
        return abs(float(got[1] - want[1])), ref

    def grouped_holds(got):
        terms, vg, scale = got[:3]
        again = klclip.klclip_dot_many(ps, gs, lr, kl_clip)
        fold = sum(terms.unbind())  # Python's sum, as the engine's plain path
        return (
            all(torch.equal(x, y) for x, y in zip(got, again))
            and torch.equal(vg, fold)
            and torch.equal(scale, klclip.kl_clip_scale_plain(fold, kl_clip))
        )

    def dot_control_rel(ctrl):
        return max(
            abs(float(b - klclip.klclip_dot_plain(p, g))) / float((p * g).abs().sum())
            for b, p, g in zip(ctrl, ps, gs)
        )

    dot = dict(
        name='klclip_dot', shape=[layers, numel],
        kernel=lambda: klclip.klclip_dot_many(ps, gs, lr, kl_clip),
        plain=lambda: klclip.klclip_dot_many_plain(ps, gs, lr, kl_clip),
        # one PyTorch call a layer, the engine's expression before this kernel
        library=lambda: [torch.sum(p * g) for p, g in zip(ps, gs)],
        extra=dict(library_call=f'torch.sum(p * g), once for each of the {layers} layers'),
        compare=cmp_grouped, rtol=1e-7, invariant=grouped_holds,
        tol_rule='vg_sum within 1e-7 x sum of lr^2 sum|p*g|; terms, vg_sum and scale '
                 'run-to-run identical; vg_sum the fold of the terms and the scale the '
                 'plain expression over it, bit for bit',
        control=lambda: [(p.bfloat16() * g.bfloat16()).float().sum() for p, g in zip(ps, gs)],
        control_compare=dot_control_rel,
        control_rule=f'bf16 products, f32 sum, worst of the {layers} layers',
        # p and g read once; the terms, vg_sum and scale written once
        nbytes=4 * (2 * numel + layers + 2), flops=2 * numel,
        device_kernels=DOT_KERNELS,
    )

    # the norms against an f64 version, each pair's sum of squares relative
    # to itself (a sum of squares has no cancellation to scale by)
    sq64 = [(float(torch.sum(g.double() ** 2)), float(torch.sum(p.double() ** 2)))
            for p, g in zip(ps, gs)]

    def norm_errors(g_sq, p_sq):
        """(abs error, reference) of the worst of every pair's two sums."""
        errs = [
            (abs(float(v) - ref), ref)
            for k, (gv, pv) in enumerate(zip(g_sq.unbind(), p_sq.unbind()))
            for v, ref in ((gv, sq64[k][0]), (pv, sq64[k][1]))
        ]
        return max(errs, key=lambda e: e[0] / e[1])

    def norms_hold(got):
        again = klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip)
        return (
            all(torch.equal(x, y) for x, y in zip(got, again))  # repeatable
            # the dot's outputs bitwise those of the instantiation without norms
            and all(torch.equal(x, y) for x, y in zip(got[:3], klclip.klclip_dot_many(ps, gs, lr, kl_clip)))
            and grouped_holds(got)
        )

    def norm_control_rel(ctrl):
        return max(
            abs(float(v) - ref) / ref
            for k, (gv, pv) in enumerate(ctrl)
            for v, ref in ((gv, sq64[k][0]), (pv, sq64[k][1]))
        )

    norms = dict(
        name='klclip_dot_norms', shape=[layers, numel],
        kernel=lambda: klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip),
        plain=lambda: klclip.klclip_dot_many_plain(ps, gs, lr, kl_clip, norms=True),
        library=lambda: (
            [torch.sum(p * g) for p, g in zip(ps, gs)], torch._foreach_norm(gs),
            torch._foreach_norm(ps),
        ),
        extra=dict(
            library_call=f'torch.sum(p * g) for each of the {layers} layers, and '
                         '_foreach_norm of the gs and of the ps',
            reference='f64 sums of squares',
        ),
        compare=lambda got, want: norm_errors(got[3], got[4]),
        rtol=NORM_RTOL, invariant=norms_hold,
        tol_rule=f'each pair\'s sum(g*g) and sum(p*p) within {NORM_RTOL:g} of itself (f64); '
                 'terms, vg_sum and scale bitwise those without norms; all run-to-run identical',
        control=lambda: [
            ((g.bfloat16() * g.bfloat16()).float().sum(), (p.bfloat16() * p.bfloat16()).float().sum())
            for p, g in zip(ps, gs)
        ],
        control_compare=norm_control_rel,
        control_rule=f'bf16 products, f32 sum, worst of the {2 * layers} sums',
        # p and g read once; terms, vg_sum, scale and the 2 norms written once
        nbytes=4 * (2 * numel + 3 * layers + 2), flops=6 * numel,
        device_kernels=DOT_KERNELS,
    )
    return [dot, norms]


def low_bit_inputs(n: int, d: int, gen) -> torch.Tensor:
    """(n, d) entries ``2^k (1 + u 2^-11)``: k uniform in [-2, 2] a column,
    u uniform in [0, 1). TF32 (10 mantissa bits) rounds each to ``2^k``, so
    a TF32 product is biased low by about 2^-12 of max|C| at any N; the
    3xTF32 kernel keeps the dropped bits in its low part."""
    dev = torch.device('cuda')
    u = torch.rand(n, d, generator=gen, device=dev)
    k = torch.randint(-2, 3, (d,), generator=gen, device=dev).float()
    return torch.exp2(k) * (1 + u * 2.0**-11)


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
    # the shortest N the plan splits. (100, 65), (100, 64), (100, 10): the
    # digits MLP's A and G factors at its batch of 100 (D = 65 and 10 take
    # the path for rows off a 16-byte boundary).
    # (2048, 513) and (2048, 2049): a rank's A factors in the kaisa phase at
    # four ranks (its 4 of the 16 rows of the batch).
    # RESNET_COVS: ResNet-32's covariances at the bench's batch of 256.
    # MOE_COVS: the switch-MoE flagship's expert buffers and routers;
    # LORA_COVS: the LoRA fine-tune's role blocks; TP_SP_COVS: the tp_sp
    # phase's gathered rows (a rank's 4096 or 2048 tokens, whole widths).
    for n, d in ((8192, 513), (8192, 2049), (8192, 512), (8192, 2048), (77, 130),
                 (512, 129), (512, 513), (1024, 129), *DIGITS_COVS, (2048, 513), (2048, 2049),
                 *RESNET_COVS, *MOE_COVS, *LORA_COVS, *TP_SP_COVS):
        low_bits = n > LOW_BITS_MIN_ROWS or d < LOW_BITS_MAX_WIDTH
        a = low_bit_inputs(n, d, gen) if low_bits else randn(n, d)
        extra, also_timed = split_fields(n, d, lambda a=a: sym_cov.sym_cov(a))
        extra = dict(extra, inputs='2^k (1 + u 2^-11)' if low_bits else 'normal')
        cases.append(dict(
            name='sym_cov', shape=[n, d],
            kernel=lambda a=a: sym_cov.sym_cov(a),
            plain=lambda a=a: sym_cov.sym_cov_plain(a),
            library=lambda a=a: torch.matmul(a.T, a),
            compare=max_err, rtol=1e-5,
            tol_rule='1e-5 x max|C|, exactly symmetric and run-to-run identical',
            control=tf32(lambda a=a: sym_cov.sym_cov_plain(a)),
            control_rule='plain version with TF32 matmuls' + (
                ', on inputs whose low mantissa bits TF32 drops' if low_bits else ''
            ),
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
    # gradient of the flagship (q, k, v, out; fc1; fc2 of 6 blocks), of
    # the digits MLP (dense0, head) and of ResNet-32 (31 convs, the head)
    lr, kl_clip = 0.1, 0.001  # the flagship's and the digits task's
    for shapes in (FLAGSHIP_PMATS, DIGITS_PMATS, RESNET_PMATS):
        ps, gs = [randn(*shape) for shape in shapes], [randn(*shape) for shape in shapes]
        cases += grouped_dot_cases(ps, gs, lr, kl_clip)

    def cmp_many(got, want):
        return max(map(max_err, got, want), key=lambda e: e[0])

    for shapes in (FLAGSHIP_PMATS, RESNET_PMATS):
        ps = [randn(*shape) for shape in shapes]
        s = torch.tensor(0.37, device=dev)
        numel = sum(p.numel() for p in ps)
        # timed in place on copies, as the engine calls it: a scale of 1
        # keeps repeated calls exact
        work, lib_work = [p.clone() for p in ps], [p.clone() for p in ps]
        one = torch.ones((), device=dev)
        cases.append(dict(
            name='klclip_scale', shape=[len(ps), numel],
            kernel=lambda ps=ps, s=s: klclip.klclip_scale_many([p.clone() for p in ps], s, in_place=True),
            timed=lambda work=work, one=one: klclip.klclip_scale_many(work, one, in_place=True),
            plain=lambda ps=ps, s=s: klclip.klclip_scale_many_plain(ps, s),
            library=lambda ps=ps, s=s: torch._foreach_mul(ps, s),
            compare=cmp_many, rtol=0.0, tol_rule='exact, out of place as well',
            invariant=lambda got, ps=ps, s=s: all(map(torch.equal, klclip.klclip_scale_many(ps, s), got)),
            control=lambda ps=ps, s=s: [(p.bfloat16() * s).float() for p in ps],
            control_rule='bf16 products',
            nbytes=4 * (2 * numel + 1), flops=numel,
            device_kernels=('klclip_scale_multi_kernel',),
            also_timed=dict(
                # new outputs, allocated a tensor at a time by the wrapper
                ms_out_of_place=lambda ps=ps, s=s: klclip.klclip_scale_many(ps, s),
                library_in_place_ms=lambda lib_work=lib_work, one=one: torch._foreach_mul_(lib_work, one),
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
    # the 16-bit forms (bf16, f16) at the flagship's factor widths and its
    # attention; tolerances from the dtype's unit roundoff u
    cases += half_kernel_cases(randn)

    def ns_errors(got, want):
        # x_new and mx_new relative to their own max, the residual relative
        # to itself
        r_err = abs(float(got[2]) - float(want[2]))
        return [max_err(got[0], want[0]), max_err(got[1], want[1]), (r_err, float(want[2]))]

    def cmp_ns(got, want):
        return max(ns_errors(got, want), key=lambda p: p[0] / p[1])

    def detail_ns(got, want):
        return dict(zip(('x_new', 'mx_new', 'resid'), (e / r for e, r in ns_errors(got, want))))

    def cmp_ns_stacked(got, want):
        # the worst slot's worst output, relative to that slot's own scale
        return max(
            (cmp_ns([g[i] for g in got], [w[i] for w in want]) for i in range(want[0].shape[0])),
            key=lambda p: p[0] / p[1],
        )

    def detail_ns_stacked(got, want):
        per_slot = [detail_ns([g[i] for g in got], [w[i] for w in want])
                    for i in range(want[0].shape[0])]
        return {k: max(d[k] for d in per_slot) for k in per_slot[0]}

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
    # the stacked step at each block a rank of the kaisa phase solves on
    # this machine's cards: one per A and G store
    for slots, d in kaisa_ns_blocks(torch.cuda.device_count()):
        a = randn(slots, 2048, d)
        eye = torch.eye(d, device=dev)
        m = (a.mT @ a / 2048 + 0.003 * eye).contiguous()
        lam_max = m.abs().sum(-1).amax(-1)[:, None, None]
        x, mx = eye / lam_max, m / lam_max
        for _ in range(2):
            x, mx, _ = newton_schulz.fused_ns_step_plain(m, x, mx)
        x, mx = x.contiguous(), mx.contiguous()
        tile = newton_schulz.plan(d, sms, slots)

        def library(m=m, x=x, mx=mx, eye=eye, d=d):
            x_new = torch.bmm(x, 2.0 * eye - mx)
            mx_new = torch.bmm(m, x_new)
            return x_new, mx_new, torch.linalg.matrix_norm(eye - mx_new) / math.sqrt(d)

        def two_d(m=m, x=x, mx=mx, tile=tile):
            """Each slot through the 2-D launch at the stack's tile."""
            return [newton_schulz.fused_ns_step(m[i], x[i], mx[i], tile=tile)
                    for i in range(m.shape[0])]

        cases.append(dict(
            name='fused_ns_step_stacked', shape=[slots, d, d],
            kernel=lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step_stacked(m, x, mx),
            plain=lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step_plain(m, x, mx),
            library=library, compare=cmp_ns_stacked, detail=detail_ns_stacked, rtol=NS_RTOL,
            # bit for bit the 2-D launch slot by slot, and from run to run
            invariant=lambda got, m=m, x=x, mx=mx, two_d=two_d: all(
                torch.equal(got[k][i], one[k]) for i, one in enumerate(two_d()) for k in range(3)
            ) and all(
                torch.equal(g, h)
                for g, h in zip(got, newton_schulz.fused_ns_step_stacked(m, x, mx))
            ),
            tol_rule=(f'{NS_RTOL:g} x each slot\'s max|x_new|, max|mx_new| and resid; '
                      'each slot bitwise the 2-D launch at the same tile; run-to-run identical'),
            control=tf32(lambda m=m, x=x, mx=mx: newton_schulz.fused_ns_step_plain(m, x, mx)),
            control_rule='plain version with TF32 matmuls',
            nbytes=4 * slots * (5 * d * d + 1), flops=4 * slots * d**3, tf32x3=True,
            extra=dict(tile=tile, ctas=slots * math.prod(newton_schulz.grid(d, tile))),
        ))
    return cases


def accumulated_in(a: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """The control of a 16-bit covariance: ``a^T a / n`` with the sum kept
    in a's dtype, one ``rows``-row block's product added at a time."""
    acc = torch.zeros(a.shape[1], a.shape[1], dtype=a.dtype, device=a.device)
    for blk in a.split(rows):
        acc = acc + blk.T @ blk
    return acc.float() / a.shape[0]


def half_kernel_cases(randn) -> list[dict]:
    """The bf16 and f16 forms of ``sym_cov`` (the flagship's A and G
    widths at its 8192 rows, in the layout its A builders give: rows
    padded to 64 values where the width is not a multiple of 8), of
    ``sym_cov_ema`` (the blend into an f32 factor) and of the flash
    partials (the flagship's attention; in bf16 also two ring steps of the
    tp_sp phase), each against its plain oracle (the TPU kernel's function
    in that dtype), timed beside the library call in the dtype and bounded
    at the 16-bit tensor-core peak and the HBM rate. Each also reports its
    device ms and the library call's (torch.profiler): at these sizes
    back-to-back CUDA events time the host's enqueue.

    - ``sym_cov``: within 2u of max|C| (one flip of its single rounding);
      the control, the sum kept in the dtype (``accumulated_in``), is
      outside. Exactly symmetric and run-to-run identical. At the padded
      widths, ``ms_contiguous_input`` is the wrapper's call on a contiguous
      ``a``, which it copies into padded rows first.
    - ``sym_cov_ema``: within 1e-5 of max|coeff a^T a| (the f32 form's;
      the products are exact in f32); the control, a^T a rounded to the
      dtype before the blend, is outside. Exactly symmetric and
      run-to-run identical.
    - flash on normal inputs: acc within 2u of max|acc| (one rounding of
      each p, at a key tile's running max or the row's max), m and l within
      1e-5 of max; no control. On ``flash_attention.exact_inputs`` (every
      rounding point and sum exact): acc bitwise (tolerance 0), m and l
      within 1e-5 of max; the control, p left unrounded, moves acc, and the
      einsum form (``q * scale`` rounded to the dtype) moves m past 1e-5.
    """
    from kfac_tpu_torch.ops import cov_ema, flash_attention, sym_cov

    dev = torch.device('cuda')
    sms = sym_cov.sm_count(torch.cuda.current_device())
    cases = []
    for dt, tag in HALF_NAMES.items():
        u = HALF_U[dt]

        def cmp16(got, want):
            return max_err(got.float(), want.float())

        for n, d in ((8192, 513), (8192, 2049), (8192, 512), (8192, 2048)):
            contiguous = randn(n, d).to(dt)
            padded = d % sym_cov.ROW_ALIGN16 != 0
            a = sym_cov.kernel_rows(n, d, dt, dev, padded).copy_(contiguous)
            p = sym_cov.plan16(n, d, sms)
            cases.append(dict(
                name=f'sym_cov_{tag}', shape=[n, d],
                kernel=lambda a=a: sym_cov.sym_cov(a),
                plain=lambda a=a: sym_cov.sym_cov_plain(a),
                library=lambda a=contiguous: torch.matmul(a.T, a),
                compare=cmp16, rtol=2 * u,
                tol_rule=f'2u = {2 * u:g} x max|C| (one rounding flip); exactly symmetric, '
                         'run-to-run identical',
                control=lambda a=a: accumulated_in(a),
                control_rule=f'sum kept in {tag}, 8 rows at a time',
                invariant=lambda got, a=a: (
                    torch.equal(got, got.T) and torch.equal(got, sym_cov.sym_cov(a))
                ),
                nbytes=2 * (n * d + d * d), flops=n * d * (d + 1),
                flops_per_s=HALF_FLOPS_PER_S, device_kernels=SYM16_KERNELS, library_device=True,
                also_timed=(
                    dict(ms_contiguous_input=lambda a=contiguous: sym_cov.sym_cov(a)) if padded else {}
                ),
                extra=dict(row_stride=a.stride(0), walk=dict(
                    whole=p.whole, split=p.split, slices=p.slices, rows_per_slice=p.rows_per_slice,
                    ctas=p.ctas, fill=p.fill, scratch_mib=p.scratch_bytes / 2**20,
                )),
            ))
        for n, d in ((8192, 2049), (512, 256)):
            a = sym_cov.kernel_rows(n, d, dt, dev, d % sym_cov.ROW_ALIGN16 != 0).copy_(
                randn(n, d).to(dt))
            a32 = a.float()
            f = sym_cov.sym_cov_plain(randn(n, d))
            beta, coeff = 0.95, 0.05 / n
            scale = float((coeff * (a32.T @ a32)).abs().max())

            def cmp_ema(got, want, scale=scale):
                return float((got - want).abs().max()), scale

            cases.append(dict(
                name=f'sym_cov_ema_{tag}', shape=[n, d],
                kernel=lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema(f, a, b, c),
                plain=lambda a=a, f=f, b=beta, c=coeff: cov_ema.sym_cov_ema_plain(f, a, b, c),
                library=lambda a=a32, f=f, b=beta, c=coeff: torch.addmm(f, a.T, a, beta=b, alpha=c),
                library_call='addmm(F, a.T, a) of a in f32', compare=cmp_ema, rtol=1e-5,
                tol_rule='1e-5 x max|coeff a^T a|, exactly symmetric and run-to-run identical',
                invariant=lambda got, a=a, f=f, b=beta, c=coeff: (
                    torch.equal(got, got.T) and torch.equal(got, cov_ema.sym_cov_ema(f, a, b, c))
                ),
                control=lambda a=a, f=f, b=beta, c=coeff: b * f + c * (a.T @ a).float(),
                control_rule=f'a^T a rounded to {tag} before the blend',
                nbytes=2 * n * d + 4 * (d * (d + 1) // 2 + d * d),
                flops=n * d * (d + 1) + 3 * d * (d + 1) // 2, flops_per_s=HALF_FLOPS_PER_S,
                device_kernels=SYM16_KERNELS, library_device=True,
            ))
        gen = torch.Generator().manual_seed(1)
        b, dh = FLAGSHIP['batch'], 128
        # the flagship's attention, then (bf16) the tp_sp phase's ring step
        # of seq 2 (256 rows at offset 256) and zigzag seq 4's last chunk
        flash_shapes = [(FLAGSHIP['seq'], FLAGSHIP['heads'], 0)]
        if dt == torch.bfloat16:
            flash_shapes += [(256, 2, 256), (64, 4, 448)]
        for s_, h, q_off in flash_shapes:
            pairs = visible_pairs(s_, s_, q_off, 0)
            for inputs in ('normal', 'exact'):
                if inputs == 'exact':
                    q, k, v = (x.to(dev) for x in flash_attention.exact_inputs(b, s_, h, dh, dt, gen))
                else:
                    q, k, v = (randn(b, s_, h, dh).to(dt) for _ in range(3))
                mask = (torch.arange(s_, device=dev)[:, None] + q_off) >= torch.arange(s_, device=dev)

                def sdpa(q=q, k=k, v=v, mask=None if q_off == 0 else mask):
                    # at offset 0 the causal flag, SDPA's fastest form
                    return torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                        is_causal=mask is None,
                    )

                def oracle(q=q, k=k, v=v, q_off=q_off):
                    return flash_attention.attend_partials_rounded(q, k, v, q_off, 0, True)

                def ml_hold(got, oracle=oracle):
                    want = oracle()
                    return all(
                        float((x - w).abs().max()) <= 1e-5 * float(w.abs().max())
                        for x, w in zip(got[1:], want[1:])
                    )

                exact = inputs == 'exact'
                einsum_m = flash_attention.attend_partials_einsum(q, k, v, q_off, 0, True)[1]
                m_ref = oracle()[1]
                cases.append(dict(
                    name=f'flash_attention_partials_{tag}', shape=[b, s_, h, dh],
                    kernel=lambda q=q, k=k, v=v, q_off=q_off: flash_attention.flash_attention_partials(
                        q, k, v, q_off, 0, True),
                    plain=oracle, library=sdpa,
                    library_call='scaled_dot_product_attention in the dtype with the causal mask',
                    compare=lambda got, want: max_err(got[0], want[0]),
                    rtol=0.0 if exact else 2 * u,
                    tol_rule=('acc bitwise' if exact else f'acc within 2u = {2 * u:g} x max|acc|')
                    + '; m and l within 1e-5 x max',
                    invariant=ml_hold,
                    control=(
                        (lambda q=q, k=k, v=v, q_off=q_off: flash_attention.attend_partials_rounded(
                            q, k, v.float(), q_off, 0, True))
                        if exact else oracle
                    ),
                    control_rule='p left unrounded' if exact else 'none (normal inputs)',
                    nbytes=2 * 3 * b * s_ * h * dh + 4 * (b * s_ * h * dh + 2 * b * h * s_),
                    flops=4 * dh * pairs * b * h, flops_per_s=HALF_FLOPS_PER_S,
                    no_control=not exact, device_kernels=FLASH16_KERNELS, library_device=True,
                    extra=dict(
                        inputs=inputs, q_offset=q_off, k_offset=0, visible_pairs=pairs,
                        einsum_form_m_rel_err=float((einsum_m - m_ref).abs().max() / m_ref.abs().max()),
                    ),
                ))
    return cases


def kaisa_ns_blocks(world: int) -> list[tuple[int, int]]:
    """(slots, d) of the stacked Newton-Schulz solves on one rank of the
    kaisa phase at ``world`` ranks: a rank's block (its 1/world of the
    padded slots) of each A and G store the engine builds for the flagship
    at the default configuration."""
    import kfac_tpu_torch as kt
    from kfac_tpu_torch.models import TransformerLM
    from kfac_tpu_torch.parallel import kaisa

    cfg, dev = FLAGSHIP, torch.device('cuda')
    model = TransformerLM(
        vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
        num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=dev,
    )
    reg = kt.register_model(model, skip_layers=['lm_head'], device=dev)
    config = kt.KFACPreconditioner(reg, device=dev)
    buckets = kaisa.build_buckets(reg, world, config.bucket_granularity)
    stores = kaisa.build_stores(reg, world, config.bucket_granularity,
                                config.colocate_factors, buckets)
    return list(dict.fromkeys((sb.padded // world, sb.d) for side in stores for sb in side))


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


# the 16-bit kernels' device names (csrc/sym_cov.cu, csrc/flash_attn.cu)
SYM16_KERNELS = ('sym_cov_wgmma_kernel', 'sym_cov16_reduce_kernel')
FLASH16_KERNELS = ('flash_wgmma_kernel',)


def library_device_ms(fn, calls=20) -> float | str:
    """Device ms of one ``fn()`` from torch.profiler: every device kernel
    it launches, summed, over ``calls`` calls. 100 lead kernels of a kind
    no library call launches go first (a trace can lose a pass's first
    records) and are left out."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, dtype=torch.int32, device='cuda')
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            lead.bitwise_not_()
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(
        evt.self_device_time_total / 1e3 for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.count and 'bitwise_not' not in evt.key
    )
    return total / calls if total else 'not measured'


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
        if case.get('no_control'):
            rejects_control = True  # a tolerance that no control is held to
        if 'einsum_form_m_rel_err' in extra and case['rtol'] == 0.0:
            # exact inputs: the einsum form's m must fall outside 1e-5 too
            rejects_control &= extra['einsum_form_m_rel_err'] > 1e-5
        passed = err <= tol and holds and rejects_control
        timed = case.get('timed', case['kernel'])
        if 'device_kernels' in case:
            # back-to-back CUDA events time host enqueue at these sizes
            extra['device_ms'], extra['device_launches_seen'] = profiled_device_ms(
                timed, case['device_kernels']
            )
        if case.get('library_device'):
            extra['library_device_ms'] = library_device_ms(case['library'])
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
        bms, by = bound_ms(case['nbytes'], case['flops'], case.get('flops_per_s', F32_FLOPS_PER_S))
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


def lm_model(cfg, device, moe=None, dtype=torch.float32):
    """The LM of ``cfg`` computing in ``dtype`` from seed 1; with ``moe``
    (``MOE``), its switch-MoE blocks at ``moe['capacity_factor']``, and the
    router bias of each ``moe['starved']`` expert at -1e4, so that expert
    never gets a token."""
    from kfac_tpu_torch.models import TransformerLM

    extra = {} if moe is None else dict(
        num_experts=moe['experts'], moe_every=moe['moe_every'],
        moe_capacity_factor=moe['capacity_factor'],
    )
    model = TransformerLM(
        vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
        num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device, dtype=dtype,
        **extra,
    )
    if moe is not None:
        with torch.no_grad():
            for block, e in moe['starved']:
                model.get_submodule(block).router.bias[e] = -1e4
    return model


class LMRun:
    """The bench's K-FAC LM loop through ``Trainer.step`` on one seeded
    batch, weights from seed 1: a capture step every ``capture_every``
    steps, a plain step otherwise. With ``moe`` the flagship's switch-MoE
    configuration (``MOE``): routed experts and the load-balance loss. The
    model computes in ``dtype``; a ``factor_dtype`` in ``kfac_kw`` is the
    registry's too, so the capture computes the covariances in it."""

    def __init__(self, cfg, device, capture_every, inv_every, checkpoints=None, moe=None,
                 dtype=torch.float32, **kfac_kw):
        import kfac_tpu_torch as kt
        from kfac_tpu_torch.models import lm_loss
        from kfac_tpu_torch.training import Trainer

        self.device = device
        self.capture_every = capture_every
        model = lm_model(cfg, device, moe, dtype)
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        self.batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
        self.registry = kt.register_model(
            model, skip_layers=['lm_head'], device=device,
            routed_layers=None if moe is None else moe['routed_layers'],
            factor_dtype=kfac_kw.get('factor_dtype', torch.float32),
        )
        self.kfac = kt.KFACPreconditioner(
            self.registry, damping=0.003, lr=0.1, factor_update_steps=capture_every,
            inv_update_steps=inv_every, device=device, **kfac_kw,
        )
        loss = lm_loss(model, 0.0 if moe is None else moe['load_balance'])
        self.loss = loss

        self.config = self.kfac

        def loss_fn(ms, batch):
            # a batch may carry a third element, a weight a row: the
            # observed phase's poisoned batch weighs its loss by NaN
            if len(batch) == 3:
                return loss(batch[:2]) * batch[2][0], ms
            return loss(batch), ms

        self.trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            loss_fn, kfac=self.kfac, checkpoints=checkpoints, device=device,
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
        kernel_launches=sum(k[2] for k in kernels),
        top=[dict(kernel=k[:90], ms=ms, count=n) for k, ms, n in kernels[:15]],
    )


def profile_step(run, i, losses=None) -> dict:
    """Device time by kernel over the run's next step, ``i``, from
    torch.profiler; its loss appended to ``losses`` when given."""
    def stepping():
        loss, _ = run.step()
        if losses is not None:
            losses.append(loss)

    return dict(
        step=i, kind='capture' if i % run.capture_every == 0 else 'plain',
        **device_profile(stepping),
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
        'klclip_dot_norms': klclip.klclip_dot_norms_many,
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
        'klclip_dot_norms': 0,  # only with metrics on
        'klclip_scale': steps,
        'flash_attention_partials': FLAGSHIP['layers'] * steps,
    }


def step_summary(seconds) -> dict:
    plain_ms = sorted(s * 1e3 for i, s in enumerate(seconds) if i % 10 and i > 10)
    return dict(
        step_0_ms=seconds[0] * 1e3, capture_step_ms=seconds[10] * 1e3,
        plain_step_ms_median=plain_ms[len(plain_ms) // 2],
    )


def run_main_path(launches, summary, main_losses, snaps, tail=None) -> bool:
    """The flagship's 20 steps; ``snaps`` takes host copies of its state
    after steps ``RESUME_INTERVAL`` and ``RESUME_STEP``, off the clock;
    ``tail`` the losses of the two profiled steps after them."""
    wrappers = main_path_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100)
    losses, seconds = [], []
    for i in range(STEPS):
        loss, sec = run.step()
        losses.append(loss)
        seconds.append(sec)
        if i + 1 in (RESUME_INTERVAL, RESUME_STEP):
            snaps[i + 1] = run_snapshot(run)
    main_losses.extend(losses)
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
        profile_step(run, STEPS, tail), profile_step(run, STEPS + 1, tail),
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


def digits_expected_launches(steps: int, layers: int = 2) -> dict:
    """Launches of a digits recipe: an SGD and a K-FAC run of ``steps``
    steps, each after two warm-up steps on a scratch model; the K-FAC run
    captures every 5 steps (``layers`` layers, 2 factors each) and
    preconditions every step, kl-clip on."""
    kfac_steps = 2 + steps
    captures = 1 + len(range(0, steps, 5))  # the warm-up's step 0, then the run's
    return {
        'sym_cov': 2 * layers * captures,
        'sym_cov_ema': 0,
        'klclip_dot': kfac_steps,
        'klclip_dot_norms': 0,
        'klclip_scale': kfac_steps,
        'flash_attention_partials': 0,
        'fused_ns_step': 0,
    }


def window_step_ms(curve, every) -> float:
    """Median over the curve's evaluation windows of the mean step ms."""
    walls = [0.0] + [wall for _, wall, _ in curve]
    return statistics.median((b - a) * 1e3 / every for a, b in zip(walls, walls[1:]))


# the digits recipes' K-FAC layers: the MLP's dense0 and head; the CNN's
# Conv_0, Conv_1 and Dense_0
DIGITS_LAYERS = {'digits_mlp': 2, 'digits_cnn': 3}


def run_digits(launches, name='digits_mlp') -> bool:
    """The ``digits_mlp`` (or ``digits_cnn``) recipe of
    ``kfac_tpu_torch.bench_accuracy`` on the card: SGD and K-FAC, 600 steps
    each from one seed, the self-calibrating target; passes when both
    finals are finite and K-FAC reaches the target in fewer steps than
    SGD."""
    import contextlib

    from kfac_tpu_torch import bench_accuracy

    wrappers = main_path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with contextlib.redirect_stdout(sys.stderr):  # its own JSON lines
        out = bench_accuracy.run_task('cuda', seed=0, name=name)
    launches.update({n: w.launches for n, w in wrappers.items()})
    task = bench_accuracy.TASKS[name]('cuda')
    expected = digits_expected_launches(task['max_steps'], DIGITS_LAYERS[name])
    k_steps, s_steps = out['kfac_steps_to_target'], out['sgd_steps_to_target']
    finite = all(math.isfinite(v) for v in (out['final_sgd'], out['final_kfac']))
    passed = (
        finite and k_steps is not None and s_steps is not None and k_steps < s_steps
        and launches == expected
    )
    emit(dict(
        phase=name, **out,
        sgd_step_ms_median=window_step_ms(out['sgd_curve'], task['eval_every']),
        kfac_step_ms_median=window_step_ms(out['kfac_curve'], task['eval_every']),
        step_ms_rule=f'median over the curve\'s windows of {task["eval_every"]} steps, '
                     'evaluation off the clock',
        launches=launches, expected_launches=expected, passed=passed,
    ))
    return passed


OBSERVED_HEALTH = dict(warn=False, skip_nonfinite=False)


def counted_step(run):
    """One ``Trainer.step`` under ``torch.cuda.set_sync_debug_mode('warn')``:
    (loss, seconds, host syncs the step made). The loss is read after."""
    import warnings

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            run.state, loss = run.trainer.step(run.state, run.batch)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    syncs = sum('synchroniz' in str(w.message) for w in caught)
    return float(loss), seconds, syncs


def step_kinds(seconds, syncs, capture_every, inv_every) -> dict:
    """Step ms and syncs by kind: step 0 (refresh and capture), the median
    capture step and the median plain step after it."""
    kinds = {'refresh': [], 'capture': [], 'plain': []}
    for i, (sec, n) in enumerate(zip(seconds, syncs)):
        kind = 'refresh' if i % inv_every == 0 else 'capture' if i % capture_every == 0 else 'plain'
        kinds[kind].append((sec * 1e3, n))
    return {
        kind: dict(
            steps=len(v), ms_median=statistics.median(ms for ms, _ in v),
            syncs_max=max(n for _, n in v),
        )
        for kind, v in kinds.items() if v
    }


def fault_checks(run, layer) -> dict:
    """The three injected faults on a flagship run (``LMRun`` or
    ``DistLMRun``), after its counted steps; each checked on the
    sentinel's counters (every rank holds them)."""
    import dataclasses as dc

    kfac, trainer, config = run.kfac, run.trainer, run.config
    names = list(run.registry.layers)
    li = names.index(layer)
    out = {}

    def params():
        return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    # 1. a batch whose loss weight is NaN: skipped, nothing moves
    config.health = dc.replace(config.health, skip_nonfinite=True)
    before, a_before = params(), {k: v.clone() for k, v in run.kstate.a.items()}
    step0 = run.kstate.step
    nan = torch.full((run.batch[0].shape[0],), float('nan'), device=run.device)
    run.state, _ = trainer.step(run.state, (*run.batch, nan))
    after = params()
    out['nan_batch'] = dict(
        skipped_steps=int(run.kstate.health.skipped_steps), step_advanced=run.kstate.step == step0 + 1,
        params_unchanged=all(torch.equal(before[n], after[n]) for n in before),
        factors_unchanged=all(torch.equal(a_before[k], run.kstate.a[k]) for k in a_before),
    )
    f = out['nan_batch']
    f['passed'] = (f['skipped_steps'] == 1 and f['step_advanced'] and f['params_unchanged']
                   and f['factors_unchanged'])

    # 2. one capture of the layer's A statistic scaled by 1e12 (each
    # rank's, so the reduced one too): its factor update passes the
    # quarantine threshold and rolls back
    engine_update = kfac.update_factors

    def poisoned(state, stats):
        stats.a[layer] = stats.a[layer] * 1e12
        return engine_update(state, stats)

    kfac.update_factors = poisoned
    config.factor_update_steps = 1  # capture on every step from here
    mult0 = float(run.kstate.health.damping_mult[li])
    a0 = kfac.extract_factors(run.kstate)[layer]['a'].clone()
    run.state, _ = trainer.step(run.state, run.batch)
    h = run.kstate.health
    out['quarantine'] = dict(
        layer=layer, rolled_back=torch.equal(kfac.extract_factors(run.kstate)[layer]['a'], a0),
        damping_mult_before=mult0, damping_mult=float(h.damping_mult[li]),
        quarantined=int(h.quarantined[li]), quarantine_events=int(h.quarantine_events[li]),
        other_layers_quarantined=int(h.quarantined.sum()) - int(h.quarantined[li]),
    )
    q = out['quarantine']
    q['passed'] = (
        q['rolled_back'] and q['damping_mult'] == 10 * mult0 and q['quarantined'] == 1
        and q['quarantine_events'] == 1 and q['other_layers_quarantined'] == 0
    )

    # 3. quarantined captures and a refresh on every step until the layer
    # degrades: its grads then leave as the raw gradient times the scale
    config.inv_update_steps = 1
    engine_step, seen = kfac.step, {}

    def recording(state, grads, stats, loss=None):
        seen['grads'] = {n: g.clone() for n, g in grads.items()}
        return engine_step(state, grads, stats, loss=loss)

    kfac.step = recording
    refreshes = 0
    while int(run.kstate.health.bad_inv[li]) < config.health.degrade_after and refreshes < 10:
        run.state, _ = trainer.step(run.state, run.batch)
        refreshes += 1
    ms = run.kstate.metrics
    scale = ms.scalars[ms.keys.index('kl_clip_scale')]
    prefix = run.registry.param_paths[layer]
    bypassed = {}
    for n in names:
        pre = run.registry.param_paths[n]
        got = trainer.model.get_parameter(f'{pre}.weight').grad
        bypassed[n] = torch.equal(got, seen['grads'][f'{pre}.weight'] * scale)
    del kfac.step, kfac.update_factors  # the engine's own methods again
    out['degrade'] = dict(
        layer=layer, refreshes=refreshes, bad_inv=int(run.kstate.health.bad_inv[li]),
        degrade_after=config.health.degrade_after,
        grads_are_raw_times_scale=bypassed[layer],
        other_layers_bypassed=sum(v for n, v in bypassed.items() if n != layer),
        weight=f'{prefix}.weight',
    )
    d = out['degrade']
    d['passed'] = (
        d['bad_inv'] >= d['degrade_after'] and d['grads_are_raw_times_scale']
        and d['other_layers_bypassed'] == 0
    )
    return out


def run_observed(launches, main_losses, health_after) -> bool:
    """The flagship EIGEN loop of ``main_path`` with the health sentinel
    (``warn=False, skip_nonfinite=False``), metrics and the flight recorder
    on, in turns with the same loop without them: losses against
    ``main_path``'s, launch counts, host syncs of each step, the drains,
    the step ms of each kind with and without; then three injected
    faults, after which the counters go into ``health_after`` (the
    ``kaisa_ops`` phase's reference)."""
    from kfac_tpu_torch import tracing
    from kfac_tpu_torch.health import HealthConfig
    from kfac_tpu_torch.observability import flight_recorder, metrics

    wrappers = main_path_wrappers()
    cuda = torch.device('cuda')
    plain_run = LMRun(FLAGSHIP, cuda, 10, 100)
    run = LMRun(
        FLAGSHIP, cuda, 10, 100, health=HealthConfig(**OBSERVED_HEALTH),
        metrics=True, flight=True,
    )
    counted = {}
    losses, seconds, syncs = [], [], []
    plain_seconds, plain_syncs = [], []
    for i in range(STEPS):
        _, sec, n = counted_step(plain_run)  # not counted: the same path as main_path's
        plain_seconds.append(sec)
        plain_syncs.append(n)
        for w in wrappers.values():
            counted[w] = w.launches
        loss, sec, n = counted_step(run)
        for name, w in wrappers.items():
            launches[name] = launches.get(name, 0) + w.launches - counted[w]
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, main_losses))
    expected = dict(expected_launches(STEPS, len(range(0, STEPS, 10))), fused_ns_step=0)
    expected['klclip_dot_norms'], expected['klclip_dot'] = expected['klclip_dot'], 0
    with_obs = step_kinds(seconds, syncs, 10, 100)
    without = step_kinds(plain_seconds, plain_syncs, 10, 100)
    record = metrics.MetricsCollector().drain(run.state)
    ring = flight_recorder.drain_flight(run.state)
    zero_syncs = with_obs['capture']['syncs_max'] == 0 and with_obs['plain']['syncs_max'] == 0
    drained = (
        record.get('step') == STEPS and len(ring) == STEPS
        and all(math.isfinite(v) for v in record.values() if isinstance(v, float))
    )
    # after the counted steps: the next capture step and plain step of each
    # run under torch.profiler, in turns
    profiles = {}
    for i in (STEPS, STEPS + 1):
        profiles[f'without_{i}'] = profile_step(plain_run, i)
        profiles[f'with_{i}'] = profile_step(run, i)
    faults = fault_checks(run, 'block2/mlp_up')
    health_after.update(tracing.health_counters(run.kstate))
    passed = (
        loss_err <= 1e-6 and launches == expected and zero_syncs and drained
        and all(f['passed'] for f in faults.values())
    )
    emit(dict(
        phase='observed', config=FLAGSHIP, steps=STEPS,
        health=OBSERVED_HEALTH, metrics=True, flight=True,
        losses=losses, loss_rel_err_vs_main_path=loss_err, loss_tol=1e-6,
        step_kinds_with=with_obs, step_kinds_without=without,
        overhead_ms={
            k: with_obs[k]['ms_median'] - without[k]['ms_median'] for k in with_obs
        },
        drain=dict(
            keys=len(record), metric_keys=len(run.kstate.metrics.keys),
            health_keys=sum(k.startswith('health/') for k in record),
            flight_records=len(ring), flight_record_keys=len(ring[-1]) if ring else 0,
            kl_clip_scale=record.get('kl_clip_scale'),
        ),
        launches=launches, expected_launches=expected, faults=faults, profile=profiles,
        passed=passed,
    ))
    return passed


RESUME_SIGNAL_AFTER = 13  # the step after which the resume phase sends SIGTERM
RESUME_INTERVAL = 10  # its periodic saves
RESUME_TAIL = 5  # steps after restore_latest
RESUME_STEP = RESUME_SIGNAL_AFTER + 2  # the emergency checkpoint's step


def resume_expected_launches() -> dict:
    """Launches of every kernel but the NS step over the ``resume`` phase:
    the interrupted run (steps 0-14), the continuity run (steps 10-19),
    the resumed run and its oracle (steps 15-19 each) and the
    Newton-Schulz run's one step at 15; capture on steps 0 and 10."""
    steps = RESUME_STEP + (STEPS - RESUME_INTERVAL) + 2 * RESUME_TAIL + 1
    captures = 2 + 1
    return {
        'sym_cov': 2 * KFAC_LAYERS * captures,
        'sym_cov_ema': 0,
        'klclip_dot': steps,
        'klclip_dot_norms': 0,
        'klclip_scale': steps,
        'flash_attention_partials': FLAGSHIP['layers'] * steps,
    }


def host_copy(tree):
    return pytree.tree_map_only(torch.Tensor, lambda t: t.cpu(), tree)


def run_snapshot(run) -> dict:
    """Host copies of a run's weights, optimizer state, factors and step
    (on the host, so the card's peak memory stays the run's own)."""
    return dict(
        params=host_copy(run.trainer.model.state_dict()),
        optimizer=host_copy(run.trainer.optimizer.state_dict()),
        a=host_copy(run.kstate.a), g=host_copy(run.kstate.g), step=run.kstate.step,
    )


def bitwise_as(run, snap) -> dict:
    """Whether the run's params, momentum buffers and factors equal the
    snapshot's bit for bit, and its step the snapshot's."""
    def same(x, host):
        return torch.equal(x, host.to(x.device))

    opt = run.trainer.optimizer.state_dict()['state']
    return dict(
        params=all(same(v, snap['params'][k]) for k, v in run.trainer.model.state_dict().items()),
        momentum=len(opt) == len(snap['optimizer']['state']) and all(
            same(v['momentum_buffer'], snap['optimizer']['state'][i]['momentum_buffer'])
            for i, v in opt.items()
        ),
        factors=all(same(run.kstate.a[n], v) for n, v in snap['a'].items())
        and all(same(run.kstate.g[n], v) for n, v in snap['g'].items()),
        step=run.kstate.step == snap['step'],
    )


def rel_errs(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def timed_method(obj, name, out: list):
    """Wrap ``obj.name`` so each call's seconds (device work included) land
    in ``out``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return result

    setattr(obj, name, timed)


def synced(fn):
    """(result, seconds) of ``fn()`` between two device synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def interrupted_steps(run, mgr) -> tuple[list, object]:
    """Steps of ``run`` under its manager until ``Preempted``, a real SIGTERM
    sent after step ``RESUME_SIGNAL_AFTER``: per step its loss (None for
    the preempted one), ms, host syncs (``set_sync_debug_mode``, as
    ``counted_step``) and whether it started a save."""
    from kfac_tpu_torch.resilience import Preempted

    steps, preempted = [], None
    for i in range(STEPS):
        if i == RESUME_SIGNAL_AFTER + 1:
            os.kill(os.getpid(), signal.SIGTERM)
        loss = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                run.state, loss = run.trainer.step(run.state, run.batch)
            except Preempted as exc:
                preempted = exc
            finally:
                torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        steps.append(dict(
            step=i, ms=(time.perf_counter() - t0) * 1e3,
            syncs=sum('synchroniz' in str(w.message) for w in caught),
            saved=os.path.isdir(mgr.step_dir(i + 1)),
            loss=None if loss is None else float(loss),
        ))
        if preempted is not None:
            break
    return steps, preempted


def run_resume(launches, u_losses, snaps) -> bool:
    """Checkpoint and preemption on the flagship (see the module's
    docstring, phase 9), against ``main_path``'s losses ``u_losses`` and
    its snapshots ``snaps``."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_resume')
    shutil.rmtree(root, ignore_errors=True)
    try:
        return resume_phase(root, launches, u_losses, snaps)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def resume_phase(root, launches, u_losses, snaps) -> bool:
    from kfac_tpu_torch import checkpoint
    from kfac_tpu_torch.ops import factors, newton_schulz
    from kfac_tpu_torch.resilience import CheckpointManager
    from kfac_tpu_torch.training import TrainState

    wrappers = main_path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    cuda = torch.device('cuda')
    out: dict = dict(phase='resume', config=FLAGSHIP, kfac='default (EIGEN)', cadence=[10, 100])

    # 1. the uninterrupted run is main_path's
    if len(u_losses) != STEPS or set(snaps) != {RESUME_INTERVAL, RESUME_STEP}:
        raise RuntimeError('resume needs main_path\'s losses and snapshots')
    snap10, snap15 = snaps[RESUME_INTERVAL], snaps[RESUME_STEP]

    # 2. interrupted by a real SIGTERM
    mgr = CheckpointManager(
        root, save_interval_steps=RESUME_INTERVAL, keep=2, async_save=True,
        install_signals=('SIGTERM', 'SIGUSR1'),
    )
    emergency_s = []
    timed_method(mgr, 'save_emergency', emergency_s)
    try:
        run = LMRun(FLAGSHIP, cuda, 10, 100, checkpoints=mgr)
        steps, preempted = interrupted_steps(run, mgr)
    finally:
        mgr.close()
    del run
    saved_step = RESUME_STEP
    quiet = [s for s in steps if not s['saved'] and s['step'] % 100]
    out['interrupted'] = dict(
        steps=steps, preempted=preempted is not None and dict(
            signal=preempted.signal_name, step=preempted.step,
            path=os.path.relpath(preempted.path, root),
        ),
        latest=mgr.latest_step(), rotation=mgr.rotation_steps(),
        syncs_max_quiet_steps=max(s['syncs'] for s in quiet),
        refresh_step_syncs=steps[0]['syncs'],
        loss_rel_err_vs_uninterrupted=rel_errs(
            [s['loss'] for s in steps[:-1]], u_losses[:len(steps) - 1]
        ),
        emergency_save_ms=[s * 1e3 for s in emergency_s],
    )
    it = out['interrupted']
    interrupted_ok = (
        preempted is not None and preempted.signal_name == 'SIGTERM'
        and preempted.step == saved_step and it['latest'] == saved_step
        and it['rotation'] == [saved_step, RESUME_INTERVAL]
        and checkpoint.is_committed(mgr.checkpoint_path(saved_step))
        and [s['step'] for s in steps if s['saved']] == [RESUME_INTERVAL - 1, saved_step - 1]
        and it['syncs_max_quiet_steps'] == 0
        and it['loss_rel_err_vs_uninterrupted'] <= 1e-6
    )
    nbytes = {
        s: os.path.getsize(os.path.join(mgr.checkpoint_path(s), checkpoint.PAYLOAD))
        for s in (RESUME_INTERVAL, saved_step)
    }

    # 3. exact continuity from the step-10 checkpoint
    run = LMRun(FLAGSHIP, cuda, 10, 100)
    remat_s = []
    timed_method(run.kfac, 'rematerialize', remat_s)
    (kstate, extra), restore_s = synced(
        lambda: checkpoint.restore(mgr.checkpoint_path(RESUME_INTERVAL), run.kfac)
    )
    _, load_s = synced(lambda: (
        run.trainer.model.load_state_dict(extra['model']),
        run.trainer.optimizer.load_state_dict(extra['optimizer']),
    ))
    run.state = TrainState(kstate)
    run.trainer.resume(run.state)
    bitwise = bitwise_as(run, snap10)
    c_losses = [run.step()[0] for _ in range(STEPS - RESUME_INTERVAL)]
    out['continuity'] = dict(
        restored_step=kstate.step, bitwise=bitwise, losses=c_losses,
        loss_rel_err=rel_errs(c_losses, u_losses[RESUME_INTERVAL:]), loss_tol=1e-6,
        restore_ms=restore_s * 1e3, rematerialize_ms=remat_s[0] * 1e3,
        read_ms=(restore_s - remat_s[0]) * 1e3, load_state_dicts_ms=load_s * 1e3,
    )
    continuity_ok = all(bitwise.values()) and out['continuity']['loss_rel_err'] <= 1e-6
    del run, kstate, extra

    # 4. restore_latest at the emergency step, against the in-memory oracle
    run = LMRun(FLAGSHIP, cuda, 10, 100, checkpoints=CheckpointManager(root, install_signals=()))
    remat_s = []
    timed_method(run.kfac, 'rematerialize', remat_s)
    run.state, latest_s = synced(run.trainer.restore_latest)
    restored_bits = bitwise_as(run, snap15)
    r_losses = [run.step()[0] for _ in range(RESUME_TAIL)]
    del run
    oracle = LMRun(FLAGSHIP, cuda, 10, 100)
    oracle.trainer.model.load_state_dict(snap15['params'])
    oracle.trainer.optimizer.load_state_dict(snap15['optimizer'])
    oracle.state = TrainState(oracle.kfac.rematerialize(dataclasses.replace(
        oracle.kfac.init(), step=snap15['step'],
        a={n: v.to(cuda) for n, v in snap15['a'].items()},
        g={n: v.to(cuda) for n, v in snap15['g'].items()},
    )))
    oracle.trainer.resume(oracle.state)
    o_losses = [oracle.step()[0] for _ in range(RESUME_TAIL)]
    out['restore_latest'] = dict(
        restored_step=snap15['step'] if restored_bits['step'] else None,
        bitwise_as_uninterrupted=restored_bits, losses=r_losses, oracle_losses=o_losses,
        loss_rel_err=rel_errs(r_losses, o_losses), loss_tol=1e-6,
        restore_latest_ms=latest_s * 1e3, rematerialize_ms=remat_s[0] * 1e3,
    )
    latest_ok = restored_bits['step'] and out['restore_latest']['loss_rel_err'] <= 1e-6

    # 5. the same checkpoint into INVERSE + Newton-Schulz
    ns_run = LMRun(
        FLAGSHIP, cuda, 10, 100, checkpoints=CheckpointManager(root, install_signals=()),
        **INVERSE_NS,
    )
    ns0, starts0 = newton_schulz.fused_ns_step.launches, dict(factors.newton_schulz_inverse_info.starts)
    ns_run.state, ns_restore_s = synced(ns_run.trainer.restore_latest)
    ns_launches = newton_schulz.fused_ns_step.launches - ns0
    resid = inverse_residuals(ns_run)
    ns_step = ns_run.kstate.step
    ns_loss = ns_run.step()[0]
    n_factors = 2 * KFAC_LAYERS
    out['newton_schulz'] = dict(
        kfac=INVERSE_NS, restored_step=ns_step,
        fused_ns_step_launches=ns_launches, launch_range=[n_factors, 40 * n_factors],
        starts={k: v - starts0[k] for k, v in factors.newton_schulz_inverse_info.starts.items()},
        max_independent_residual=max(resid), residual_limit=factors.NS_FALLBACK_RESIDUAL,
        restore_latest_ms=ns_restore_s * 1e3, next_loss=ns_loss,
    )
    ns_ok = (
        ns_step == saved_step and n_factors <= ns_launches <= 40 * n_factors
        and max(resid) <= factors.NS_FALLBACK_RESIDUAL and math.isfinite(ns_loss)
    )

    # 6. bytes, and a blocking and an async save of the oracle's state
    extra = oracle.trainer.checkpoint_extras(oracle.state)

    def tensor_bytes(tree):
        return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    # the snapshot alone: its copies enqueued (return), then done
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap, ready = checkpoint.snapshot({'kfac': checkpoint.durable_state(oracle.kstate), **extra})
    snapshot_return_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    snapshot_done_s = time.perf_counter() - t0
    del snap, ready
    # the handle is dropped at once, so the async save below finds the
    # blocking save's pinned block free in PyTorch's host cache
    _, blocking_s = synced(lambda: checkpoint.save(
        os.path.join(root, 'blocking'), oracle.kstate, extra=extra, engine=oracle.kfac,
    ).wait_until_finished())
    handle, return_s = synced(lambda: checkpoint.save(
        os.path.join(root, 'async'), oracle.kstate, extra=extra, engine=oracle.kfac, wait=False,
    ))
    _, wait_s = synced(handle.wait_until_finished)
    out['save'] = dict(
        bytes_on_disk=nbytes,
        bytes_factors=tensor_bytes([oracle.kstate.a, oracle.kstate.g]),
        bytes_params=tensor_bytes(extra['model']),
        bytes_momentum=tensor_bytes(extra['optimizer']),
        snapshot_return_ms=snapshot_return_s * 1e3, snapshot_done_ms=snapshot_done_s * 1e3,
        blocking_save_ms=blocking_s * 1e3, async_return_ms=return_s * 1e3,
        async_wait_ms=wait_s * 1e3,
    )
    del oracle, ns_run, extra
    launches.update({n: w.launches for n, w in wrappers.items()})
    expected = resume_expected_launches()
    counts_ok = {n: launches[n] for n in expected} == expected and launches['fused_ns_step'] == ns_launches
    out.update(
        launches=launches, expected_launches=dict(expected, fused_ns_step=[n_factors, 40 * n_factors]),
        passed=bool(interrupted_ok and continuity_ok and latest_ok and ns_ok and counts_ok),
    )
    emit(out)
    return out['passed']


# ------------------------------------------------------------ async refresh


ASYNC_EVERY = 10  # (a)'s factor and inverse cadence: the sliced refresh is then bitwise a window back
ASYNC_STEPS = 31  # swaps at steps 10, 20 and 30
ASYNC_ORACLE = ((20, 10), (30, 20))  # (swap step, step whose factors it decomposed)
PROBE_WINDOW = 8  # (b) and (c): the async spike probe's window
PROBE_STEPS = PROBE_WINDOW * 4 + 1  # a warm window and three more, to the fourth swap
PROBE_LAYERS = 4  # the probe MLP's K-FAC layers: three hidden and the head
# (c): the JAX package's tolerance of the host mode against the lagged sync
HOST_RTOL, HOST_ATOL = 5e-3, 1e-4


class ProbeRun:
    """``bench_lm.probe_trainer``'s loop in the shape ``counted_step``
    drives (``trainer``, ``state``, ``batch``)."""

    def __init__(self, device, **kfac_kw):
        from kfac_tpu_torch import bench_lm

        self.trainer, self.batch = bench_lm.probe_trainer(device, window=PROBE_WINDOW, **kfac_kw)
        self.kfac = self.trainer.kfac
        self.state = self.trainer.init()

    @property
    def kstate(self):
        return self.state.kfac_state


def slice_plan(kfac) -> list[dict]:
    """Units per slice and their n^3 load."""
    from kfac_tpu_torch.async_inverse import sliced

    cost = dict(sliced.dense_units(kfac))
    return [dict(units=len(s), n3_load=sum(cost[u] for u in s)) for s in kfac._async_slices]


def syncs_by_kind(syncs, every) -> dict:
    """Host syncs of step 0, of the window boundaries after it and of the
    other steps: each kind's count of steps, max and median."""
    kinds = {'step_0': [syncs[0]], 'boundary': [], 'other': []}
    for i, n in enumerate(syncs[1:], start=1):
        kinds['boundary' if i % every == 0 else 'other'].append(n)
    return {k: dict(steps=len(v), syncs_max=max(v), syncs_median=statistics.median(v))
            for k, v in kinds.items() if v}


def count_into(launches, wrappers) -> dict:
    """This run's counts, added into the phase's ``launches``."""
    counts = {n: w.launches for n, w in wrappers.items()}
    for n, c in counts.items():
        launches[n] = launches.get(n, 0) + c
    return counts


def async_flagship_run(mode, launches, device) -> tuple[dict, dict, dict]:
    """(a): the flagship at cadence 10/10 through ``Trainer.step``, counts
    set to 0 just before and read just after; host copies, taken off the
    clock, of the sliced run's factors after steps 10 and 20 and its
    decompositions after 20 and 30, or of the sync run's decompositions
    after 10."""
    wrappers = main_path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    run = LMRun(FLAGSHIP, device, ASYNC_EVERY, ASYNC_EVERY, async_inverse=mode)
    losses, seconds, syncs, factors_at, decomps_at = [], [], [], {}, {}
    for i in range(ASYNC_STEPS):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
        if mode == 'sliced' and i in (10, 20):
            factors_at[i] = host_copy({'a': run.kstate.a, 'g': run.kstate.g})
        if i in ((20, 30) if mode == 'sliced' else (10,)):
            decomps_at[i] = host_copy({f: getattr(run.kstate, f) for f in ('qa', 'qg', 'da', 'dg')})
    counts = count_into(launches, wrappers)
    expected = dict(expected_launches(ASYNC_STEPS, len(range(0, ASYNC_STEPS, ASYNC_EVERY))),
                    fused_ns_step=0)
    window_ms = [s * 1e3 for s in seconds[11:]]
    median = statistics.median(window_ms)
    out = dict(
        mode=mode or 'sync', losses=losses,
        finite=all(math.isfinite(x) for x in losses), loss_falls=losses[-1] < losses[0],
        step_ms=[s * 1e3 for s in seconds],
        steps_11_30=dict(ms_median=median, ms_max=max(window_ms), refresh_spike_ratio=max(window_ms) / median),
        syncs=syncs_by_kind(syncs, ASYNC_EVERY),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == 'cuda' else None,
        launches=counts, expected_launches=expected,
    )
    if mode == 'sliced':
        out['slice_plan'] = slice_plan(run.kfac)
    out['passed'] = out['finite'] and out['loss_falls'] and counts == expected
    return out, factors_at, decomps_at


def eigh_oracle(factors_at, decomps_at, device) -> dict:
    """The sliced run's active decompositions after the swaps at steps 20
    and 30 against ``compute_eigh`` on the card of its factors after steps
    10 and 20; where they differ, ``compute_eigh`` again (whether cuSOLVER
    repeats itself on one input)."""
    from kfac_tpu_torch.ops import factors

    bitwise, repeatable, worst = True, True, dict(d_rel=0.0, recon_rel=0.0)
    differing = []
    for swap, src in ASYNC_ORACLE:
        for side, qf, df in (('a', 'qa', 'da'), ('g', 'qg', 'dg')):
            for n, f_host in factors_at[src][side].items():
                f = f_host.to(device)
                one = factors.compute_eigh(f)
                q, d = decomps_at[swap][qf][n], decomps_at[swap][df][n]
                same = torch.equal(one.q.cpu(), q) and torch.equal(one.d.cpu(), d)
                bitwise &= same
                if not same:
                    differing.append(f'{swap}:{side}:{n}')
                    two = factors.compute_eigh(f)
                    repeatable &= torch.equal(one.q, two.q) and torch.equal(one.d, two.d)
                qc, dc = q.to(device), d.to(device)
                worst['d_rel'] = max(worst['d_rel'], float((dc - one.d).abs().max() / one.d.abs().max()))
                recon = qc @ torch.diag(dc) @ qc.T
                worst['recon_rel'] = max(worst['recon_rel'], float((recon - f).abs().max() / f.abs().max()))
    return dict(bitwise=bitwise, cusolver_repeatable=repeatable if differing else 'not tested',
                differing=differing[:8],
                tolerance='eigenvalues within 1e-5 of max|d|, Q diag(d) Q^T within 1e-4 of max|F|, '
                          'held only where cuSOLVER does not repeat itself', **worst)


def async_probe_ns(launches, device) -> dict:
    """(b): the probe MLP, INVERSE + Newton-Schulz, ``'sliced'``: every
    swapped inverse's independent residual against the factors it was
    computed from, ``fused_ns_step`` launches and host syncs by step."""
    from kfac_tpu_torch.ops import factors

    wrappers = main_path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    run = ProbeRun(device, async_inverse='sliced', **INVERSE_NS)
    damping = run.kfac.damping
    losses, seconds, syncs, residuals, boundary = [], [], [], {}, {}
    for i in range(PROBE_STEPS):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
        if i % PROBE_WINDOW == 0:
            boundary[i] = run.kstate
            if i:  # the swap's inverses came from the factors a window back
                prev, st = boundary[i - PROBE_WINDOW], run.kstate
                resid = []
                for n in run.kfac.registry.layers:
                    for f, x in ((prev.a[n], st.a_inv[n]), (prev.g[n], st.g_inv[n])):
                        eye = torch.eye(f.shape[0], device=f.device)
                        r = torch.linalg.norm(eye - (f + damping * eye) @ x) / math.sqrt(f.shape[0])
                        resid.append(float(r))
                residuals[i] = max(resid)
    counts = count_into(launches, wrappers)
    # one unit a slice-step, and the cold start's every factor
    refreshes = 2 * PROBE_LAYERS + sum(
        len(run.kfac._async_slices[i % PROBE_WINDOW]) for i in range(PROBE_STEPS)
        if i % PROBE_WINDOW < run.kfac._async_n_slices
    )
    # at least one iteration a refresh; at most the cap twice (a warm start
    # that restarts cold)
    ns_range = [refreshes, 2 * 40 * refreshes]
    expected = dict(expected_launches(PROBE_STEPS, len(range(0, PROBE_STEPS, PROBE_WINDOW))),
                    flash_attention_partials=0)
    expected.update(sym_cov=2 * PROBE_LAYERS * len(range(0, PROBE_STEPS, PROBE_WINDOW)))
    window_ms = [s * 1e3 for s in seconds[PROBE_WINDOW + 1:]]
    out = dict(
        config='probe MLP d512 b256, INVERSE + Newton-Schulz, sliced, window 8', steps=PROBE_STEPS,
        losses=losses, slice_plan=slice_plan(run.kfac),
        max_independent_residual_by_swap=residuals, residual_limit=factors.NS_FALLBACK_RESIDUAL,
        fused_ns_step_launches=counts['fused_ns_step'], fused_ns_step_range=ns_range,
        syncs=syncs_by_kind(syncs, PROBE_WINDOW),
        step_ms_median=statistics.median(window_ms), step_ms_max=max(window_ms),
        launches=counts, expected_launches=dict(expected, fused_ns_step=ns_range),
    )
    out['passed'] = (
        all(math.isfinite(x) for x in losses) and len(residuals) == 4
        and all(r <= factors.NS_FALLBACK_RESIDUAL for r in residuals.values())
        and ns_range[0] <= counts['fused_ns_step'] <= ns_range[1]
        and {n: counts[n] for n in expected} == expected
    )
    return out


def async_probe_host(launches, device) -> dict:
    """(c): the probe MLP, EIGEN, ``'host'``: each boundary's wait in the
    pump, the step ms while the worker runs, and the preconditioned grads
    after each swap against the synchronous engine's refresh of the factors
    a window back."""
    from kfac_tpu_torch import KFACPreconditioner

    wrappers = main_path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    run = ProbeRun(device, async_inverse='host')
    kfac = run.kfac
    engine_step, seen = kfac.step, {}

    def recording(state, grads, stats, loss=None):
        if state.step % PROBE_WINDOW == 0:
            seen[state.step] = {n: g.clone() for n, g in grads.items()}
        return engine_step(state, grads, stats, loss=loss)

    kfac.step = recording
    waits, seconds, syncs, at = [], [], [], {}
    for i in range(PROBE_STEPS):
        loss, sec, n = counted_step(run)
        seconds.append(sec)
        syncs.append(n)
        if i == 0:  # the worker exists from the first launch on
            worker, take = kfac._async_worker, kfac._async_worker.take

            def timed_take(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return take(*args, **kwargs)
                finally:
                    waits.append((time.perf_counter() - t0) * 1e3)

            worker.take = timed_take
        if i % PROBE_WINDOW == 0:
            at[i] = run.kstate
    del kfac.step
    counts = count_into(launches, wrappers)
    sync_engine = KFACPreconditioner(
        kfac.registry, damping=kfac.damping, lr=kfac.lr, factor_update_steps=PROBE_WINDOW,
        inv_update_steps=PROBE_WINDOW, device=kfac.device,
    )
    worst = []
    for b in range(PROBE_WINDOW, PROBE_STEPS, PROBE_WINDOW):
        prev = at[b - PROBE_WINDOW]
        ref = sync_engine.update_inverses(dataclasses.replace(at[b], a=prev.a, g=prev.g))
        want = sync_engine.precondition(ref, seen[b])
        got = kfac.precondition(at[b], seen[b])
        # how far past rtol * |want| + atol, at worst (<= 0 passes)
        worst.append(max(
            float(((got[n] - w).abs() - HOST_RTOL * w.abs() - HOST_ATOL).max()) for n, w in want.items()
        ))
    expected = dict(expected_launches(PROBE_STEPS, len(range(0, PROBE_STEPS, PROBE_WINDOW))),
                    flash_attention_partials=0, fused_ns_step=0)
    expected.update(sym_cov=2 * PROBE_LAYERS * len(range(0, PROBE_STEPS, PROBE_WINDOW)))
    steps_ms = [s * 1e3 for s in seconds]
    other = [ms for i, ms in enumerate(steps_ms) if i % PROBE_WINDOW]
    out = dict(
        config='probe MLP d512 b256, EIGEN, host, window 8', steps=PROBE_STEPS,
        boundary_wait_ms=waits, boundary_step_ms=steps_ms[PROBE_WINDOW::PROBE_WINDOW],
        other_step_ms_median=statistics.median(other), other_step_ms_max=max(other),
        syncs=syncs_by_kind(syncs, PROBE_WINDOW),
        grads_excess_over_tolerance_by_swap=worst, rtol=HOST_RTOL, atol=HOST_ATOL,
        launches=counts, expected_launches=expected,
    )
    out['passed'] = (
        len(worst) == 4 and all(x <= 0 for x in worst) and len(waits) == 4 and counts == expected
    )
    return out


def run_async_refresh(launches, device=torch.device('cuda'), summary=None) -> bool:
    """The async refresh (see the module's docstring, phase 10);
    ``summary`` takes (a)'s step ms over steps 11-30 of each mode."""
    out: dict = dict(phase='async_refresh', config=FLAGSHIP, cadence=[ASYNC_EVERY, ASYNC_EVERY])
    runs = {}
    sync, _, sync_decomps = async_flagship_run(None, launches, device)
    sliced, factors_at, decomps_at = async_flagship_run('sliced', launches, device)
    oracle = eigh_oracle(factors_at, decomps_at, device)
    # steps 0-9 run alike in both, so the sync refresh at step 10 is the
    # sliced swap at step 20 as well
    oracle['sync_step_10_is_sliced_step_20'] = all(
        torch.equal(sync_decomps[10][f][n], decomps_at[20][f][n])
        for f in decomps_at[20] for n in decomps_at[20][f]
    )
    del factors_at, decomps_at, sync_decomps
    runs['sync'], runs['sliced'] = sync, sliced
    oracle['passed'] = oracle['bitwise'] or (
        not oracle['cusolver_repeatable'] and oracle['d_rel'] <= 1e-5 and oracle['recon_rel'] <= 1e-4
    )
    out.update(flagship=runs, oracle=oracle)
    if summary is not None:
        summary.update(sync=sync['steps_11_30'], sliced=sliced['steps_11_30'])
    out['sliced_ns'] = async_probe_ns(launches, device)
    out['host'] = async_probe_host(launches, device)
    out['passed'] = bool(
        sync['passed'] and sliced['passed'] and oracle['passed'] and out['sliced_ns']['passed']
        and out['host']['passed']
    )
    emit(out)
    return out['passed']


# ------------------------------------------------------------------- kaisa

KAISA_EVERY = 10  # factor and inverse cadence of the kaisa phase
KAISA_STEPS = 21  # EIGEN: captures and refreshes at steps 0, 10 and 20
KAISA_NS_STEPS = 11  # INVERSE + Newton-Schulz: a cold refresh at 0, a warm one at 10
KAISA_METHODS = ('allreduce', 'allreduce_bucketed')


def kaisa_wrappers() -> dict:
    from kfac_tpu_torch.ops import newton_schulz

    return dict(main_path_wrappers(), fused_ns_step_stacked=newton_schulz.fused_ns_step_stacked)


def kaisa_jobs(world: int) -> list[dict]:
    """The kaisa phase's runs on ``world`` ranks: EIGEN at every fraction
    the world allows with each stat transport, then INVERSE +
    Newton-Schulz at every fraction (bucketed)."""
    from kfac_tpu_torch import assignment

    jobs = [
        dict(frac=f, allreduce_method=m, kfac={}, steps=KAISA_STEPS)
        for f in assignment.candidate_fractions(world) for m in KAISA_METHODS
    ]
    jobs += [
        dict(frac=f, allreduce_method='allreduce_bucketed', kfac=INVERSE_NS, steps=KAISA_NS_STEPS)
        for f in assignment.candidate_fractions(world)
    ]
    return jobs


def kaisa_expected(steps: int) -> dict:
    """Launches on one rank over ``steps`` steps at cadence 10/10: two
    ``sym_cov`` a layer a capture (on the rank's rows), the grouped
    kl-clip dot and scale once a step, the flash partials once a block a
    step; no 2-D Newton-Schulz step."""
    return dict(expected_launches(steps, len(range(0, steps, KAISA_EVERY))), fused_ns_step=0)


def param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def kaisa_rank(rank: int, world: int, device: torch.device, jobs: list[dict]) -> list[dict]:
    """One NCCL rank of the kaisa phase: each job's flagship run through
    ``Trainer.step`` with a ``DistributedKFAC`` on the global batch (the
    rank takes its row block), the kernels' counts set to 0 just before
    and read just after."""
    import kfac_tpu_torch as kt
    from kfac_tpu_torch.models import TransformerLM, lm_loss
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
    from kfac_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FLAGSHIP
    wrappers = kaisa_wrappers()
    out = []
    for job in jobs:
        model = TransformerLM(
            vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
            num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device,
        )
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
        reg = kt.register_model(model, skip_layers=['lm_head'], device=device)
        config = kt.KFACPreconditioner(
            reg, damping=0.003, lr=0.1, factor_update_steps=KAISA_EVERY,
            inv_update_steps=KAISA_EVERY, device=device,
            allreduce_method=job['allreduce_method'], **job['kfac'],
        )
        engine = DistributedKFAC(config, kaisa_mesh(job['frac'], device=device))
        loss = lm_loss(model)
        trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            lambda ms, b: (loss(b), ms), kfac=engine, device=device,
        )
        state = trainer.init()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        for w in wrappers.values():
            w.launches = 0
        losses, seconds, residuals = [], [], []
        for i in range(job['steps']):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, value = trainer.step(state, batch)
            losses.append(float(value))
            torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            if job['kfac'] and i % KAISA_EVERY == 0:
                res = engine.inverse_residuals(state.kfac_state)
                residuals.append(max(float(r.max()) for side in res.values() for r in side.values()))
        launches = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(device)
        grads = {
            n: p.grad.detach().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None
        } if rank == 0 else None
        # the refresh alone, after the counted run (every rank: it gathers)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        engine.update_inverses(state.kfac_state)
        torch.cuda.synchronize(device)
        refresh_ms = (time.perf_counter() - t0) * 1e3
        # a stacked solve launches where the rank's block holds a live slot
        live_solves = sum(
            engine._factor_range(sb.padded)[0] < len(sb.layers)
            for sb in engine.a_store + engine.g_store
        )
        memory = engine.memory_usage(state.kfac_state)
        comms = engine.comms_report()
        transport = comms['stat_transport']
        out.append(dict(
            rank=rank, frac=job['frac'], strategy=engine.strategy.name,
            allreduce_method=job['allreduce_method'], kfac=job['kfac'] or 'default (EIGEN)',
            grid=[engine.grad_workers, engine.mesh.n_cols],
            losses=losses, step_ms=[s * 1e3 for s in seconds],
            plain_step_ms_median=statistics.median(
                s * 1e3 for i, s in enumerate(seconds) if i % KAISA_EVERY),
            capture_refresh_step_ms=[s * 1e3 for i, s in enumerate(seconds)
                                     if i and i % KAISA_EVERY == 0],
            refresh_alone_ms=refresh_ms,
            launches=launches, live_stacked_solves=live_solves,
            max_independent_residual_by_refresh=residuals,
            peak_memory_bytes=peak,
            memory_usage={k: v for k, v in memory.items() if k != 'padding_waste'},
            decomposition_bytes=memory['a_inverses'] + memory['g_inverses'],
            comms=dict(
                stat_transport=dict(
                    method=transport['method'], collectives=transport['collectives'],
                    bytes=transport['bytes'], dense_bytes=transport['dense_bytes'],
                    chunk_bytes=[c['bytes'] for c in transport['chunks']],
                ),
                decomp_reshard_bytes=comms['decomp_reshard_bytes'],
                grad_broadcast_bytes=comms['grad_broadcast_bytes'],
            ),
            stores=[(sb.key, len(sb.layers), sb.padded) for sb in engine.a_store + engine.g_store],
            param_digest=param_digest(model), grads=grads,
        ))
        del trainer, engine, model, state
        torch.cuda.empty_cache()
    return out


def kaisa_dense_reference(kfac_kw: dict, steps: int) -> tuple[list, dict]:
    """(losses, last step's preconditioned grads on the host) of the dense
    engine on the same card, global batch and weights, cadence 10/10."""
    run = LMRun(FLAGSHIP, torch.device('cuda'), KAISA_EVERY, KAISA_EVERY, **kfac_kw)
    losses, _, _ = train(run, steps)
    return losses, {n: g.cpu() for n, g in run.grads().items()}


def run_kaisa(launches) -> bool:
    """The KAISA engine over NCCL (see the module's docstring, phase 11)."""
    from kfac_tpu_torch.ops import factors
    from kfac_tpu_torch.parallel import spawn_world

    world = torch.cuda.device_count()
    jobs = kaisa_jobs(world)
    dense = {
        'eigen': kaisa_dense_reference({}, KAISA_STEPS),
        'ns': kaisa_dense_reference(INVERSE_NS, KAISA_NS_STEPS),
    }
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = spawn_world(kaisa_rank, world, 'nccl', 'cuda', args=(jobs,), timeout_s=600)
    seconds = time.perf_counter() - t0
    ok = True
    for j, job in enumerate(jobs):
        rows = [r[j] for r in results]
        r0 = rows[0]
        want_losses, want_grads = dense['ns' if job['kfac'] else 'eigen']
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0['losses'], want_losses))
        scale = max(float(g.abs().max()) for g in want_grads.values())
        grad_err = max(float((r0['grads'][n] - g).abs().max()) for n, g in want_grads.items()) / scale
        expected = kaisa_expected(job['steps'])
        refreshes = len(range(0, job['steps'], KAISA_EVERY))
        per_refresh = [r['live_stacked_solves'] for r in rows]
        ns_range = [
            [refreshes * n, refreshes * n * 2 * 40] if job['kfac'] else [0, 0] for n in per_refresh
        ]
        launches_exact = all(
            {n: r['launches'][n] for n in expected} == expected for r in rows
        )
        ns_inside = all(
            lo <= r['launches']['fused_ns_step_stacked'] <= hi for r, (lo, hi) in zip(rows, ns_range)
        )
        finite = all(math.isfinite(x) for x in r0['losses'])
        falling = r0['losses'][-1] < r0['losses'][0]
        same_params = len({r['param_digest'] for r in rows}) == 1
        residual_ok = all(
            x <= factors.NS_FALLBACK_RESIDUAL
            for r in rows for x in r['max_independent_residual_by_refresh']
        )
        passed = (
            finite and falling and loss_err <= 1e-4 and grad_err <= 1e-3 and same_params
            and launches_exact and ns_inside and residual_ok
        )
        for name, count in r0['launches'].items():
            launches[name] = launches.get(name, 0) + count
        emit(dict(
            phase='kaisa', world=world, backend='nccl', frac=job['frac'],
            strategy=r0['strategy'], grid=r0['grid'], allreduce_method=job['allreduce_method'],
            kfac=r0['kfac'], steps=job['steps'], cadence=[KAISA_EVERY, KAISA_EVERY],
            losses=r0['losses'], dense_losses=want_losses, loss_rel_err=loss_err, loss_tol=1e-4,
            pgrad_err_rel_to_max=grad_err, pgrad_tol=1e-3, finite=finite, loss_falls=falling,
            params_identical_on_every_rank=same_params,
            step_ms_by_rank=[dict(
                rank=r['rank'], plain_median=r['plain_step_ms_median'],
                capture_and_refresh=r['capture_refresh_step_ms'],
                refresh_alone=r['refresh_alone_ms'],
            ) for r in rows],
            peak_memory_by_rank=[r['peak_memory_bytes'] for r in rows],
            decomposition_bytes_by_rank=[r['decomposition_bytes'] for r in rows],
            memory_usage_rank0=r0['memory_usage'], comms=r0['comms'], stores=r0['stores'],
            launches_by_rank=[r['launches'] for r in rows],
            expected_launches=dict(expected, fused_ns_step_stacked=ns_range),
            max_independent_residual_by_refresh=[
                r['max_independent_residual_by_refresh'] for r in rows],
            residual_limit=factors.NS_FALLBACK_RESIDUAL, passed=passed,
        ))
        ok &= passed
    emit(dict(phase='kaisa_world', world=world, jobs=len(jobs), spawn_seconds=seconds, passed=ok))
    return ok


# --------------------------------------------------------------- kaisa_ops

KAISA_OPS_EXTRA = 2  # uncounted steps after the counted ones, as observed's profiled pair
KAISA_OPS_TAIL = 5  # steps after the restore, and of the in-memory oracle
KAISA_MIGRATIONS = ('to_dense', 'from_dense', 'granularity')


class DistLMRun:
    """``LMRun``'s loop with a ``DistributedKFAC`` at the gradient-worker
    fraction ``frac`` (COMM-OPT by default) on this rank's row block of
    the global batch."""

    def __init__(self, device, capture_every, inv_every, frac=1.0, checkpoints=None,
                 granularity=None, dtype=torch.float32, **kfac_kw):
        import kfac_tpu_torch as kt
        from kfac_tpu_torch.models import TransformerLM, lm_loss
        from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
        from kfac_tpu_torch.training import Trainer

        cfg = FLAGSHIP
        self.device, self.capture_every = device, capture_every
        model = TransformerLM(
            vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
            num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device, dtype=dtype,
        )
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        self.batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
        self.registry = kt.register_model(
            model, skip_layers=['lm_head'], device=device,
            factor_dtype=kfac_kw.get('factor_dtype', torch.float32),
        )
        self.config = kt.KFACPreconditioner(
            self.registry, damping=0.003, lr=0.1, factor_update_steps=capture_every,
            inv_update_steps=inv_every, device=device, bucket_granularity=granularity, **kfac_kw,
        )
        self.kfac = DistributedKFAC(self.config, kaisa_mesh(frac, device=device))
        loss = lm_loss(model)
        self.loss = loss

        def loss_fn(ms, batch):
            if len(batch) == 3:  # LMRun's weight a row (fault_checks)
                return loss(batch[:2]) * batch[2][0], ms
            return loss(batch), ms

        self.trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            loss_fn, kfac=self.kfac, checkpoints=checkpoints, device=device,
        )
        self.state = self.trainer.init()

    @property
    def kstate(self):
        return self.state.kfac_state

    def mean_grads(self) -> dict:
        """The global mean grads of the current weights on the batch."""
        from kfac_tpu_torch.layers import capture

        run = capture.value_and_grad(self.trainer.model, lambda b: self.loss(b))
        _, grads = run(self.kfac.mesh.local_rows(self.batch))
        return self.kfac.average_grads(grads, torch.zeros((), device=self.device))[0]


def kaisa_observed(rank, device, wrappers) -> dict:
    """(a): the sentinel, metrics and flight on, in turns with the same
    loop without them, counts over the observed run's steps; the drains;
    then the three faults."""
    from kfac_tpu_torch import tracing
    from kfac_tpu_torch.health import HealthConfig
    from kfac_tpu_torch.observability import flight_recorder, metrics

    plain = DistLMRun(device, 10, 100)
    run = DistLMRun(device, 10, 100, health=HealthConfig(**OBSERVED_HEALTH), metrics=True, flight=True)
    for w in wrappers.values():
        w.launches = 0
    counted, launches = {}, {}
    losses, seconds, syncs, plain_seconds, plain_syncs = [], [], [], [], []
    for _ in range(STEPS):
        _, sec, n = counted_step(plain)
        plain_seconds.append(sec)
        plain_syncs.append(n)
        for w in wrappers.values():
            counted[w] = w.launches
        loss, sec, n = counted_step(run)
        for name, w in wrappers.items():
            launches[name] = launches.get(name, 0) + w.launches - counted[w]
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
    record = metrics.MetricsCollector().drain(run.state)
    ring = flight_recorder.drain_flight(run.state)  # every rank: the skew columns gather
    for _ in range(KAISA_OPS_EXTRA):
        run.state, _ = run.trainer.step(run.state, run.batch)
    faults = fault_checks(run, 'block2/mlp_up')
    return dict(
        losses=losses, launches=launches,
        with_obs=step_kinds(seconds, syncs, 10, 100),
        without=step_kinds(plain_seconds, plain_syncs, 10, 100),
        drain=dict(
            keys=len(record), step=record.get('step'),
            finite=all(math.isfinite(v) for v in record.values() if isinstance(v, float)),
            flight_records=len(ring), skew_columns=sum(k.startswith('skew_') for k in ring[-1]) if ring else 0,
        ),
        faults=faults, health=tracing.health_counters(run.kstate),
        health_tensors=[host_copy(getattr(run.kstate.health, f)) for f in (
            'skipped_steps', 'damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')],
    )


def kaisa_resume(rank, world, device, root, wrappers) -> dict:
    """(b): a Trainer with a CheckpointManager, a real SIGTERM to rank 0
    after step ``RESUME_SIGNAL_AFTER``; the restore at the same world
    beside the interrupted run continued in memory; then save and restore
    times and the bytes of this rank's files."""
    from kfac_tpu_torch import checkpoint
    from kfac_tpu_torch.resilience import CheckpointManager, Preempted

    mgr = CheckpointManager(root, save_interval_steps=RESUME_INTERVAL, keep=2, async_save=True)
    run = DistLMRun(device, 10, 100, checkpoints=mgr)
    on_step, seen = mgr.on_step, {}

    def recording(state, step=None):
        seen['state'] = state  # the state a Preempted leaves behind
        return on_step(state, step=step)

    mgr.on_step = recording
    steps, preempted = [], None
    for i in range(STEPS):
        if i == RESUME_SIGNAL_AFTER + 1 and rank == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                run.state, _ = run.trainer.step(run.state, run.batch)
            except Preempted as exc:
                preempted = exc
            finally:
                torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        steps.append(dict(step=i, ms=(time.perf_counter() - t0) * 1e3,
                          syncs=sum('synchroniz' in str(w.message) for w in caught),
                          saved=os.path.isdir(mgr.step_dir(i + 1))))
        if preempted is not None:
            break
    out = dict(
        preempted=None if preempted is None else dict(
            signal=preempted.signal_name, step=preempted.step, path=preempted.path),
        steps=steps, rotation=mgr.rotation_steps(), latest=mgr.latest_step(),
    )
    mgr.close()
    quiet = [s for s in steps if s['step'] % 10 and not s['saved'] and s is not steps[-1]]
    out['syncs_max_quiet_steps'] = max(s['syncs'] for s in quiet)

    # the restore at the same world, and the oracle
    mgr2 = CheckpointManager(root, install_signals=())
    resumed = DistLMRun(device, 10, 100, checkpoints=mgr2)
    resumed.state, restore_s = synced(resumed.trainer.restore_latest)
    out['restore_ms'] = restore_s * 1e3
    resumed.trainer.checkpoints = None
    run.trainer.checkpoints = None
    run.state = dataclasses.replace(
        seen['state'], kfac_state=run.kfac.rematerialize(seen['state'].kfac_state))
    r_losses, o_losses = [], []
    for _ in range(KAISA_OPS_TAIL):
        resumed.state, loss = resumed.trainer.step(resumed.state, resumed.batch)
        r_losses.append(float(loss))
        run.state, loss = run.trainer.step(run.state, run.batch)
        o_losses.append(float(loss))
    out['continuity'] = dict(
        restored_step=resumed.kstate.step - KAISA_OPS_TAIL, losses=r_losses, oracle_losses=o_losses,
        losses_bitwise=r_losses == o_losses,
        params_bitwise=all(torch.equal(p, q) for p, q in zip(
            resumed.trainer.model.parameters(), run.trainer.model.parameters())),
        factors_bitwise=all(torch.equal(resumed.kstate.a[k], v) for k, v in run.kstate.a.items())
        and all(torch.equal(resumed.kstate.g[k], v) for k, v in run.kstate.g.items()),
        param_digest=param_digest(resumed.trainer.model),
    )

    # save and restore times, bytes on disk
    extra = resumed.trainer.checkpoint_extras(resumed.state)
    block = os.path.join(root, 'blocking')
    _, blocking_s = synced(lambda: checkpoint.save(block, resumed.kstate, extra=extra, engine=resumed.kfac))
    handle, return_s = synced(lambda: checkpoint.save(
        os.path.join(root, 'async'), resumed.kstate, extra=extra, engine=resumed.kfac, wait=False))
    _, wait_s = synced(handle.wait_until_finished)
    fresh = DistLMRun(device, 10, 100)
    (state, _), read_s = synced(lambda: checkpoint.restore(block, fresh.kfac))
    shard = os.path.join(block, checkpoint.shard_name(rank, world))
    out['save'] = dict(
        blocking_save_ms=blocking_s * 1e3, async_return_ms=return_s * 1e3, async_wait_ms=wait_s * 1e3,
        restore_ms=read_s * 1e3, shard_bytes=os.path.getsize(shard),
        extra_bytes=os.path.getsize(os.path.join(block, checkpoint.EXTRA)) if rank == 0 else 0,
    )
    out['source'] = resumed
    out['block'] = block
    return out


def pgrad_err(got: dict, want: dict) -> float:
    """The largest preconditioned-grad difference relative to the largest
    |grad| of ``want``."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[n] - g).abs().max()) for n, g in want.items()) / scale


def kaisa_migrations(rank, world, device, root, source, block) -> dict:
    """(c) on this world: the (b) checkpoint into the dense engine, a dense
    checkpoint into the distributed engine, and into bucket granularity
    128; each restore's preconditioned grads against the source engine's
    on the same weights and batch."""
    from kfac_tpu_torch import checkpoint
    from kfac_tpu_torch.layers import capture

    grads = source.mean_grads()
    want = source.kfac.precondition(source.kstate, grads)
    model = source.trainer.model
    out = {}

    def dense_engine():
        import kfac_tpu_torch as kt

        return kt.KFACPreconditioner(source.registry, damping=0.003, lr=0.1, factor_update_steps=10,
                                     inv_update_steps=100, device=device)

    def checked(name, engine, path, global_grads):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            (state, _), sec = synced(lambda: checkpoint.restore(path, engine))
        got = engine.precondition(state, global_grads)
        err = pgrad_err(got, want)
        out[name] = dict(
            migrated=any('migrating through per-layer factors' in str(w.message) for w in caught),
            step=state.step, restore_ms=sec * 1e3, pgrad_err_rel_to_max=err, pgrad_tol=1e-3,
            passed=err <= 1e-3 and state.step == source.kstate.step,
        )
        out[name]['passed'] &= out[name]['migrated']
        return state

    dense = dense_engine()
    _, global_grads = capture.value_and_grad(model, lambda b: source.loss(b))(source.batch)
    dstate = checked('to_dense', dense, block, global_grads)
    dpath = os.path.join(root, 'dense')
    checkpoint.save(dpath, dstate, engine=dense)
    checked('from_dense', source.kfac, dpath, grads)
    g128 = DistLMRun(device, 10, 100, granularity=128)
    checked('granularity', g128.kfac, block, grads)
    return out


def kaisa_ops_rank(rank: int, world: int, device: torch.device, root: str) -> dict:
    """One NCCL rank of the kaisa_ops phase: (a), (b), (c)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = main_path_wrappers()
    t0 = time.perf_counter()
    observed = kaisa_observed(rank, device, wrappers)
    t1 = time.perf_counter()
    resume = kaisa_resume(rank, world, device, os.path.join(root, 'rot'), wrappers)
    t2 = time.perf_counter()
    migrations = kaisa_migrations(rank, world, device, root, resume.pop('source'), resume['block'])
    t3 = time.perf_counter()
    return dict(rank=rank, observed=observed, resume=resume, migrations=migrations,
                seconds=dict(observed=t1 - t0, resume=t2 - t1, migrations=t3 - t2))


def elastic_rank(rank: int, world: int, device: torch.device, path: str, out_path: str) -> dict:
    """A restore of ``path`` onto this world (W = 4 -> 2 -> 4 on four
    cards): its migration warning, the preconditioned grads of the
    restored state beside those of the state it saves to ``out_path``."""
    from kfac_tpu_torch import checkpoint

    run = DistLMRun(device, 10, 100)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        state, extra = checkpoint.restore(path, run.kfac, extra_template={'model': None})
    run.trainer.model.load_state_dict(extra['model'])
    pg = run.kfac.precondition(state, run.mean_grads())
    if out_path:
        checkpoint.save(out_path, state, extra=extra, engine=run.kfac)
    return dict(
        step=state.step, migrated=any('migrating' in str(w.message) for w in caught),
        grads={n: g.cpu() for n, g in pg.items()} if rank == 0 else None,
    )


def run_kaisa_ops(launches, dense_health) -> bool:
    """The sentinel, metrics, flight and checkpoints of the KAISA engine over
    NCCL (see the module's docstring, phase 12); ``dense_health`` is the
    observed phase's counters after its faults."""
    from kfac_tpu_torch.parallel import spawn_world

    world = torch.cuda.device_count()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_kaisa_ops')
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        results = spawn_world(kaisa_ops_rank, world, 'nccl', 'cuda', args=(root,), timeout_s=600)
        seconds = time.perf_counter() - t0
        elastic = None
        if world == 4:
            block = os.path.join(root, 'rot', 'blocking')
            half = os.path.join(root, 'elastic2')
            t1 = time.perf_counter()
            two = spawn_world(elastic_rank, 2, 'nccl', 'cuda', args=(block, half), timeout_s=300)
            four = spawn_world(elastic_rank, 4, 'nccl', 'cuda', args=(half, ''), timeout_s=300)
            elastic = dict(
                seconds=time.perf_counter() - t1,
                steps=[two[0]['step'], four[0]['step']],
                migrated=[two[0]['migrated'], four[0]['migrated']],
                pgrad_err_rel_to_max=pgrad_err(four[0]['grads'], two[0]['grads']),
                pgrad_tol=1e-3,
            )
            elastic['passed'] = elastic['pgrad_err_rel_to_max'] <= 1e-3 and elastic['steps'] == [RESUME_STEP + KAISA_OPS_TAIL] * 2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = results[0]
    obs = [r['observed'] for r in results]
    expected = kaisa_expected(STEPS)
    expected['klclip_dot_norms'], expected['klclip_dot'] = expected['klclip_dot'], 0
    launches_exact = all({n: o['launches'][n] for n in expected} == expected for o in obs)
    for name, count in r0['observed']['launches'].items():
        launches[name] = launches.get(name, 0) + count
    zero_syncs = all(
        o['with_obs']['capture']['syncs_max'] == 0 and o['with_obs']['plain']['syncs_max'] == 0
        for o in obs
    )
    counters_equal_on_ranks = all(
        all(torch.equal(a, b) for a, b in zip(o['health_tensors'], obs[0]['health_tensors']))
        for o in obs
    )
    faults_ok = all(f['passed'] for o in obs for f in o['faults'].values())
    drained = all(o['drain']['step'] == STEPS and o['drain']['finite']
                  and o['drain']['flight_records'] == STEPS for o in obs)
    observed = dict(
        losses_rank0=obs[0]['losses'],
        step_kinds_with_by_rank=[o['with_obs'] for o in obs],
        step_kinds_without_by_rank=[o['without'] for o in obs],
        plain_median_ms_by_rank=[
            dict(rank=r['rank'], with_obs=r['observed']['with_obs']['plain']['ms_median'],
                 without=r['observed']['without']['plain']['ms_median']) for r in results],
        launches_by_rank=[o['launches'] for o in obs], expected_launches=expected,
        zero_syncs=zero_syncs, drain=obs[0]['drain'], faults_rank0=obs[0]['faults'],
        counters_bitwise_on_every_rank=counters_equal_on_ranks,
        counters_equal_dense=obs[0]['health'] == dense_health, faults_passed=faults_ok,
    )
    observed['passed'] = (launches_exact and zero_syncs and counters_equal_on_ranks
                          and observed['counters_equal_dense'] and faults_ok and drained)
    res = [r['resume'] for r in results]
    cont = [r['continuity'] for r in res]
    resume = dict(
        preempted_by_rank=[r['preempted'] for r in res],
        rotation_rank0=res[0]['rotation'], latest_rank0=res[0]['latest'],
        step_ms_rank0=[s['ms'] for s in res[0]['steps']],
        syncs_max_quiet_steps_by_rank=[r['syncs_max_quiet_steps'] for r in res],
        continuity_rank0={k: v for k, v in cont[0].items() if k != 'param_digest'},
        params_identical_on_every_rank=len({c['param_digest'] for c in cont}) == 1,
        save_by_rank=[dict(rank=i, restore_latest_ms=r['restore_ms'], **r['save'])
                      for i, r in enumerate(res)],
    )
    resume['passed'] = (
        all(r['preempted'] is not None and r['preempted']['signal'] == 'SIGTERM'
            and r['preempted']['step'] == RESUME_STEP for r in res)
        and res[0]['latest'] == RESUME_STEP and res[0]['rotation'] == [RESUME_STEP, RESUME_INTERVAL]
        and all(c['losses_bitwise'] and c['params_bitwise'] and c['factors_bitwise']
                and c['restored_step'] == RESUME_STEP for c in cont)
        and resume['params_identical_on_every_rank']
        and all(x == 0 for x in resume['syncs_max_quiet_steps_by_rank'])
    )
    migrations = dict(by_rank0=r0['migrations'], elastic_4_2_4=elastic)
    migrations['passed'] = all(m['passed'] for r in results for m in r['migrations'].values()) and (
        elastic is None or elastic['passed'])
    passed = observed['passed'] and resume['passed'] and migrations['passed']
    emit(dict(
        phase='kaisa_ops', world=world, backend='nccl', config=FLAGSHIP, cadence=[10, 100],
        health=OBSERVED_HEALTH, metrics=True, flight=True, spawn_seconds=seconds,
        seconds_by_part_rank0=r0['seconds'], observed=observed, resume=resume,
        migrations=migrations, passed=passed,
    ))
    return passed


# ------------------------------------------------------------------ resnet

RESNET_EVERY = (10, 100)  # the bench's factor and inverse cadence
RESNET_STEPS = 21  # EIGEN: captures at 0, 10 and 20; the refresh at 0
RESNET_NS_STEPS = 11  # INVERSE + Newton-Schulz: captures at 0 and 10, a cold refresh at 0
RESNET_KAISA_STEPS = 11
RESNET_CPU_STEPS = 2  # card against the CPU: step 0 (capture and refresh), step 1 (plain)
# Held against another run (the CPU's, or the dense engine's for KAISA):
# the losses of the first steps, and the preconditioned grads after step 0,
# which both runs take from the same weights. Later steps amplify f32
# rounding: on the CPU at batch 32, weights moved by 1e-8 (relative) moved
# the step-0 grads by 1.2e-3 of their max and the step-1 grads by 1.3e-2,
# the loss by 5e-6 at step 2 and 7e-4 at step 10 (batch 64), so later steps
# are reported beside a control that measures this on the card: the dense
# engine from weights moved by 1e-7
RESNET_COMPARED_LOSSES = 3


def flax_resnet_variables(seed: int) -> tuple[dict, dict]:
    """``(params, batch_stats)`` of ResNet-32 in the JAX package's layout
    and names (conv kernels (kh, kw, C_in, C_out), the head's (d_in,
    d_out), BatchNorm ``scale`` and ``bias``; running ``mean`` and ``var``),
    numpy from ``seed``: kernels lecun-normal clipped at 2 std, scales near
    1, biases and running statistics away from flax's zeros and ones. The
    port's module tree gives the shapes."""
    import numpy as np

    from kfac_tpu_torch.models import resnet

    rng = np.random.default_rng(seed)
    model = resnet.resnet32(num_classes=RESNET32['classes'], device='cpu')
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value.astype(np.float32)

    for name, p in model.named_parameters():
        *mod, leaf = name.split('.')
        shape = tuple(p.shape)
        if len(shape) in (2, 4):
            std = 1.0 / math.sqrt(p[0].numel())
            w = np.clip(rng.standard_normal(shape), -2, 2) * std
            put(params, (*mod, 'kernel'), w.T if len(shape) == 2 else w.transpose(2, 3, 1, 0))
        elif mod[-1] == 'head':
            put(params, (*mod, leaf), np.zeros(shape))
        elif leaf == 'weight':  # a BatchNorm
            put(params, (*mod, 'scale'), 1.0 + 0.1 * rng.standard_normal(shape))
            put(stats, (*mod, 'mean'), 0.1 * rng.standard_normal(shape))
            put(stats, (*mod, 'var'), 1.0 + 0.1 * np.abs(rng.standard_normal(shape)))
        else:
            put(params, (*mod, leaf), 0.1 * rng.standard_normal(shape))
    return params, stats


def resnet_batch(device: torch.device):
    """The bench's batch (``bench_resnet.resnet_batch``): 256 NCHW images
    from seed 0, labels from seed 1."""
    from kfac_tpu_torch import bench_resnet

    return bench_resnet.resnet_batch(bench_resnet.RESNET_CONFIGS['resnet32_cifar'], device)


def resnet_model(variables, device):
    """ResNet-32 with ``variables``' weights (``convert.from_flax_params``)
    and its running statistics as the model state
    (``convert.from_flax_batch_stats``)."""
    from kfac_tpu_torch import convert
    from kfac_tpu_torch.models import resnet

    params, stats = variables
    model = resnet.resnet32(num_classes=RESNET32['classes'], device=device)
    model.load_state_dict(convert.from_flax_params(params))
    return model, convert.from_flax_batch_stats(stats, device)


class ResNetRun(LMRun):
    """ResNet-32 at the bench's width through ``Trainer.step`` with the
    BatchNorm statistics in ``model_state``: the bench's engine (damping
    0.003, lr 0.1, cadence ``RESNET_EVERY``; EIGEN unless ``kfac_kw`` says
    otherwise) and SGD(0.1, momentum 0.9)."""

    def __init__(self, variables, device, **kfac_kw):
        import kfac_tpu_torch as kt
        from kfac_tpu_torch.models import resnet
        from kfac_tpu_torch.training import Trainer

        self.device = device
        self.capture_every = RESNET_EVERY[0]
        model, model_state = resnet_model(variables, device)
        self.batch = resnet_batch(device)
        self.registry = kt.register_model(model, device=device)
        self.kfac = kt.KFACPreconditioner(
            self.registry, damping=0.003, lr=0.1, factor_update_steps=RESNET_EVERY[0],
            inv_update_steps=RESNET_EVERY[1], device=device, **kfac_kw,
        )
        self.trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            resnet.classification_loss(model), kfac=self.kfac, device=device,
        )
        self.state = self.trainer.init(model_state)


def resnet_expected(steps: int) -> dict:
    """Launches over ``steps`` steps at ``RESNET_EVERY``: two ``sym_cov`` a
    layer a capture (every conv's and the head's A and G), the grouped
    kl-clip dot and scale once a step; no attention, no blend."""
    return {
        'sym_cov': 2 * RESNET_LAYERS * len(range(0, steps, RESNET_EVERY[0])),
        'sym_cov_ema': 0,
        'klclip_dot': steps,
        'klclip_dot_norms': 0,
        'klclip_scale': steps,
        'flash_attention_partials': 0,
    }


def resnet_steps(run, steps, grads_at=()) -> dict:
    """``steps`` steps of ``run``: losses, step seconds, ``sym_cov``
    launches of each step, and the preconditioned grads (host copies)
    after the steps in ``grads_at``."""
    from kfac_tpu_torch.ops import sym_cov

    losses, seconds, covs, grads = [], [], [], {}
    for i in range(steps):
        c0 = sym_cov.sym_cov.launches
        loss, sec = run.step()
        losses.append(loss)
        seconds.append(sec)
        covs.append(sym_cov.sym_cov.launches - c0)
        if i in grads_at:
            grads[i] = {n: g.cpu() for n, g in run.grads().items()}
    return dict(losses=losses, seconds=seconds, sym_cov_by_step=covs, grads=grads)


def resnet_step_kinds(seconds) -> dict:
    every = RESNET_EVERY[0]
    return dict(
        step_0_ms=seconds[0] * 1e3,
        capture_step_ms=[s * 1e3 for i, s in enumerate(seconds) if i and i % every == 0],
        plain_step_ms_median=statistics.median(
            s * 1e3 for i, s in enumerate(seconds) if i % every and i > 1),
    )


def grads_err(got: dict, want: dict) -> float:
    """Max |got - want| over every grad, relative to the largest |want|."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[n] - g).abs().max()) for n, g in want.items()) / scale


def resnet_kaisa_rank(rank: int, world: int, device: torch.device, frac: float, variables) -> dict:
    """One NCCL rank of the resnet phase's KAISA run: ResNet-32 through
    ``Trainer.step`` with a ``DistributedKFAC`` (EIGEN, ``RESNET_EVERY``) on
    the global batch, each rank its row block and BatchNorm over the global
    batch; the counts set to 0 just before and read just after."""
    import kfac_tpu_torch as kt
    from kfac_tpu_torch.models import resnet
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
    from kfac_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    wrappers = kaisa_wrappers()
    model, model_state = resnet_model(variables, device)
    reg = kt.register_model(model, device=device)
    config = kt.KFACPreconditioner(
        reg, damping=0.003, lr=0.1, factor_update_steps=RESNET_EVERY[0],
        inv_update_steps=RESNET_EVERY[1], device=device,
    )
    engine = DistributedKFAC(config, kaisa_mesh(frac, device=device))
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        resnet.classification_loss(model), kfac=engine, device=device,
    )
    state = trainer.init(model_state)
    batch = resnet_batch(device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for w in wrappers.values():
        w.launches = 0
    losses, seconds, grads = [], [], {}
    for i in range(RESNET_KAISA_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, value = trainer.step(state, batch)
        losses.append(float(value))
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if rank == 0 and i in (0, 1):
            grads[i] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    import hashlib

    stats_digest = hashlib.sha256(b''.join(
        v.cpu().numpy().tobytes() for k in sorted(state.model_state) for _, v in sorted(state.model_state[k].items())
    )).hexdigest()
    memory = engine.memory_usage(state.kfac_state)
    return dict(
        rank=rank, frac=frac, strategy=engine.strategy.name,
        grid=[engine.grad_workers, engine.mesh.n_cols], losses=losses,
        step_ms=[s * 1e3 for s in seconds], **resnet_step_kinds(seconds),
        launches={n: w.launches for n, w in wrappers.items()},
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        decomposition_bytes=memory['a_inverses'] + memory['g_inverses'],
        param_digest=param_digest(model), model_state_digest=stats_digest,
        grads=grads,
    )


def nonfinite_eigh_on_card() -> dict:
    """``compute_eigh`` on the card of a 64 x 64 factor with one NaN pair,
    all NaN, or one inf: NaN counts (all 64 and 4096 expected: the
    decomposition of a non-finite factor is all NaN), or the error
    (cuSOLVER raises on such a matrix unless ``batched_eigh`` keeps it
    out)."""
    from kfac_tpu_torch.ops import factors

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(256, 64, generator=gen)
    base = (a.T @ a / 256).cuda()
    out = {}
    for kind in ('nan_pair', 'all_nan', 'inf'):
        f = base.clone()
        if kind == 'nan_pair':
            f[3, 5] = f[5, 3] = float('nan')
        elif kind == 'all_nan':
            f.fill_(float('nan'))
        else:
            f[7, 7] = float('inf')
        try:
            dec = factors.compute_eigh(f)
            out[kind] = dict(d_nan=int(torch.isnan(dec.d).sum()), q_nan=int(torch.isnan(dec.q).sum()))
        except Exception as exc:  # recorded, not a failure of the phase
            out[kind] = dict(raises=f'{type(exc).__name__}: {str(exc)[:200]}')
    return out


def run_resnet(launches) -> bool:
    """The convolutional family on the card (the module's docstring, phase
    13)."""
    from kfac_tpu_torch import assignment
    from kfac_tpu_torch.ops import factors
    from kfac_tpu_torch.parallel import spawn_world

    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    variables = flax_resnet_variables(0)
    wrappers = main_path_wrappers()
    ok = True
    # cuDNN's deterministic algorithms: its default weight-gradient
    # algorithm here sums with atomics, and this model's grads move by
    # ~7e-4 of their max for rounding-level changes (the control below)
    torch.backends.cudnn.deterministic = True

    # (a) EIGEN, 21 steps: the main path of the phase
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    run = ResNetRun(variables, cuda)
    eig = resnet_steps(run, RESNET_STEPS, grads_at=(0, 1))
    counts = {n: w.launches for n, w in wrappers.items()}
    expected = dict(resnet_expected(RESNET_STEPS), fused_ns_step=0)
    peak = torch.cuda.max_memory_allocated()
    cpu_run = resnet_steps(ResNetRun(variables, cpu), RESNET_CPU_STEPS, grads_at=(0, 1))
    loss_err = max(
        abs(a - b) / abs(b) for a, b in zip(eig['losses'][:RESNET_CPU_STEPS], cpu_run['losses'])
    )
    grad_err = grads_err(eig['grads'][0], cpu_run['grads'][0])
    step1_grad_err = grads_err(eig['grads'][1], cpu_run['grads'][1])
    capture_steps = set(range(0, RESNET_STEPS, RESNET_EVERY[0]))
    per_step_ok = all(
        c == (2 * RESNET_LAYERS if i in capture_steps else 0) for i, c in enumerate(eig['sym_cov_by_step'])
    )
    layers = len(run.registry)
    finite = all(math.isfinite(x) for x in eig['losses'])
    falling = eig['losses'][-1] < eig['losses'][0]
    passed = (
        finite and falling and layers == RESNET_LAYERS and counts == expected and per_step_ok
        and loss_err <= 1e-4 and grad_err <= 1e-3
    )
    for name, count in counts.items():
        launches[name] = launches.get(name, 0) + count
    emit(dict(
        phase='resnet', run='eigen', config=RESNET32, cadence=list(RESNET_EVERY), steps=RESNET_STEPS,
        registered_layers=layers, losses=eig['losses'], finite=finite, loss_falls=falling,
        step_ms=[s * 1e3 for s in eig['seconds']], **resnet_step_kinds(eig['seconds']),
        images_per_step=RESNET32['batch'], peak_memory_gib=peak / 2**30,
        sym_cov_by_step=eig['sym_cov_by_step'], sym_cov_per_capture_step=2 * RESNET_LAYERS,
        launches=counts, expected_launches=expected,
        cpu_reference=dict(
            steps=RESNET_CPU_STEPS, losses_cuda=eig['losses'][:RESNET_CPU_STEPS],
            losses_cpu=cpu_run['losses'], loss_rel_err=loss_err, loss_tol=1e-4,
            pgrad_err_rel_to_max=grad_err, pgrad_tol=1e-3, grads_compared_after_step=0,
            step_1_pgrad_err_rel_to_max=step1_grad_err,
        ),
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, passed=passed,
    ))
    ok &= passed
    # after the counted run: a plain step (21) and, 8 steps on, a capture
    # step (30) under torch.profiler
    plain = profile_step(run, RESNET_STEPS)
    train(run, RESNET_EVERY[0] - 2)
    emit(dict(phase='resnet_profile', steps=[plain, profile_step(run, 3 * RESNET_EVERY[0])]))
    del run

    # the control of the KAISA comparison: the dense engine from weights
    # moved by 1e-7 (relative, seeded), its losses against (a)'s
    run = ResNetRun(variables, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    with torch.no_grad():
        for p in run.trainer.model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen, device=cuda))
    moved = resnet_steps(run, RESNET_KAISA_STEPS, grads_at=(0, 1))
    control = dict(
        weights_moved_by=1e-7,
        loss_rel_err_by_step=[abs(a - b) / abs(b) for a, b in zip(moved['losses'], eig['losses'])],
        pgrad_err_rel_to_max_after=[grads_err(moved['grads'][i], eig['grads'][i]) for i in (0, 1)],
    )
    del run

    # (b) INVERSE + Newton-Schulz, 11 steps: a cold refresh at step 0
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    run = ResNetRun(variables, cuda, **INVERSE_NS)
    ns = resnet_steps(run, 1)
    residuals = inverse_residuals(run)
    ns_rest = resnet_steps(run, RESNET_NS_STEPS - 1)
    counts = {n: w.launches for n, w in wrappers.items()}
    expected = resnet_expected(RESNET_NS_STEPS)
    # one cold refresh: at most the cap a factor; a factor that damping
    # dominates (a conv's A, whose patch rows are divided by the spatial
    # size) is inverted by its cold start to within the tolerance and
    # takes no iteration
    ns_range = [1, 2 * RESNET_LAYERS * 40]
    losses = ns['losses'] + ns_rest['losses']
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    passed = (
        finite and falling and {n: counts[n] for n in expected} == expected
        and ns_range[0] <= counts['fused_ns_step'] <= ns_range[1]
        and max(residuals) <= factors.NS_FALLBACK_RESIDUAL
    )
    for name, count in counts.items():
        launches[name] = launches.get(name, 0) + count
    seconds = ns['seconds'] + ns_rest['seconds']
    emit(dict(
        phase='resnet', run='inverse_newton_schulz', kfac=INVERSE_NS, steps=RESNET_NS_STEPS,
        losses=losses, finite=finite, loss_falls=falling, step_ms=[s * 1e3 for s in seconds],
        **resnet_step_kinds(seconds), peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        max_independent_residual=max(residuals), residual_limit=factors.NS_FALLBACK_RESIDUAL,
        launches=counts, expected_launches=dict(expected, fused_ns_step=ns_range), passed=passed,
    ))
    ok &= passed
    del run
    torch.cuda.empty_cache()

    # (c) the KAISA engine: COMM-OPT on one card, MEM-OPT on four
    world = torch.cuda.device_count()
    frac = min(assignment.candidate_fractions(world))
    t0 = time.perf_counter()
    rows = spawn_world(resnet_kaisa_rank, world, 'nccl', 'cuda', args=(frac, variables), timeout_s=600)
    spawn_seconds = time.perf_counter() - t0
    r0 = rows[0]
    want = eig['losses'][:RESNET_KAISA_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(r0['losses'], want)]
    loss_err = max(rel[:RESNET_COMPARED_LOSSES])
    grad_err = grads_err(r0['grads'][0], eig['grads'][0])
    expected = dict(resnet_expected(RESNET_KAISA_STEPS), fused_ns_step=0, fused_ns_step_stacked=0)
    launches_exact = all(r['launches'] == expected for r in rows)
    same = len({r['param_digest'] for r in rows}) == 1 and len({r['model_state_digest'] for r in rows}) == 1
    finite = all(math.isfinite(x) for x in r0['losses'])
    passed = finite and loss_err <= 1e-4 and grad_err <= 1e-3 and same and launches_exact
    for name, count in r0['launches'].items():
        launches[name] = launches.get(name, 0) + count
    emit(dict(
        phase='resnet', run='kaisa', world=world, backend='nccl', frac=frac, strategy=r0['strategy'],
        grid=r0['grid'], steps=RESNET_KAISA_STEPS, losses=r0['losses'], dense_losses=want,
        compared_losses=RESNET_COMPARED_LOSSES, loss_rel_err=loss_err, loss_tol=1e-4,
        loss_rel_err_by_step=rel, grads_compared_after_step=0,
        pgrad_err_rel_to_max=grad_err, pgrad_tol=1e-3,
        step_1_pgrad_err_rel_to_max=grads_err(r0['grads'][1], eig['grads'][1]),
        control=control,
        params_and_batch_stats_identical_on_every_rank=same,
        step_ms_by_rank=[dict(
            rank=r['rank'], step_0=r['step_0_ms'], capture=r['capture_step_ms'],
            plain_median=r['plain_step_ms_median'],
        ) for r in rows],
        peak_memory_by_rank=[r['peak_memory_bytes'] for r in rows],
        decomposition_bytes_by_rank=[r['decomposition_bytes'] for r in rows],
        launches_by_rank=[r['launches'] for r in rows], expected_launches=expected,
        spawn_seconds=spawn_seconds, passed=passed,
    ))
    ok &= passed
    cases = nonfinite_eigh_on_card()
    passed = all(c == dict(d_nan=64, q_nan=64 * 64) for c in cases.values())
    emit(dict(phase='resnet_nonfinite_eigh', cases=cases, passed=passed))
    torch.backends.cudnn.deterministic = False
    return ok and passed


# ------------------------------------------------------------ engine_knobs

KNOBS_EVERY = 10  # the cadence of (a), (c) and (e)
KNOBS_SLICED_STEPS = 31  # (a): swaps at 10, 20 and 30
KNOBS_NS_STEPS = 11  # (a)'s INVERSE + Newton-Schulz run: the swap at 10
KNOBS_COMP_STEPS = 21  # (c): captures and refreshes at 0, 10 and 20
KNOBS_WIRES = (('f32', None), ('int8', 'int8'), ('fp8', 'fp8'))
KNOBS_OFFLOAD = dict(min_cold_steps=4, prefetch_lead=1)
KNOBS_OFFLOAD_STEPS = 21  # (d): spills at 1 and 11, prefetches at 9 and 19, restores at 10 and 20
KNOBS_KAISA_OFFLOAD_STEPS = 11  # (e): a spill at 1, a prefetch at 9, a restore at 10
KNOBS_SPILLED_STEP = 5  # a step inside the first spill window
# (d): the flagship's factor elements (dense), the ISSUE's figure
FLAGSHIP_FACTOR_ELEMENTS = 66_115_620


def knobs_fracs(world: int, part: str) -> list[float]:
    """(a)'s fractions: COMM-OPT, and on four cards MEM-OPT beside it; (c)
    COMM-OPT; (e) COMM-OPT on one card, MEM-OPT on more."""
    mem_opt = 1.0 / world
    if part == 'sliced':
        return [1.0] if world == 1 else [1.0, mem_opt]
    if part == 'offload':
        return [mem_opt]
    return [1.0]


def knobs_flagship(device, frac, **kfac_kw):
    """The flagship LM (weights from seed 1, one seeded global batch)
    through ``Trainer`` with a ``DistributedKFAC`` over ``kaisa_mesh(frac)``
    (damping 0.003, lr 0.1, cadence 10/10 unless ``kfac_kw`` says else,
    SGD(0.1, momentum 0.9))."""
    import kfac_tpu_torch as kt
    from kfac_tpu_torch.models import TransformerLM, lm_loss
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
    from kfac_tpu_torch.training import Trainer

    cfg = FLAGSHIP
    model = TransformerLM(
        vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
        num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device,
    )
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
    batch = (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device))
    reg = kt.register_model(model, skip_layers=['lm_head'], device=device)
    kw = dict(damping=0.003, lr=0.1, factor_update_steps=KNOBS_EVERY, inv_update_steps=KNOBS_EVERY)
    kw.update(kfac_kw)
    engine = DistributedKFAC(kt.KFACPreconditioner(reg, device=device, **kw),
                             kaisa_mesh(frac, device=device))
    loss = lm_loss(model)
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
                      lambda ms, b: (loss(b), ms), kfac=engine, device=device)
    return trainer, engine, model, batch


class KnobRun:
    """A Trainer, its engine, model and batch in the shape ``counted_step``
    drives."""

    def __init__(self, trainer, batch):
        self.trainer, self.batch = trainer, batch
        self.kfac = trainer.kfac
        self.state = trainer.init()

    @property
    def kstate(self):
        return self.state.kfac_state


def zero_counts(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def live_solves(engine, units) -> int:
    """Stacked solves the rank launches over ``units`` ((side, key)): one a
    store whose factor block holds a live slot."""
    n = 0
    for side, key in units:
        sb = engine._stores[side, key]
        n += engine._factor_range(sb.padded)[0] < len(sb.layers)
    return n


def knobs_sliced(rank, device, frac, wrappers) -> dict:
    """(a): the flagship, EIGEN, ``async_inverse='sliced'``, 31 steps; the
    oracle (the synchronous refresh of its factors a window back, on the
    same engine, bit for bit); then 11 steps of INVERSE + Newton-Schulz,
    sliced, with the swapped inverses' residuals against the factors they
    came from."""
    from kfac_tpu_torch.ops import factors

    trainer, engine, model, batch = knobs_flagship(device, frac, async_inverse='sliced')
    run = KnobRun(trainer, batch)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts(wrappers)
    losses, seconds, syncs, factors_at, decomps_at = [], [], [], {}, {}
    for i in range(KNOBS_SLICED_STEPS):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
        if i in (10, 20):
            factors_at[i] = host_copy({'a': run.kstate.a, 'g': run.kstate.g})
        if i in (20, 30):
            decomps_at[i] = host_copy({f: getattr(run.kstate, f) for f in ('qa', 'qg', 'da', 'dg')})
    counts = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    bitwise, differing = True, []
    for swap, src in ASYNC_ORACLE:
        ref = engine.update_inverses(dataclasses.replace(
            run.kstate, a={k: v.to(device) for k, v in factors_at[src]['a'].items()},
            g={k: v.to(device) for k, v in factors_at[src]['g'].items()},
        ))
        for f, stacks in decomps_at[swap].items():
            for k, v in stacks.items():
                if not torch.equal(getattr(ref, f)[k].cpu(), v):
                    bitwise = False
                    differing.append(f'{swap}:{f}:{k}')
    window_ms = [s * 1e3 for s in seconds[11:]]
    median = statistics.median(window_ms)
    out = dict(
        frac=frac, strategy=engine.strategy.name, losses=losses,
        step_ms=[s * 1e3 for s in seconds],
        steps_11_30=dict(ms_median=median, ms_max=max(window_ms),
                         refresh_spike_ratio=max(window_ms) / median),
        syncs=sliced_syncs_by_kind(syncs, engine._async_n_slices), peak_memory_bytes=peak,
        slice_plan=[[list(u) for u in s] for s in engine._async_slices],
        launches=counts, oracle=dict(bitwise=bitwise, differing=differing[:8]),
        param_digest=param_digest(model),
    )
    del trainer, engine, model, run
    torch.cuda.empty_cache()
    # INVERSE + Newton-Schulz, sliced
    trainer, engine, model, batch = knobs_flagship(device, frac, async_inverse='sliced', **INVERSE_NS)
    run = KnobRun(trainer, batch)
    zero_counts(wrappers)
    ns_losses = []
    f0 = None
    for i in range(KNOBS_NS_STEPS):
        loss, _, _ = counted_step(run)
        ns_losses.append(loss)
        if i == 0:  # the window's slices decompose the factors after step 0
            f0 = {'a': dict(run.kstate.a), 'g': dict(run.kstate.g)}
            f0 = pytree.tree_map_only(torch.Tensor, torch.clone, f0)
    ns_counts = {n: w.launches for n, w in wrappers.items()}
    res = engine.inverse_residuals(dataclasses.replace(run.kstate, **f0))
    # the swap at 10 promoted them: a residual a slot of each stack
    from kfac_tpu_torch.async_inverse import sliced

    units = [u for u, _ in sliced.kaisa_units(engine)]
    slice_units = [u for s in engine._async_slices for u in s]
    solves = live_solves(engine, units) + live_solves(engine, slice_units) + live_solves(
        engine, engine._async_slices[0])
    out['sliced_ns'] = dict(
        steps=KNOBS_NS_STEPS, losses=ns_losses,
        max_independent_residual_after_swap=max(float(r.max()) for s in res.values() for r in s.values()),
        residual_limit=factors.NS_FALLBACK_RESIDUAL, launches=ns_counts,
        fused_ns_step_stacked_range=[solves, solves * 2 * 40],
    )
    del trainer, engine, model, run
    torch.cuda.empty_cache()
    return out


def sliced_syncs_by_kind(syncs, n_slices) -> dict:
    """Host syncs of step 0, of the window boundaries (a swap and the
    first slice), of the other slice steps and of the steps without a
    slice: each kind's count of steps, max and median."""
    kinds = {'step_0': [syncs[0]], 'boundary': [], 'slice': [], 'plain': []}
    for i, n in enumerate(syncs[1:], start=1):
        phase = i % KNOBS_EVERY
        kinds['boundary' if phase == 0 else 'slice' if phase < n_slices else 'plain'].append(n)
    return {k: dict(steps=len(v), syncs_max=max(v), syncs_median=statistics.median(v))
            for k, v in kinds.items() if v}


def knobs_host(rank, device, frac, wrappers) -> dict:
    """(b): the async spike probe's MLP on a ``DistributedKFAC`` under
    EIGEN, ``'host'``: each boundary's wait in the pump, and after each
    swap the preconditioned grads against the synchronous engine's refresh
    of the factors a window back."""
    from kfac_tpu_torch import KFACPreconditioner, bench_lm
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh

    trainer, batch = bench_lm.probe_trainer(device, window=PROBE_WINDOW, async_inverse='host')
    mesh = kaisa_mesh(frac, device=device)
    engine = DistributedKFAC(trainer.kfac, mesh)
    trainer.rebind_engine(engine)
    run = KnobRun(trainer, batch)
    engine_step, seen = engine.step, {}

    def recording(state, grads, stats, loss=None):
        if state.step % PROBE_WINDOW == 0:
            seen[state.step] = {n: g.clone() for n, g in grads.items()}
        return engine_step(state, grads, stats, loss=loss)

    engine.step = recording
    zero_counts(wrappers)
    waits, seconds, syncs, at = [], [], [], {}
    for i in range(PROBE_STEPS):
        _, sec, n = counted_step(run)
        seconds.append(sec)
        syncs.append(n)
        if i == 0:
            take = engine._async_worker.take

            def timed_take(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return take(*args, **kwargs)
                finally:
                    waits.append((time.perf_counter() - t0) * 1e3)

            engine._async_worker.take = timed_take
        if i % PROBE_WINDOW == 0:
            at[i] = run.kstate
    del engine.step
    counts = {n: w.launches for n, w in wrappers.items()}
    cfg = engine.config
    sync_engine = DistributedKFAC(KFACPreconditioner(
        cfg.registry, damping=cfg.damping, lr=cfg.lr, factor_update_steps=PROBE_WINDOW,
        inv_update_steps=PROBE_WINDOW, device=device,
    ), mesh)
    worst = []
    for b in range(PROBE_WINDOW, PROBE_STEPS, PROBE_WINDOW):
        prev = at[b - PROBE_WINDOW]
        ref = sync_engine.update_inverses(dataclasses.replace(at[b], a=prev.a, g=prev.g))
        want = sync_engine.precondition(ref, seen[b])
        got = engine.precondition(at[b], seen[b])
        worst.append(max(
            float(((got[n] - w).abs() - HOST_RTOL * w.abs() - HOST_ATOL).max()) for n, w in want.items()
        ))
    steps_ms = [s * 1e3 for s in seconds]
    other = [ms for i, ms in enumerate(steps_ms) if i % PROBE_WINDOW]
    out = dict(
        frac=frac, boundary_wait_ms=waits, boundary_step_ms=steps_ms[PROBE_WINDOW::PROBE_WINDOW],
        other_step_ms_median=statistics.median(other), syncs=syncs_by_kind(syncs, PROBE_WINDOW),
        grads_excess_over_tolerance_by_swap=worst, rtol=HOST_RTOL, atol=HOST_ATOL, launches=counts,
    )
    del trainer, engine, sync_engine, run
    torch.cuda.empty_cache()
    return out


def scope_device_ms(prof, names) -> dict:
    """Device ms of the kernels launched under each ``record_function``
    scope of ``names``: each scope event's kernels and its children's, by
    the profiler's event tree."""
    def device_us(evt):
        return sum(k.duration for k in getattr(evt, 'kernels', ())) + sum(
            device_us(c) for c in evt.cpu_children)

    out = {n: 0.0 for n in names}
    for evt in prof.events():
        if evt.name in out:
            out[evt.name] += device_us(evt) / 1e3
    return out


def device_busy_ms(prof) -> float:
    """The kernels' device ms of a profile, scope annotations left out (as
    :func:`device_profile` counts them)."""
    scopes = {evt.name for evt in prof.events() if str(evt.device_type).endswith('CPU')}
    return sum(
        evt.self_device_time_total / 1e3 for evt in prof.key_averages()
        if str(evt.device_type).endswith('CUDA') and evt.self_device_time_total > 0
        and evt.key not in scopes
    )


def knobs_compressed(rank, device, frac, wrappers) -> dict:
    """(c): the flagship at cadence 10/10 on ALLREDUCE_BUCKETED, 21 steps
    at each wire; the transport's collectives over capture step 10; then
    the capture step 20 under torch.profiler with the quantize and
    dequantize scopes' device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, comp in KNOBS_WIRES:
        trainer, engine, model, batch = knobs_flagship(
            device, frac, allreduce_method='allreduce_bucketed', stat_compression=comp,
        )
        run = KnobRun(trainer, batch)
        zero_counts(wrappers)
        losses, seconds, syncs, moved = [], [], [], None
        for i in range(KNOBS_COMP_STEPS - 1):
            if i == KNOBS_EVERY:
                engine.transport_counter.update(collectives=0, buffer_bytes=0, ring_bytes=0)
            loss, sec, n = counted_step(run)
            if i == KNOBS_EVERY:
                moved = dict(engine.transport_counter)
            losses.append(loss)
            seconds.append(sec)
            syncs.append(n)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            loss, _, _ = counted_step(run)
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        counts = {n: w.launches for n, w in wrappers.items()}
        busy = device_busy_ms(prof)
        scopes = scope_device_ms(prof, ('kfac.stat_quantize', 'kfac.stat_dequantize'))
        transport = engine.comms_report()['stat_transport']
        out[name] = dict(
            losses=losses, capture_step_ms=[seconds[0] * 1e3, seconds[KNOBS_EVERY] * 1e3],
            plain_step_ms_median=statistics.median(
                s * 1e3 for i, s in enumerate(seconds) if i % KNOBS_EVERY),
            syncs=step_kinds(seconds, syncs, KNOBS_EVERY, KNOBS_EVERY),
            capture_step_collectives=moved,
            raw_bytes=transport['raw_bytes'], wire_bytes=transport['wire_bytes'],
            port_collectives=transport.get('port_collectives'),
            profiled_capture_step=dict(
                wall_ms=wall, device_busy_ms=busy, quantize_device_ms=scopes['kfac.stat_quantize'],
                dequantize_device_ms=scopes['kfac.stat_dequantize'],
                quant_share_of_wall=(scopes['kfac.stat_quantize'] + scopes['kfac.stat_dequantize']) / wall,
                quant_share_of_device_busy=(
                    scopes['kfac.stat_quantize'] + scopes['kfac.stat_dequantize']) / busy,
            ),
            launches=counts, param_digest=param_digest(model),
        )
        del trainer, engine, model, run, prof
        torch.cuda.empty_cache()
    return out


def knobs_offload(rank, device, frac, wrappers) -> dict:
    """(e): the flagship on a ``DistributedKFAC`` (cadence 10/10, EIGEN)
    for 11 steps with offload off and on: losses, and the rank's
    ``memory_allocated`` at a spilled step against the same step off."""
    from kfac_tpu_torch.compression import OffloadConfig

    import gc

    out = {}
    for name, off in (('off', None), ('on', OffloadConfig(**KNOBS_OFFLOAD))):
        gc.collect()  # the Trainer's hooks hold cycles: free the last run first
        torch.cuda.empty_cache()
        trainer, engine, model, batch = knobs_flagship(device, frac, offload=off)
        run = KnobRun(trainer, batch)
        zero_counts(wrappers)
        losses, memory, syncs, seconds = [], [], [], []
        for i in range(KNOBS_KAISA_OFFLOAD_STEPS):
            loss, sec, n = counted_step(run)
            losses.append(loss)
            seconds.append(sec * 1e3)
            syncs.append(n)
            memory.append(torch.cuda.memory_allocated(device))
            if i == 0:
                usage = engine.memory_usage(run.kstate)
        out[name] = dict(
            losses=losses, memory_allocated=memory, step_ms=seconds, syncs=syncs,
            shard_factor_bytes=usage['a_factors'] + usage['g_factors'],
            launches={n: w.launches for n, w in wrappers.items()},
            stats=None if off is None else dict(engine._offload_manager.stats),
        )
        del trainer, engine, model, run
        torch.cuda.empty_cache()
    return out


def knobs_rank(rank: int, world: int, device: torch.device, parts: list[str]) -> dict:
    """One NCCL rank of the engine_knobs phase: (a), (b), (c), (e)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = kaisa_wrappers()
    fns = {'sliced': knobs_sliced, 'host': knobs_host, 'compressed': knobs_compressed,
           'offload': knobs_offload}
    out = {}
    for part in parts:
        out[part] = [fns[part](rank, device, frac, wrappers) for frac in knobs_fracs(world, part)]
    return out


def knobs_dense_offload(launches, main_losses, main_tail) -> dict:
    """(d): the flagship on the dense engine (EIGEN, cadence 10/100) with
    ``OffloadConfig(min_cold_steps=4, prefetch_lead=1)``, 21 steps, and
    the same without offload: losses bitwise ``main_path``'s and the run's
    without, ``memory_allocated`` a step, the counters, the ms and host
    syncs of each kind of step."""
    from kfac_tpu_torch.compression import OffloadConfig, is_spilled

    import gc

    wrappers = main_path_wrappers()
    runs = {}
    for name, off in (('off', None), ('on', OffloadConfig(**KNOBS_OFFLOAD))):
        gc.collect()  # the Trainer's hooks hold cycles: free the last run first
        torch.cuda.empty_cache()
        run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100, offload=off)
        zero_counts(wrappers)
        losses, seconds, syncs, memory, spilled = [], [], [], [], []
        for i in range(KNOBS_OFFLOAD_STEPS):
            loss, sec, n = counted_step(run)
            losses.append(loss)
            seconds.append(sec * 1e3)
            syncs.append(n)
            memory.append(torch.cuda.memory_allocated())
            spilled.append(is_spilled(run.kstate))
        counts = count_into(launches, wrappers) if off is not None else {
            n: w.launches for n, w in wrappers.items()}
        factor_bytes = sum(
            t.numel() * t.element_size() for side in ('a', 'g') for t in getattr(run.kstate, side).values()
        )
        runs[name] = dict(losses=losses, step_ms=seconds, syncs=syncs, memory=memory,
                          spilled=spilled, launches=counts, factor_bytes=factor_bytes,
                          stats=None if off is None else dict(run.kfac._offload_manager.stats))
        del run
        torch.cuda.empty_cache()
    on, off = runs['on'], runs['off']
    factor_bytes = off['factor_bytes']
    # the run without offload moves by this much across the same steps:
    # the drop is read against the factor bytes less it
    spread = max(off['memory'][1:]) - min(off['memory'][1:])
    kinds = {'spill': [1, 11], 'prefetch': [9, 19], 'restore': [10, 20]}
    # a prefetch step ends with the factors back on the device, in flight
    drop = [o - n for i, (o, n, s) in enumerate(zip(off['memory'], on['memory'], on['spilled']))
            if s and i not in kinds['prefetch']]
    stats = on['stats']
    hits = stats['prefetch_hits'] + stats['prefetch_misses']
    out = dict(
        config='flagship, EIGEN, cadence 10/100, OffloadConfig(min_cold_steps=4, prefetch_lead=1)',
        steps=KNOBS_OFFLOAD_STEPS,
        # main_path's 20 counted steps and its profiled capture step 20
        losses_bitwise_main_path=on['losses'] == (main_losses + main_tail)[:KNOBS_OFFLOAD_STEPS],
        compared_main_path_steps=len((main_losses + main_tail)[:KNOBS_OFFLOAD_STEPS]),
        losses_bitwise_offload_off=on['losses'] == off['losses'],
        spilled_steps=[i for i, s in enumerate(on['spilled']) if s],
        factor_bytes=factor_bytes, factor_elements=factor_bytes // 4,
        memory_allocated_on_spilled_step=on['memory'][KNOBS_SPILLED_STEP],
        memory_allocated_offload_off_same_step=off['memory'][KNOBS_SPILLED_STEP],
        drop_bytes_min=min(drop), drop_bytes_max=max(drop),
        drop_over_factor_bytes=min(drop) / factor_bytes,
        offload_off_memory_spread_bytes=spread,
        memory_allocated_by_step=dict(on=on['memory'], off=off['memory']),
        counters=dict(stats, prefetch_hit_rate=stats['prefetch_hits'] / hits if hits else None),
        step_ms={k: dict(on=[on['step_ms'][i] for i in v], off=[off['step_ms'][i] for i in v])
                 for k, v in kinds.items()},
        plain_step_ms_median=dict(
            on=statistics.median(ms for i, ms in enumerate(on['step_ms']) if i > 1 and i % 10 not in (0, 1, 9)),
            off=statistics.median(ms for i, ms in enumerate(off['step_ms']) if i > 1 and i % 10 not in (0, 1, 9)),
        ),
        syncs_by_kind=dict(
            spill=max(on['syncs'][i] for i in kinds['spill']),
            prefetch=max(on['syncs'][i] for i in kinds['prefetch']),
            restore=max(on['syncs'][i] for i in kinds['restore']),
            spilled_plain=max(on['syncs'][i] for i, s in enumerate(on['spilled']) if s and i not in kinds['spill']),
        ),
        launches=on['launches'], launches_offload_off=off['launches'],
    )
    out['passed'] = bool(
        out['losses_bitwise_main_path'] and out['losses_bitwise_offload_off']
        and out['compared_main_path_steps'] == KNOBS_OFFLOAD_STEPS
        and max(out['syncs_by_kind'].values()) == 0
        and factor_bytes == 4 * FLAGSHIP_FACTOR_ELEMENTS
        and min(drop) >= factor_bytes - spread and max(drop) >= factor_bytes
        and stats['prefetch_hits'] == 2 and stats['prefetch_misses'] == 0
        and out['counters']['prefetch_hit_rate'] == 1.0 and on['launches'] == off['launches']
    )
    return out


def run_engine_knobs(launches, main_losses, main_tail, dense_async) -> bool:
    """The engines' last knobs (see the module's docstring, phase 15)."""
    from kfac_tpu_torch.ops import factors
    from kfac_tpu_torch.parallel import spawn_world

    world = torch.cuda.device_count()
    ok = True
    dense = knobs_dense_offload(launches, main_losses, main_tail)
    emit(dict(phase='engine_knobs', part='d_offload_dense', **dense))
    ok &= dense['passed']
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = spawn_world(knobs_rank, world, 'nccl', 'cuda',
                          args=(['sliced', 'host', 'compressed', 'offload'],), timeout_s=600)
    spawn_seconds = time.perf_counter() - t0
    r0 = results[0]
    show = range(world) if world > 1 else [0]

    def by_rank(part, j, key):
        return [results[r][part][j][key] for r in show]

    for j, frac in enumerate(knobs_fracs(world, 'sliced')):
        a = r0['sliced'][j]
        steps = KNOBS_SLICED_STEPS
        expected = kaisa_expected(steps)
        ns = a['sliced_ns']
        ns_expected = kaisa_expected(KNOBS_NS_STEPS)
        launches_ok = all(
            {n: r['sliced'][j]['launches'][n] for n in expected} == expected
            and {n: r['sliced'][j]['sliced_ns']['launches'][n] for n in ns_expected} == ns_expected
            and r['sliced'][j]['launches']['fused_ns_step_stacked'] == 0
            and (lambda lo, hi, x: lo <= x <= hi)(
                *r['sliced'][j]['sliced_ns']['fused_ns_step_stacked_range'],
                r['sliced'][j]['sliced_ns']['launches']['fused_ns_step_stacked'])
            for r in results
        )
        residual_ok = all(
            r['sliced'][j]['sliced_ns']['max_independent_residual_after_swap'] <= factors.NS_FALLBACK_RESIDUAL
            for r in results
        )
        passed = bool(
            all(r['sliced'][j]['oracle']['bitwise'] for r in results)
            and all(math.isfinite(x) for x in a['losses']) and a['losses'][-1] < a['losses'][0]
            and len({r['sliced'][j]['param_digest'] for r in results}) == 1
            and launches_ok and residual_ok
        )
        for n, c in a['launches'].items():
            launches[n] = launches.get(n, 0) + c
        for n, c in ns['launches'].items():
            launches[n] = launches.get(n, 0) + c
        emit(dict(
            phase='engine_knobs', part='a_kaisa_sliced', world=world, frac=frac,
            strategy=a['strategy'], cadence=[KNOBS_EVERY, KNOBS_EVERY], steps=steps,
            losses=a['losses'], slice_plan=a['slice_plan'],
            oracle_by_rank=[results[r]['sliced'][j]['oracle'] for r in show],
            steps_11_30_by_rank=by_rank('sliced', j, 'steps_11_30'),
            dense_async_refresh_steps_11_30=dense_async,
            syncs_by_rank=by_rank('sliced', j, 'syncs'),
            peak_memory_by_rank=by_rank('sliced', j, 'peak_memory_bytes'),
            launches_by_rank=by_rank('sliced', j, 'launches'), expected_launches=expected,
            sliced_ns=dict(
                steps=KNOBS_NS_STEPS, losses=ns['losses'],
                max_independent_residual_after_swap_by_rank=[
                    results[r]['sliced'][j]['sliced_ns']['max_independent_residual_after_swap']
                    for r in show],
                residual_limit=factors.NS_FALLBACK_RESIDUAL,
                fused_ns_step_stacked_by_rank=[
                    results[r]['sliced'][j]['sliced_ns']['launches']['fused_ns_step_stacked'] for r in show],
                fused_ns_step_stacked_range_by_rank=[
                    results[r]['sliced'][j]['sliced_ns']['fused_ns_step_stacked_range'] for r in show],
            ),
            passed=passed,
        ))
        ok &= passed
    for j, frac in enumerate(knobs_fracs(world, 'host')):
        b = r0['host'][j]
        expected = dict(expected_launches(PROBE_STEPS, len(range(0, PROBE_STEPS, PROBE_WINDOW))),
                        flash_attention_partials=0, fused_ns_step=0, fused_ns_step_stacked=0)
        expected.update(sym_cov=2 * PROBE_LAYERS * len(range(0, PROBE_STEPS, PROBE_WINDOW)))
        passed = bool(
            all(len(r['host'][j]['grads_excess_over_tolerance_by_swap']) == 4
                and all(x <= 0 for x in r['host'][j]['grads_excess_over_tolerance_by_swap'])
                and len(r['host'][j]['boundary_wait_ms']) == 4
                and r['host'][j]['launches'] == expected for r in results)
        )
        for n, c in b['launches'].items():
            launches[n] = launches.get(n, 0) + c
        emit(dict(
            phase='engine_knobs', part='b_kaisa_host', world=world, frac=frac,
            config='probe MLP d512 b256, EIGEN, host, window 8',
            boundary_wait_ms_by_rank=by_rank('host', j, 'boundary_wait_ms'),
            boundary_step_ms=b['boundary_step_ms'], other_step_ms_median=b['other_step_ms_median'],
            syncs=b['syncs'],
            grads_excess_over_tolerance_by_swap_by_rank=by_rank(
                'host', j, 'grads_excess_over_tolerance_by_swap'),
            rtol=HOST_RTOL, atol=HOST_ATOL, launches_by_rank=by_rank('host', j, 'launches'),
            expected_launches=expected, passed=passed,
        ))
        ok &= passed
    c = r0['compressed'][0]
    expected = kaisa_expected(KNOBS_COMP_STEPS)
    f32_final = c['f32']['losses'][-1]
    wires = {}
    for name, _ in KNOBS_WIRES:
        w = c[name]
        wires[name] = dict(
            losses=w['losses'], final_loss=w['losses'][-1],
            final_rel_to_f32=(w['losses'][-1] - f32_final) / f32_final,
            capture_step_ms=w['capture_step_ms'], plain_step_ms_median=w['plain_step_ms_median'],
            capture_step_ms_by_rank=[results[r]['compressed'][0][name]['capture_step_ms'] for r in show],
            plain_step_ms_median_by_rank=[
                results[r]['compressed'][0][name]['plain_step_ms_median'] for r in show],
            syncs=w['syncs'], capture_step_collectives=w['capture_step_collectives'],
            raw_bytes=w['raw_bytes'], wire_bytes=w['wire_bytes'],
            port_collectives=w['port_collectives'], profiled_capture_step=w['profiled_capture_step'],
        )
    int8, f32 = c['int8'], c['f32']
    moved_ok = world == 1 or (
        int8['capture_step_collectives']['ring_bytes'] < f32['capture_step_collectives']['ring_bytes'])
    passed = bool(
        all(math.isfinite(x) for name, _ in KNOBS_WIRES for x in c[name]['losses'])
        and all(c[name]['losses'][-1] < c[name]['losses'][0] for name, _ in KNOBS_WIRES)
        and abs(int8['losses'][-1] - f32_final) <= 0.05 * abs(f32_final)
        and all(len({results[r]['compressed'][0][name]['param_digest'] for r in range(world)}) == 1
                for name, _ in KNOBS_WIRES)
        and int8['wire_bytes'] * 3 <= int8['raw_bytes'] and moved_ok
        and all({n: r['compressed'][0][name]['launches'][n] for n in expected} == expected
                for r in results for name, _ in KNOBS_WIRES)
        # no host sync of its own: each kind of step as many as the f32 wire's
        and all(w['syncs'][k]['syncs_max'] == f32['syncs'][k]['syncs_max']
                for w in (int8, c['fp8']) for k in f32['syncs'])
        and f32['syncs']['plain']['syncs_max'] == 0
    )
    for name, _ in KNOBS_WIRES:
        for n, cnt in c[name]['launches'].items():
            launches[n] = launches.get(n, 0) + cnt
    emit(dict(
        phase='engine_knobs', part='c_compressed_transport', world=world,
        cadence=[KNOBS_EVERY, KNOBS_EVERY], steps=KNOBS_COMP_STEPS, wires=wires,
        int8_within_5pct_of_f32=abs(int8['losses'][-1] - f32_final) <= 0.05 * abs(f32_final),
        int8_ring_bytes_below_f32=moved_ok, expected_launches=expected, passed=passed,
    ))
    ok &= passed
    for j, frac in enumerate(knobs_fracs(world, 'offload')):
        rows = [r['offload'][j] for r in results]
        drops = [
            r['off']['memory_allocated'][KNOBS_SPILLED_STEP] - r['on']['memory_allocated'][KNOBS_SPILLED_STEP]
            for r in rows
        ]
        # read against the shard less what the run without offload itself
        # moves across the same steps, as (d)
        spreads = [max(r['off']['memory_allocated'][1:]) - min(r['off']['memory_allocated'][1:])
                   for r in rows]
        passed = bool(
            all(r['on']['losses'] == r['off']['losses'] for r in rows)
            and all(d >= r['on']['shard_factor_bytes'] - s for d, s, r in zip(drops, spreads, rows))
            and all(r['on']['stats']['prefetch_hits'] == 1 and r['on']['stats']['prefetch_misses'] == 0
                    for r in rows)
            and all(r['on']['launches'] == r['off']['launches'] for r in rows)
        )
        for n, cnt in rows[0]['on']['launches'].items():
            launches[n] = launches.get(n, 0) + cnt
        emit(dict(
            phase='engine_knobs', part='e_offload_kaisa', world=world, frac=frac,
            steps=KNOBS_KAISA_OFFLOAD_STEPS, losses=rows[0]['on']['losses'],
            losses_bitwise_offload_off_by_rank=[r['on']['losses'] == r['off']['losses'] for r in rows],
            spilled_step=KNOBS_SPILLED_STEP, memory_drop_bytes_by_rank=drops,
            offload_off_memory_spread_by_rank=spreads,
            shard_factor_bytes_by_rank=[r['on']['shard_factor_bytes'] for r in rows],
            counters_by_rank=[r['on']['stats'] for r in rows],
            syncs_by_rank=[r['on']['syncs'] for r in rows],
            step_ms_on=rows[0]['on']['step_ms'], step_ms_off=rows[0]['off']['step_ms'],
            passed=passed,
        ))
        ok &= passed
    emit(dict(phase='engine_knobs_world', world=world, spawn_seconds=spawn_seconds, passed=ok))
    return ok

# a quarter of the bench's own window, to keep the script within its time
# ---------------------------------------------------------------- moe, lora

# The flagship with switch-MoE blocks: blocks 2, 4 and 6 (block1, block3,
# block5) route top-1 over 4 experts at capacity factor 1.25 (C = 2560 rows
# an expert), the experts registered as routed layers, the Switch
# Transformer's load-balance loss at 0.01; expert 3 of block1 is starved
# (its router bias at -1e4), so its factors must never move.
MOE = dict(
    experts=4, moe_every=2, capacity_factor=1.25, load_balance=0.01,
    routed_layers=[r'.*expert\d+_(up|down)'], starved=[('block1.moe', 3)],
)
MOE_STEPS = 21  # dense engine, EIGEN, cadence 10/100: captures at 0, 10, 20; the refresh at 0
MOE_DENSE_STEPS = 3  # the dense masked dispatch
MOE_KAISA_STEPS = 11  # DistributedKFAC: captures at 0 and 10
# 24 attention projections, 6 dense MLP layers, 3 routers, 24 experts
MOE_LAYERS = 57
# their factors' f32 elements: attention 24 (513^2 + 512^2), the dense MLP
# and the experts 15 (513^2 + 2048^2 + 2049^2 + 512^2), the routers
# 3 (513^2 + 4^2)
MOE_FACTOR_ELEMENTS = 147_167_337
MOE_BLOCKS = ('block1', 'block3', 'block5')
# the covariances of a capture step (rows, width): the experts' A and G
# over C = 2560 buffer rows, the router's G over the 8192 tokens
MOE_COVS = [(2560, 513), (2560, 2049), (2560, 2048), (2560, 512), (8192, 4)]
# the LoRA fine-tune's role blocks at its batch of 128 (the unit's input
# and G of up, 64 wide; down's output and G, rank 8)
LORA_COVS = [(128, 64), (128, 8)]
# the tp_sp phase's covariances on a rank (rows, width): 4096 tokens at
# model 2 x seq 2 and dp 2 x model 2, 2048 at seq 4; A of the replicated
# inputs and of the gathered row-parallel inputs, G of the gathered
# column-parallel outputs and of the replicated ones
TP_SP_COVS = [(4096, 513), (4096, 512), (4096, 2048), (4096, 2049), (2048, 512), (2048, 2048)]
LORA_STEPS = 300  # the gate's fine-tune; the pretraining runs no kernel
LORA_COVS_A_STEP = 10  # two units x (two roles x (A, G)), the head's A and G
LORA_COMPARED = 20  # the fine-tune's losses compared card against CPU


def moe_expected(steps: int, captures: int) -> dict:
    """Launches of the MoE flagship's dense run: two ``sym_cov`` a layer a
    capture (the routed ones on their C-row buffers), the grouped kl-clip
    dot and scale once a step, the flash partials once a block a step."""
    return dict(
        expected_launches(steps, captures), sym_cov=2 * MOE_LAYERS * captures, fused_ns_step=0,
    )


def moe_capture(run):
    """One capture of the run's model and batch (``value_stats_and_grad``):
    (loss, grads, stats, each MoE block's input and expert index)."""
    from kfac_tpu_torch.layers import capture

    model = run.trainer.model
    inputs, hooks = {}, []
    for b in MOE_BLOCKS:
        m = model.get_submodule(f'{b}.moe')
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args, b=b: inputs.update({b: args[0].detach()})))
    try:
        (loss, _), grads, stats = capture.CurvatureCapture(run.registry).value_stats_and_grad(
            run.loss)(run.batch)
    finally:
        for h in hooks:
            h.remove()
    index = {b: model.get_submodule(f'{b}.moe').expert_index.detach() for b in MOE_BLOCKS}
    return float(loss), grads, stats, inputs, index


def expert_oracle(run, stats, inputs, index) -> dict:
    """Each expert's A factors against the oracle from its routed rows
    alone: the tokens routed to it, in arrival order, the first C; a bias
    one each; their covariance over their count by ``torch.matmul`` (f32),
    for ``up`` from the block's input and for ``down`` from ``gelu(up(.))``
    of those rows. Errors relative to each oracle's max; tolerance 1e-5,
    the ``sym_cov`` kernel's."""
    import torch.nn.functional as F

    model = run.trainer.model
    worst, rows_by_expert = 0.0, {}
    for b in MOE_BLOCKS:
        m = model.get_submodule(f'{b}.moe')
        x = inputs[b].reshape(-1, inputs[b].shape[-1])
        idx = index[b].reshape(-1)
        cap = m.capacity(x.shape[0])
        for e in range(m.num_experts):
            up, _ = m.expert(e)
            rows = x[idx == e][:cap]
            n = rows.shape[0]
            rows_by_expert[f'{b}/{e}'] = n
            if n == 0:
                continue
            ones = torch.ones((n, 1), device=x.device)
            with torch.no_grad():
                h = F.gelu(up(rows), approximate='tanh')
            for side, r in (('up', rows), ('down', h)):
                r = torch.cat([r, ones], 1)
                want = r.T @ r / n
                got = stats.a[f'{b}/moe/expert{e}_{side}']
                worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return dict(max_rel_err=worst, tol=1e-5, rows_by_expert=rows_by_expert, passed=worst <= 1e-5)


def card_vs_cpu(card, cpu) -> dict:
    """Step 0's capture on the card against the CPU's (plain versions),
    from the same weights and batch: the routings first (flips, token by
    token, each block), then, where none flipped, the loss (1e-4
    relative), the grads and the factors (1e-3 of their max)."""
    c_loss, c_grads, c_stats, _, c_index = card
    h_loss, h_grads, h_stats, _, h_index = cpu
    flips = {b: int((c_index[b].cpu() != h_index[b]).sum()) for b in MOE_BLOCKS}
    out = dict(routing_flips=flips)
    if any(flips.values()):
        out.update(compared=False, passed=True)
        return out
    loss_err = abs(c_loss - h_loss) / abs(h_loss)
    scale = max(float(g.abs().max()) for g in h_grads.values())
    grad_err = max(float((c_grads[n].cpu() - g).abs().max()) for n, g in h_grads.items()) / scale
    factor_err = max(
        float((getattr(c_stats, side)[n].cpu() - f).abs().max() / f.abs().max())
        for side in ('a', 'g') for n, f in getattr(h_stats, side).items() if f.abs().max() > 0
    )
    weight_err = max(
        abs(float(c_stats.w[n]) - float(w)) for n, w in h_stats.w.items()
    )
    out.update(
        compared=True, loss_rel_err=loss_err, loss_tol=1e-4, grad_err_rel_to_max=grad_err,
        grad_tol=1e-3, factor_err_rel_to_max=factor_err, factor_tol=1e-3,
        weight_abs_err=weight_err, passed=(
            loss_err <= 1e-4 and grad_err <= 1e-3 and factor_err <= 1e-3 and weight_err <= 1e-6
        ),
    )
    return out


def starved_factors(run) -> dict:
    """Host copies of the starved experts' factors."""
    names = [f'{b.replace(".", "/")}/expert{e}_{s}' for b, e in MOE['starved'] for s in ('up', 'down')]
    return {(side, n): getattr(run.kstate, side)[n].detach().cpu().clone()
            for side in ('a', 'g') for n in names}


def moe_dense_run(launches) -> dict:
    """(a) The dense engine, EIGEN, cadence 10/100, 21 steps through
    ``Trainer.step``: losses, step ms and host syncs by kind, launches,
    peak memory, the factor bytes, the starved expert's factors after
    every step bitwise its identity start."""
    wrappers = main_path_wrappers()
    dev = torch.device('cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = LMRun(FLAGSHIP, dev, 10, 100, moe=MOE)
    start = starved_factors(run)
    zero_counts(wrappers)
    losses, seconds, syncs, starved_moved = [], [], [], []
    for i in range(MOE_STEPS):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
        now = starved_factors(run)
        starved_moved += [f'{k[0]}/{k[1]}@{i}' for k, v in now.items() if not torch.equal(v, start[k])]
    counts = count_into(launches, wrappers)
    expected = moe_expected(MOE_STEPS, len(range(0, MOE_STEPS, 10)))
    memory = run.kfac.memory_usage(run.kstate)
    factor_bytes = sum(
        f.numel() * f.element_size() for side in ('a', 'g') for f in getattr(run.kstate, side).values()
    )
    kinds = step_kinds(seconds, syncs, 10, 100)
    out = dict(
        losses=losses, finite=all(math.isfinite(x) for x in losses), loss_falls=losses[-1] < losses[0],
        registered_layers=len(run.registry), expected_layers=MOE_LAYERS,
        routed_layers=sum(h.weighted for h in run.registry.layers.values()),
        step_ms=[s * 1e3 for s in seconds], step_kinds=kinds,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        factor_bytes=factor_bytes, expected_factor_bytes=4 * MOE_FACTOR_ELEMENTS,
        memory_usage=memory, starved_factors_moved=starved_moved,
        launches=counts, expected_launches=expected,
    )
    out['passed'] = (
        out['finite'] and out['loss_falls'] and out['registered_layers'] == MOE_LAYERS
        and out['routed_layers'] == 24 and factor_bytes == 4 * MOE_FACTOR_ELEMENTS
        and not starved_moved and counts == expected
        and all(kinds[k]['syncs_max'] == 0 for k in ('capture', 'plain'))
    )
    # after the counted run: a plain and a capture step under torch.profiler,
    # then the refresh alone (57 eighs, 30 of them at d = 2048 or 2049), twice
    out['profile'] = [profile_step(run, MOE_STEPS), profile_step(run, MOE_STEPS + 1)]
    out['refresh_alone_ms'] = [synced(lambda: run.kfac.update_inverses(run.kstate))[1] * 1e3
                               for _ in range(2)]
    del run
    torch.cuda.empty_cache()
    return out


def moe_reference() -> dict:
    """(b) Step 0's capture on the card (kernels) and on the CPU (plain
    versions) from the same weights, and each routed expert's factors on
    the card against its oracle."""
    card_run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100, moe=MOE)
    card = moe_capture(card_run)
    oracle = expert_oracle(card_run, card[2], card[3], card[4])
    del card_run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = moe_capture(LMRun(FLAGSHIP, torch.device('cpu'), 10, 100, moe=MOE))
    out = dict(cpu=card_vs_cpu(card, cpu), cpu_capture_seconds=time.perf_counter() - t0,
               oracle=oracle)
    out['passed'] = out['cpu']['passed'] and oracle['passed']
    return out


def moe_dense_dispatch(launches) -> dict:
    """(c) The dense masked dispatch, 3 steps, against the capacity
    dispatch at C = T (capacity factor = E, nothing drops) from the same
    weights: step 0's loss (1e-5 relative) and its preconditioned grads
    (1e-3 of their max)."""
    wrappers = main_path_wrappers()
    dev = torch.device('cuda')
    zero_counts(wrappers)
    dense = LMRun(FLAGSHIP, dev, 10, 100, moe=dict(MOE, capacity_factor=None))
    losses, grads, seconds = train(dense, MOE_DENSE_STEPS, grads=True)
    counts = count_into(launches, wrappers)
    del dense
    full = LMRun(FLAGSHIP, dev, 10, 100, moe=dict(MOE, capacity_factor=float(MOE['experts'])))
    (full_loss,), (full_grads,), _ = train(full, 1, grads=True)
    del full
    torch.cuda.empty_cache()
    loss_err = abs(losses[0] - full_loss) / abs(full_loss)
    scale = max(float(g.abs().max()) for g in full_grads.values())
    grad_err = max(float((grads[0][n] - g).abs().max()) for n, g in full_grads.items()) / scale
    expected = moe_expected(MOE_DENSE_STEPS, 1)
    return dict(
        losses=losses, step_ms=[s * 1e3 for s in seconds], capacity_e_loss=full_loss,
        loss_rel_err=loss_err, loss_tol=1e-5, pgrad_err_rel_to_max=grad_err, pgrad_tol=1e-3,
        launches=counts, expected_launches=expected,
        passed=(all(math.isfinite(x) for x in losses) and loss_err <= 1e-5 and grad_err <= 1e-3
                and counts == expected),
    )


def moe_kaisa_rank(rank: int, world: int, device: torch.device, frac: float) -> dict:
    """One NCCL rank: the MoE flagship on a ``DistributedKFAC`` (EIGEN,
    cadence 10/100) through ``Trainer.step`` on the global batch, 11 steps,
    counts set to 0 just before and read just after, host syncs counted."""
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa_mesh
    from kfac_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = LMRun(FLAGSHIP, device, 10, 100, moe=MOE)
    engine = DistributedKFAC(run.kfac, kaisa_mesh(frac, device=device))
    model = run.trainer.model
    run.trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), run.trainer.loss_fn,
        kfac=engine, device=device,
    )
    run.state = run.trainer.init()
    start = starved_factors_dist(engine, run.state.kfac_state)
    wrappers = main_path_wrappers()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts(wrappers)
    losses, seconds, syncs = [], [], []
    for _ in range(MOE_KAISA_STEPS):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
    launches = {n: w.launches for n, w in wrappers.items()}
    end = starved_factors_dist(engine, run.state.kfac_state)
    return dict(
        rank=rank, frac=frac, strategy=engine.strategy.name, losses=losses,
        step_ms=[s * 1e3 for s in seconds], step_kinds=step_kinds(seconds, syncs, 10, 100),
        launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        starved_bitwise=all(torch.equal(start[k], end[k]) for k in start),
        param_digest=param_digest(model),
    )


def starved_factors_dist(engine, state) -> dict:
    """This rank's copies of the starved experts' factor slots (those in
    its factor block)."""
    names = {f'{b.replace(".", "/")}/expert{e}_{s}' for b, e in MOE['starved'] for s in ('up', 'down')}
    out = {}
    for side, store in (('a', engine.a_store), ('g', engine.g_store)):
        for sb in store:
            lo, hi = engine._factor_range(sb.padded)
            for i in range(lo, min(hi, len(sb.layers))):
                if sb.layers[i] in names:
                    out[side, sb.layers[i]] = getattr(state, side)[sb.key][i - lo].detach().cpu().clone()
    return out


def moe_kaisa(launches, dense_losses) -> dict:
    """(d) ``DistributedKFAC`` over NCCL, one rank a card: COMM-OPT on one
    card (losses within 1e-4 of the dense engine's), MEM-OPT on four (each
    rank routes its own 4 rows at its own capacity, as a switch
    Transformer's data-parallel ranks do, so the losses differ from the
    dense engine's: finite and falling)."""
    from kfac_tpu_torch.parallel import spawn_world

    world = torch.cuda.device_count()
    frac = 1.0 if world == 1 else 1.0 / world
    t0 = time.perf_counter()
    rows = spawn_world(moe_kaisa_rank, world, 'nccl', 'cuda', args=(frac,), timeout_s=600)
    r0 = rows[0]
    expected = moe_expected(MOE_KAISA_STEPS, len(range(0, MOE_KAISA_STEPS, 10)))
    for name, count in r0['launches'].items():
        launches[name] = launches.get(name, 0) + count
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0['losses'], dense_losses)) if world == 1 else None
    out = dict(
        world=world, frac=frac, strategy=r0['strategy'], losses=r0['losses'],
        dense_losses=dense_losses[:MOE_KAISA_STEPS], loss_rel_err=loss_err,
        loss_tol=1e-4 if world == 1 else None,
        step_kinds_by_rank=[r['step_kinds'] for r in rows],
        peak_memory_by_rank=[r['peak_memory_bytes'] for r in rows],
        launches_by_rank=[r['launches'] for r in rows], expected_launches=expected,
        starved_bitwise_by_rank=[r['starved_bitwise'] for r in rows],
        params_identical_on_every_rank=len({r['param_digest'] for r in rows}) == 1,
        spawn_seconds=time.perf_counter() - t0,
    )
    out['passed'] = (
        all(math.isfinite(x) for x in r0['losses']) and r0['losses'][-1] < r0['losses'][0]
        and (world > 1 or loss_err <= 1e-4)
        and out['params_identical_on_every_rank'] and all(out['starved_bitwise_by_rank'])
        and all({n: r['launches'][n] for n in expected} == expected for r in rows)
        and all(r['step_kinds'][k]['syncs_max'] == 0 for r in rows for k in ('capture', 'plain'))
    )
    return out


def run_moe(launches) -> bool:
    """The switch-MoE flagship (``MOE``) at full width: (a) the dense
    engine, (b) step 0 against the CPU and the per-expert oracle, (c) the
    dense masked dispatch against capacity = E, (d) ``DistributedKFAC``.
    One line each."""
    ok = True
    dense = moe_dense_run(launches)
    emit(dict(phase='moe', part='a_dense_engine', config=dict(FLAGSHIP, **MOE), steps=MOE_STEPS,
              cadence=[10, 100], **dense))
    ok &= dense['passed']
    for part, fn, args in (
        ('b_reference', moe_reference, ()),
        ('c_dense_dispatch', moe_dense_dispatch, (launches,)),
        ('d_kaisa', moe_kaisa, (launches, dense['losses'])),
    ):
        try:
            out = fn(*args)
        except Exception:  # report the part's failure and go on to the next
            traceback.print_exc()
            out = dict(passed=False, error=traceback.format_exc(limit=3))
        emit(dict(phase='moe', part=part, **out))
        ok &= out['passed']
        torch.cuda.empty_cache()
    return ok


def run_lora(launches) -> bool:
    """The ``lora_finetune`` gate on the card (``kfac_tpu_torch.
    bench_accuracy``): pretraining with SGD, then 300 K-FAC steps over the
    LoRA units and the head must reach a loss of 0.2 (the median of the
    last 50 batch losses); launches exact. Then
    the same run on the CPU (plain versions) from the same seed: the
    pretraining's last loss and the fine-tune's first ``LORA_COMPARED``
    losses within 1e-4 relative of the card's."""
    import contextlib

    from kfac_tpu_torch import bench_accuracy
    from kfac_tpu_torch.examples import finetune_lora

    wrappers = main_path_wrappers()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # its own lines
        gate = bench_accuracy.run_task('cuda', seed=0, name='lora_finetune')
    seconds = time.perf_counter() - t0
    counts = count_into(launches, wrappers)
    expected = dict(
        sym_cov=LORA_COVS_A_STEP * LORA_STEPS, sym_cov_ema=0, klclip_dot=LORA_STEPS,
        klclip_dot_norms=0, klclip_scale=LORA_STEPS, flash_attention_partials=0, fused_ns_step=0,
    )
    runs = {dev: finetune_lora.run(finetune_lora.parse_args(['--device', dev])) for dev in ('cuda', 'cpu')}
    card, cpu = runs['cuda'], runs['cpu']
    pairs = [(card['pretrain_loss'], cpu['pretrain_loss'])] + list(
        zip(card['losses'][:LORA_COMPARED], cpu['losses'][:LORA_COMPARED]))
    err = max(abs(a - b) / abs(b) for a, b in pairs)
    passed = gate['passed'] and counts == expected and err <= 1e-4
    emit(dict(
        phase='lora', gate=gate, seconds=seconds, launches=counts, expected_launches=expected,
        cpu=dict(pretrain_loss=cpu['pretrain_loss'], final_loss=cpu['losses'][-1],
                 accuracy=cpu['accuracy'], compared_losses=LORA_COMPARED, loss_rel_err=err,
                 loss_tol=1e-4),
        card=dict(pretrain_loss=card['pretrain_loss'], final_loss=card['losses'][-1],
                  accuracy=card['accuracy'], losses=card['losses']),
        passed=passed,
    ))
    return passed


BENCH_WINDOW = dict(warmup=5, iters=25, scan_steps=25)
# the probe's warm call and its 9 timed calls, before its profiled passes
PROBE_TIMED_CALLS = 10
PROBE_FAMILIES = ('cov_ema', 'ns', 'klclip')
# the compression probe: its MLP's K-FAC layers, the steps of each wire
# (one untimed and ten timed) and of its offload Trainer
COMP_PROBE_LAYERS = 3
COMP_PROBE_STEPS = 11
COMP_PROBE_OFFLOAD_STEPS = 24
# the keys of the bench's _compression_probe
COMP_PROBE_KEYS = {
    'compression_probe_config', 'wire_ratio_int8', 'stat_wire_bytes_f32', 'stat_wire_bytes_int8',
    'step_p50_ms_f32_wire', 'step_p50_ms_int8_wire', 'offload',
}
# the keys of the bench's _async_spike_probe
SPIKE_PROBE_KEYS = {'async_probe_config'} | {
    f'{k}{s}' for k in ('step_p50_ms', 'step_p95_ms', 'step_max_ms', 'refresh_spike_ratio')
    for s in ('', '_sync')
}


def expected_bench_launches(cfg: dict, window: dict, probe_calls: int) -> dict:
    """Launches of every kernel over one ``bench_lm`` stage, from its
    configuration: SGD and eager K-FAC over ``warmup + iters`` steps, two
    ``scan_steps`` calls, the bench's factor cadence of 10, six K-FAC
    layers a block; the fused-kernel probe calls each fused kernel
    ``probe_calls`` times (EIGEN runs no Newton-Schulz); the async spike
    probe runs its MLP twice (sync, sliced) over a warm window and step and
    three timed windows, capturing every ``PROBE_WINDOW`` steps."""
    eager = window['warmup'] + window['iters']
    scan = 2 * window['scan_steps']
    captures = len(range(0, eager, 10)) + len(range(0, scan, 10))
    kfac_layers = 6 * cfg['layers']
    spike_steps = PROBE_WINDOW * 4 + 1
    spike_captures = len(range(0, spike_steps, PROBE_WINDOW))
    # the compression probe: its two wires' steps (cadence 1/1) and its
    # offload Trainer's (cadence 8/8), over its MLP's three layers
    comp_steps = 2 * COMP_PROBE_STEPS + COMP_PROBE_OFFLOAD_STEPS
    comp_captures = 2 * COMP_PROBE_STEPS + len(range(0, COMP_PROBE_OFFLOAD_STEPS, 8))
    return {
        'sym_cov': (2 * kfac_layers * captures + 2 * 2 * PROBE_LAYERS * spike_captures
                    + 2 * COMP_PROBE_LAYERS * comp_captures),
        'sym_cov_ema': probe_calls,
        'klclip_dot': eager + scan + probe_calls + 2 * spike_steps + comp_steps,
        'klclip_dot_norms': 0,
        'klclip_scale': eager + scan + probe_calls + 2 * spike_steps + comp_steps,
        'flash_attention_partials': cfg['layers'] * (2 * eager + scan),
        'fused_ns_step': probe_calls,
    }


def run_bench_lm(launches, records=None) -> bool:
    """The bench's LM stage in process, ``tiny`` then ``flagship``, in f32
    (the bench's dtype on a card is bf16: the ``amp`` phase runs that), each
    with the kernels' counts set to 0 just before and read just after;
    ``records`` takes each config's record."""
    from kfac_tpu_torch import bench_lm

    wrappers = main_path_wrappers()
    ok = True
    for config in ('tiny', 'flagship'):
        for w in wrappers.values():
            w.launches = 0
        record = bench_lm.run_lm_stage(config, 'cuda', **BENCH_WINDOW, dtype=torch.float32)
        if records is not None:
            records[config] = record
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
            and set(record['async_spike_probe']) == SPIKE_PROBE_KEYS
            and all(math.isfinite(v) and v > 0 for k, v in record['async_spike_probe'].items()
                    if k != 'async_probe_config')
            and set(record['compression_probe']) == COMP_PROBE_KEYS
            and record['compression_probe']['wire_ratio_int8'] >= 3.0
            and record['compression_probe']['offload']['prefetch_hit_rate'] == 1.0
        )
        emit(dict(
            phase='bench_lm', config=config, async_spike_probe=record['async_spike_probe'],
            compression_probe=record['compression_probe'], record=record, launches=counts,
            expected_launches=expected, profile=profiles, passed=passed,
        ))
        ok &= passed
    return ok


# ------------------------------------------------------------------ amp

AMP_STORE_STEPS = 3  # (b): cadence 1/2, captures at 0, 1, 2 and refreshes at 0 and 2
AMP_F16_STEPS = 2  # (b): the f16 flagship, a capture and refresh, then a capture
# (c): the contract of the JAX package's slow test (tests/test_amp.py:44-70)
AMP_EXAMPLE_ARGS = ['--steps', '40', '--batch-size', '32', '--init-scale', str(2.0**24),
                    '--growth-interval', '1000']
AMP_BENCH_WINDOW = dict(warmup=3, iters=10, scan_steps=10)
AMP_TURNS = 5  # (a): rounds of f32, bf16, bf16, f32 plain steps


def reset_counts(wrappers) -> None:
    """Every wrapper's counts to 0, each form's too."""
    from kfac_tpu_torch.ops import build

    for w in wrappers.values():
        if hasattr(w, 'launches_by_dtype'):
            build.reset_counts(w)
        else:
            w.launches = 0


def counts_by_form(wrappers) -> dict:
    """Launches by kernel form: ``name`` (f32), ``name_bf16``, ``name_f16``."""
    out = {}
    for n, w in wrappers.items():
        by = getattr(w, 'launches_by_dtype', None)
        if by is None:
            out[n] = w.launches
            continue
        out[n] = by.get(torch.float32, 0)
        for dt, tag in HALF_NAMES.items():
            out[f'{n}_{tag}'] = by.get(dt, 0)
    return out


def amp_expected(steps: int, captures: int, model_dtype, factor_dtype) -> dict:
    """``expected_launches`` by form: the flash partials in the model's
    dtype, ``sym_cov`` in the factor dtype (the capture casts a and g to
    it), the kl-clip kernels in f32 (the grads are f32 masters')."""
    base = dict(expected_launches(steps, captures), fused_ns_step=0)
    out = {k: v for k, v in base.items() if k not in ('sym_cov', 'flash_attention_partials')}
    for name, dt in (('sym_cov', factor_dtype), ('flash_attention_partials', model_dtype)):
        out[name] = base[name] if dt == torch.float32 else 0
        for d16, tag in HALF_NAMES.items():
            out[f'{name}_{tag}'] = base[name] if dt == d16 else 0
    for tag in HALF_NAMES.values():  # no path blends a 16-bit covariance
        out[f'sym_cov_ema_{tag}'] = 0
    return out


def amp_run(run, steps, wrappers) -> dict:
    """``steps`` counted steps of ``run`` from counts at 0: losses, step ms
    and host syncs by kind, peak memory, the counts by form."""
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, syncs = [], [], []
    for _ in range(steps):
        loss, sec, n = counted_step(run)
        losses.append(loss)
        seconds.append(sec)
        syncs.append(n)
    return dict(
        losses=losses, seconds=seconds, syncs=syncs, launches=counts_by_form(wrappers),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
    )


def amp_card_vs_cpu() -> dict:
    """Step 0's loss and grads of the bf16 flagship (no K-FAC step) on the
    card and on the CPU from the same weights and batch: the loss within 2u
    and the grads within 8u of their max (u = 2^-8). The parts of the gap:
    the card's loss again with attention through the einsum form (the CPU
    path: q * scale rounded to bf16, p rounded at the row's max), so that
    ``loss_gap_attention`` is the kernel's function against the einsum
    form's on the card, and ``loss_gap_other`` the rest (cuBLAS against the
    CPU's bf16 GEMMs and elementwise roundings)."""
    from kfac_tpu_torch.layers import capture
    from kfac_tpu_torch.models import lm_loss
    from kfac_tpu_torch.ops import flash_attention

    out = {}
    for dev in (torch.device('cuda'), torch.device('cpu')):
        # LMRun's weights and batch
        model = lm_model(FLAGSHIP, dev, dtype=torch.bfloat16)
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, FLAGSHIP['vocab'], (FLAGSHIP['batch'], FLAGSHIP['seq']), generator=gen)
        batch = (tokens.to(dev), torch.roll(tokens, -1, dims=1).to(dev))
        loss, grads = capture.value_and_grad(model, lm_loss(model))(batch)
        out[dev.type] = (float(loss), {n: g.float().cpu() for n, g in grads.items()})
        if dev.type == 'cuda':
            kernel = flash_attention._flash_partials_kernel
            flash_attention._flash_partials_kernel = flash_attention.attend_partials_einsum
            try:
                with torch.no_grad():
                    out['einsum'] = float(lm_loss(model)(batch))
            finally:
                flash_attention._flash_partials_kernel = kernel
    u = HALF_U[torch.bfloat16]
    (c_loss, c_grads), (h_loss, h_grads) = out['cuda'], out['cpu']
    scale = max(float(g.abs().max()) for g in h_grads.values())
    grad_err = max(float((c_grads[n] - g).abs().max()) for n, g in h_grads.items()) / scale
    loss_err = abs(c_loss - h_loss) / abs(h_loss)
    return dict(
        loss_card=c_loss, loss_cpu=h_loss, loss_rel_err=loss_err, loss_tol=2 * u,
        grad_err_rel_to_max=grad_err, grad_tol=8 * u,
        loss_card_einsum_attention=out['einsum'],
        loss_gap_attention=abs(c_loss - out['einsum']) / abs(h_loss),
        loss_gap_other=abs(out['einsum'] - h_loss) / abs(h_loss),
        passed=loss_err <= 2 * u and grad_err <= 8 * u,
    )


def plain_steps_in_turns(runs: dict) -> dict:
    """Plain-step ms of each run of ``runs`` (name -> ``LMRun`` whose state
    is at a plain step), timed in turns (a, b, b, a) for ``AMP_TURNS``
    rounds from the same state each time, and one such step of each under
    torch.profiler: medians, device busy ms, idle share, launches."""
    first, second = list(runs)
    ms = {name: [] for name in runs}
    for _ in range(AMP_TURNS):
        for name in (first, second, second, first):
            run = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.trainer.step(run.state, run.batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, run in runs.items():
        prof = device_profile(lambda run=run: run.trainer.step(run.state, run.batch))
        out[name] = dict(
            plain_ms_median=statistics.median(ms[name]), plain_ms=ms[name],
            device_busy_ms=prof['device_busy_ms'], idle_share=prof['idle_share'],
            kernel_launches=prof['kernel_launches'],
        )
    return out


def amp_flagship(launches, f32_summary) -> dict:
    """(a): the bf16 flagship through ``Trainer.step`` (EIGEN, cadence
    10/100, f32 factors), ``STEPS`` steps; after the counted run, its plain
    step and the f32 flagship's from the same weights in turns."""
    wrappers = main_path_wrappers()
    run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100, dtype=torch.bfloat16)
    r = amp_run(run, STEPS, wrappers)
    for n, c in r['launches'].items():
        launches[n] = launches.get(n, 0) + c
    expected = amp_expected(STEPS, len(range(0, STEPS, 10)), torch.bfloat16, torch.float32)
    kinds = step_kinds(r['seconds'], r['syncs'], 10, 100)
    run.step()  # step 20, a capture: the state is then at a plain step
    f32_run = LMRun(FLAGSHIP, torch.device('cuda'), 10, 100)
    f32_run.step()  # step 0, the refresh
    turns = plain_steps_in_turns({'float32': f32_run, 'bfloat16': run})
    del f32_run
    reference = amp_card_vs_cpu()
    usage = run.kfac.memory_usage(run.kstate)
    checks = dict(
        finite=all(math.isfinite(x) for x in r['losses']),
        falling=r['losses'][-1] < r['losses'][0],
        launches_exact=r['launches'] == expected,
        zero_syncs_plain_and_capture=all(
            kinds[k]['syncs_max'] == 0 for k in ('plain', 'capture') if k in kinds
        ),
        card_vs_cpu=reference['passed'],
    )
    return dict(
        part='a_bf16_flagship', config=FLAGSHIP, dtype='bfloat16', steps=STEPS,
        losses=r['losses'], step_ms=[x * 1e3 for x in r['seconds']], by_kind=kinds,
        f32_main_path_plain_step_ms_median=f32_summary.get('plain_step_ms_median'),
        plain_steps_in_turns=turns,
        peak_memory_gib=r['peak_memory_gib'], memory_usage=usage,
        launches=r['launches'], expected_launches=expected, card_vs_cpu=reference,
        checks=checks, passed=all(checks.values()),
    )


def amp_stores(launches, f32_usage) -> list[dict]:
    """(b): bf16 factors and decompositions (the bf16 flagship at cadence
    1/2, ``AMP_STORE_STEPS`` steps) on the dense engine and on a
    ``DistributedKFAC`` in a world of this process alone (NCCL), then the
    f16 flagship with f16 stores for ``AMP_F16_STEPS`` steps."""
    from kfac_tpu_torch import bench_lm

    wrappers = main_path_wrappers()
    half = dict(factor_dtype=torch.bfloat16, inv_dtype=torch.bfloat16)
    u = HALF_U[torch.bfloat16]
    run = LMRun(FLAGSHIP, torch.device('cuda'), 1, 2, dtype=torch.bfloat16, **half)
    dense = amp_run(run, AMP_STORE_STEPS, wrappers)
    usage = run.kfac.memory_usage(run.kstate)
    expected = amp_expected(AMP_STORE_STEPS, AMP_STORE_STEPS, torch.bfloat16, torch.bfloat16)
    with bench_lm.one_rank_world(torch.device('cuda')):
        dist_run = DistLMRun(torch.device('cuda'), 1, 2, dtype=torch.bfloat16, **half)
        dist = amp_run(dist_run, AMP_STORE_STEPS, wrappers)
        dist_usage = dist_run.kfac.memory_usage(dist_run.kstate)
        dist_comms = dist_run.kfac.comms_report()
    f16_run = LMRun(FLAGSHIP, torch.device('cuda'), 1, 2, dtype=torch.float16,
                    factor_dtype=torch.float16, inv_dtype=torch.float16)
    f16 = amp_run(f16_run, AMP_F16_STEPS, wrappers)
    f16_expected = amp_expected(AMP_F16_STEPS, AMP_F16_STEPS, torch.float16, torch.float16)
    for r in (dense, dist, f16):
        for n, c in r['launches'].items():
            launches[n] = launches.get(n, 0) + c
    dist_loss_err = max(
        abs(a - b) / abs(b) for a, b in zip(dist['losses'], dense['losses'])
    )
    lines = []
    checks = dict(
        finite=all(math.isfinite(x) for x in dense['losses'] + dist['losses']),
        launches_exact=dense['launches'] == expected and dist['launches'] == expected,
        factor_bytes_half=2 * usage['a_factors'] == f32_usage['a_factors']
        and 2 * usage['g_factors'] == f32_usage['g_factors'],
        decomposition_bytes_half=2 * usage['a_inverses'] == f32_usage['a_inverses']
        and 2 * usage['g_inverses'] == f32_usage['g_inverses'],
        kaisa_losses_within_2u=dist_loss_err <= 2 * u,
        stores_bf16=all(
            v.dtype == torch.bfloat16 for v in (*run.kstate.a.values(), *run.kstate.qa.values())
        ),
    )
    lines.append(dict(
        part='b_bf16_stores', steps=AMP_STORE_STEPS, capture_every=1, inv_every=2,
        dense=dict(losses=dense['losses'], step_ms=[x * 1e3 for x in dense['seconds']],
                   syncs=dense['syncs'], peak_memory_gib=dense['peak_memory_gib'],
                   memory_usage=usage, launches=dense['launches']),
        f32_memory_usage=f32_usage, expected_launches=expected,
        kaisa_w1=dict(losses=dist['losses'], step_ms=[x * 1e3 for x in dist['seconds']],
                      syncs=dist['syncs'], peak_memory_gib=dist['peak_memory_gib'],
                      memory_usage=dist_usage, launches=dist['launches'],
                      loss_rel_err_to_dense=dist_loss_err, loss_tol=2 * u,
                      stat_transport_bytes=dist_comms['stat_transport']['bytes'],
                      decomp_reshard_bytes=dist_comms['decomp_reshard_bytes']),
        checks=checks, passed=all(checks.values()),
    ))
    f16_checks = dict(
        finite=all(math.isfinite(x) for x in f16['losses']),
        launches_exact=f16['launches'] == f16_expected,
    )
    lines.append(dict(
        part='b_f16_stores', steps=AMP_F16_STEPS, losses=f16['losses'],
        step_ms=[x * 1e3 for x in f16['seconds']], syncs=f16['syncs'],
        launches=f16['launches'], expected_launches=f16_expected,
        checks=f16_checks, passed=all(f16_checks.values()),
    ))
    return lines


def amp_example(launches) -> dict:
    """(c): ``kfac_tpu_torch.examples.train_amp`` in f16 with the JAX slow
    test's contract: skipped >= 1, K-FAC steps = 40 - skipped, final loss
    < 2.3; each step's ms and host syncs, by whether it applied."""
    from kfac_tpu_torch.examples import train_amp

    wrappers = main_path_wrappers()
    reset_counts(wrappers)
    steps = []
    original = train_amp.amp_step

    def counted(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out = original(*args)
            finally:
                torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        syncs = sum('synchroniz' in str(w.message) for w in caught)
        steps.append(dict(applied=out[3], ms=(time.perf_counter() - t0) * 1e3, syncs=syncs))
        return out

    train_amp.amp_step = counted
    try:
        loss, skipped, kfac_steps = train_amp.main(AMP_EXAMPLE_ARGS)
    finally:
        train_amp.amp_step = original
    counts = counts_by_form(wrappers)
    for n, c in counts.items():
        launches[n] = launches.get(n, 0) + c
    applied = [s for s in steps if s['applied']]
    # the refresh (every 10th applied step) decomposes on the device
    plain = [s for i, s in enumerate(applied) if i % 10]
    checks = dict(
        skipped_at_least_one=skipped >= 1, kfac_steps_exact=kfac_steps == 40 - skipped,
        loss_below=math.isfinite(loss) and loss < 2.3,
    )
    return dict(
        part='c_train_amp_f16', args=AMP_EXAMPLE_ARGS, loss=loss, skipped=skipped,
        kfac_steps=kfac_steps, launches=counts,
        applied_step_ms_median=statistics.median(s['ms'] for s in plain) if plain else None,
        # the host reads of a step: the skip's bool, and a refresh's
        syncs_by_kind={
            kind: sorted({s['syncs'] for s in group})
            for kind, group in (('skipped', [s for s in steps if not s['applied']]),
                                ('applied', plain),
                                ('refresh', [s for i, s in enumerate(applied) if not i % 10]))
            if group
        },
        syncs=[s['syncs'] for s in steps], applied=[s['applied'] for s in steps],
        checks=checks, passed=all(checks.values()),
    )


def amp_bench(f32_record) -> dict:
    """(d): the bench's LM stage for the flagship in bf16 (the bench's own
    dtype on a card), MFU against the bf16 peak, beside the ``bench_lm``
    phase's f32 reading of the same call (a quarter window there; this at
    ``AMP_BENCH_WINDOW``, no probes)."""
    from kfac_tpu_torch import bench_lm

    record = bench_lm.run_lm_stage(
        'flagship', 'cuda', **AMP_BENCH_WINDOW, dtype=torch.bfloat16, probes=False
    )
    keys = ('sgd_tokens_per_sec', 'eager_tokens_per_sec', 'scan_tokens_per_sec', 'value',
            'vs_baseline', 'mfu', 'sgd_mfu')
    f32 = {k: f32_record.get(k) for k in keys + ('mfu_peak', 'window')} if f32_record else None
    checks = dict(
        rates=all(math.isfinite(record[k]) and record[k] > 0 for k in keys),
        bf16_peak=record['mfu_peak'] == bench_lm.PEAK_FLOPS[torch.bfloat16][1],
    )
    return dict(part='d_bench_lm_bf16', record=record, f32=f32, checks=checks,
                passed=all(checks.values()))


def run_amp(launches, f32_summary, bench_records) -> bool:
    """Mixed precision on the flagship: (a) the bf16 model, (b) bf16 and
    f16 stores on both engines, (c) the f16 loss-scaled example, (d) the
    bench's LM stage in bf16; one line each."""
    ok = True
    a = amp_flagship(launches, f32_summary)
    # (a)'s f32 stores are (b)'s comparison: the store sizes do not depend
    # on the cadence
    for line in [a, *amp_stores(launches, a['memory_usage']), amp_example(launches),
                 amp_bench(bench_records.get('flagship'))]:
        emit(dict(phase='amp', **line))
        ok &= line['passed']
    return ok


# ------------------------------------------------------------------ tp_sp

TP_SP_CAPTURE = 2  # factor cadence: captures at 0, 2, 4 and 6
TP_SP_REFRESH = 6  # inverse cadence: refreshes at 0 and 6 (NS: cold, then warm)
TP_SP_STEPS = 8  # plain steps 1, 3, 5 and 7
# the ring schedules the flash partials are held at: (kind, seq shards,
# heads a rank), the heads of a model-2 rank beside seq 2 and of a whole
# layer beside seq 4 (the four-card layouts' shards)
TP_SP_RINGS = (('ring', 2, 2), ('ring', 4, 4), ('zigzag', 2, 2), ('zigzag', 4, 4))
# the four-card layouts: (a) TP x SP with the ring, (b) SP with the zigzag
# ring, (c) DP x TP at fractions 1 and 0.5, (d) (a) under INVERSE +
# Newton-Schulz
TP_SP_JOBS = (
    dict(name='a_model2_seq2_ring', frac=1.0, model=2, seq=2, kfac={}),
    dict(name='b_seq4_zigzag', frac=1.0, seq=4, zigzag=True, kfac={}),
    dict(name='c_dp2_model2_frac1', frac=1.0, model=2, kfac={}),
    dict(name='c_dp2_model2_frac0.5', frac=0.5, model=2, kfac={}),
    dict(name='d_model2_seq2_ring_ns', frac=1.0, model=2, seq=2, kfac=INVERSE_NS),
)


def ring_schedules(kind: str, n: int, seq: int):
    """Every shard's schedule of a ring of ``n`` over ``seq`` positions,
    with its shards' global positions."""
    from kfac_tpu_torch.models import attention
    from kfac_tpu_torch.parallel import mesh

    make = attention.zigzag_schedule if kind == 'zigzag' else attention.ring_schedule
    return [(make(n, my, seq // n), mesh.shard_positions(seq, n, my, zigzag=kind == 'zigzag'))
            for my in range(n)]


def flash_ring_triples() -> dict:
    """{(s_q, s_k, heads, q_offset, k_offset): the rings that call it} at
    flagship width, every attend of every shard of every ring."""
    out: dict = {}
    for kind, n, heads in TP_SP_RINGS:
        for sched, _ in ring_schedules(kind, n, FLAGSHIP['seq']):
            for attends in sched.attends:
                for at in attends:
                    key = (at.q_rows[1] - at.q_rows[0], at.k_rows[1] - at.k_rows[0], heads,
                           at.q_offset, at.k_offset)
                    out.setdefault(key, set()).add(f'{kind}{n}')
    return out


def visible_pairs(s_q, s_k, q_off, k_off) -> int:
    """(query, key) pairs a causal attend at these offsets computes."""
    q = torch.arange(s_q)[:, None] + q_off
    k = torch.arange(s_k)[None, :] + k_off
    return int((q >= k).sum())


def flash_ring_checks(results) -> dict:
    """The flash partials at every ring triple against the plain version
    (1e-5 x max of each of acc, m and l) with the TF32 control outside it;
    of each shape, the diagonal triple and the one with the most visible
    pairs timed beside the plain and library calls, those rows added to the
    kernel results."""
    from kfac_tpu_torch.ops import flash_attention

    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(3)
    b, dh = FLAGSHIP['batch'], 128
    triples = flash_ring_triples()
    timed_triples = set()
    for shape in {key[:3] for key in triples}:
        same = [key for key in triples if key[:3] == shape]
        timed_triples.add(min(same, key=lambda t: abs(t[3] - t[4])))  # on the diagonal
        timed_triples.add(max(same, key=lambda t: visible_pairs(*t[:2], *t[3:])))
    rows = []
    for (s_q, s_k, h, qo, ko), rings in sorted(triples.items()):
        q = torch.randn(b, s_q, h, dh, generator=gen, device=dev)
        k, v = (torch.randn(b, s_k, h, dh, generator=gen, device=dev) for _ in range(2))
        got = flash_attention.flash_attention_partials(q, k, v, qo, ko, True)
        want = flash_attention.attend_partials_einsum(q, k, v, qo, ko, True)
        err, ref = max(map(max_err, got, want), key=lambda p: p[0] / p[1])
        ctrl = tf32(lambda: flash_attention.attend_partials_einsum(q, k, v, qo, ko, True))()
        c_err, c_ref = max(map(max_err, ctrl, want), key=lambda p: p[0] / p[1])
        row = dict(shape=[b, s_q, h, dh], s_k=s_k, q_offset=qo, k_offset=ko, rings=sorted(rings),
                   max_abs_err=err, max_rel_err=err / ref, control_max_rel_err=c_err / c_ref)
        row['passed'] = err <= 1e-5 * ref and c_err > 1e-5 * c_ref
        rows.append(row)
        if (s_q, s_k, h, qo, ko) not in timed_triples:
            continue
        mask = (torch.arange(s_q, device=dev)[:, None] + qo) >= (torch.arange(s_k, device=dev)[None] + ko)

        def sdpa(q=q, k=k, v=v, mask=mask):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask
            )

        pairs = visible_pairs(s_q, s_k, qo, ko)
        ms = time_ms(lambda: flash_attention.flash_attention_partials(q, k, v, qo, ko, True))
        bms, by = bound_ms(
            4 * (2 * b * s_q * h * dh + 2 * b * s_k * h * dh + 2 * b * h * s_q),
            3 * 4 * dh * pairs * b * h, TF32_FLOPS_PER_S,
        )
        timed = dict(
            phase='kernel', name='flash_attention_partials', shape=[b, s_q, h, dh],
            s_k=s_k, q_offset=qo, k_offset=ko, max_abs_err=err, max_rel_err=err / ref,
            tol=1e-5 * ref, tol_rule='1e-5 x max|x| for each of acc, m, l',
            control_rule='plain version with TF32 matmuls', control_max_rel_err=c_err / c_ref,
            rejects_control=c_err > 1e-5 * c_ref, passed=row['passed'], ms=ms,
            plain_ms=time_ms(lambda: flash_attention.attend_partials_einsum(q, k, v, qo, ko, True)),
            library_ms=time_ms(sdpa), library_call='scaled_dot_product_attention with the causal mask',
            bound_ms=bms, bound_by=by, bound_share=bms / ms, visible_pairs=pairs,
        )
        emit(timed)
        results.append(timed)
    return dict(triples=len(rows), passed=all(r['passed'] for r in rows),
                worst_rel_err=max(r['max_rel_err'] for r in rows),
                least_control_rel_err=min(r['control_max_rel_err'] for r in rows),
                failed=[r for r in rows if not r['passed']])


def ring_composition(kind: str, n: int, heads: int) -> dict:
    """Every shard's schedule of one ring driven in one process from the
    flash partials on the card (each step's K/V block sliced from the
    whole sequence), the output and its input grads against dense causal
    attention (the plain partials over the whole sequence) on the same q,
    k, v; the TF32 control of the dense path outside the tolerance."""
    from kfac_tpu_torch.models import attention
    from kfac_tpu_torch.ops import flash_attention

    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(5)
    b, s, dh = FLAGSHIP['batch'], FLAGSHIP['seq'], 128
    q, k, v, dout = (torch.randn(b, s, heads, dh, generator=gen, device=dev) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    shards = ring_schedules(kind, n, s)
    outs = []
    for sched, pos in shards:
        qs, ks, vs = leaves
        outs.append(attention.run_schedule(
            qs[:, pos.to(dev)].contiguous(), sched,
            lambda i, sched=sched: tuple(
                x[:, shards[sched.sources[i]][1].to(dev)].contiguous() for x in (ks, vs)
            ),
        ))
    order = torch.cat([pos for _, pos in shards]).to(dev)
    out = torch.cat(outs, dim=1)[:, torch.argsort(order)]
    grads = torch.autograd.grad((out * dout).sum(), leaves)

    def dense(allow_tf32=False):
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            ref = attention._finish(flash_attention.attend_partials_einsum(*ref_leaves, 0, 0, True))
            return ref, torch.autograd.grad((ref * dout).sum(), ref_leaves)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    ref, ref_grads = dense()
    ctrl, ctrl_grads = dense(True)
    errs = [max_err(out, ref)] + [max_err(g, r) for g, r in zip(grads, ref_grads)]
    ctrl_errs = [max_err(ctrl, ref)] + [max_err(g, r) for g, r in zip(ctrl_grads, ref_grads)]
    rel = dict(zip(('out', 'dq', 'dk', 'dv'), (e / r for e, r in errs)))
    ctrl_rel = dict(zip(('out', 'dq', 'dk', 'dv'), (e / r for e, r in ctrl_errs)))
    return dict(
        ring=f'{kind}{n}', shape=[b, s, heads, dh], attends=sum(
            len(a) for sched, _ in shards for a in sched.attends),
        rel_err=rel, tol='1e-5 x max of each', control_rel_err=ctrl_rel,
        passed=all(x <= 1e-5 for x in rel.values()) and max(ctrl_rel.values()) > 1e-5,
    )


class CommCounter:
    """Counts the calls and the bytes this rank hands each
    ``torch.distributed`` collective (an all-reduce's buffer, an
    all-gather's input, the sends of a ``batch_isend_irecv``), by wrapping
    the module's functions while it is entered. Host work only."""

    OPS = ('all_reduce', 'all_gather', 'all_gather_into_tensor', 'reduce_scatter_tensor',
           'batch_isend_irecv')

    def __init__(self):
        self.counts: dict = {}

    def _add(self, op, nbytes):
        c = self.counts.setdefault(op, {'calls': 0, 'bytes': 0})
        c['calls'] += 1
        c['bytes'] += int(nbytes)

    def __enter__(self):
        import torch.distributed as dist

        self._saved = {op: getattr(dist, op) for op in self.OPS}

        def wrap(op, fn):
            def counted(*args, **kwargs):
                if op == 'batch_isend_irecv':
                    nbytes = sum(p.tensor.numel() * p.tensor.element_size() for p in args[0]
                                 if p.op is dist.isend)
                elif op == 'all_gather':
                    nbytes = args[1].numel() * args[1].element_size()
                elif op == 'all_reduce':
                    nbytes = args[0].numel() * args[0].element_size()
                else:
                    nbytes = args[1].numel() * args[1].element_size()
                self._add(op, nbytes)
                return fn(*args, **kwargs)
            return counted

        for op, fn in self._saved.items():
            setattr(dist, op, wrap(op, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for op, fn in self._saved.items():
            setattr(dist, op, fn)


def tp_sp_expected(job: dict, s: int, steps: int) -> dict:
    """A rank's launches over ``steps`` steps: ``sym_cov`` twice a K-FAC
    layer a capture (on gathered rows where a side is sharded), the
    grouped kl-clip dot and scale once a step, the flash partials once an
    attend a block a step (the ring at seq n: s + 1 on shard s; zigzag:
    2 n + 1; no seq axis: 1); no 2-D Newton-Schulz step."""
    n = job.get('seq', 1)
    attends = 2 * n + 1 if job.get('zigzag') else s + 1
    captures = len(range(0, steps, TP_SP_CAPTURE))
    return dict(
        expected_launches(steps, captures), fused_ns_step=0,
        flash_attention_partials=FLAGSHIP['layers'] * attends * steps,
    )


def tp_sp_rank(rank: int, world: int, device: torch.device, jobs: list, dense_path: str) -> list:
    """One NCCL rank of the tp_sp phase: each job's flagship through
    ``Trainer.step`` with a ``DistributedKFAC`` on a ``train_mesh`` (the
    rank takes its row block and sequence shard; the LM sharded by
    ``TRANSFORMER_TP_RULES``), counts set to 0 just before and read just
    after, host syncs and the collectives' bytes counted a step; the
    losses and gathered preconditioned grads held against the dense
    engine's run (``dense_path``) here."""
    import kfac_tpu_torch as kt
    from kfac_tpu_torch.models import TransformerLM, lm_loss
    from kfac_tpu_torch.parallel import DistributedKFAC, tensor_parallel, train_mesh
    from kfac_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = [  # every grid first: each creates process groups, in one order on every rank
        train_mesh(job['frac'], job.get('model', 1), job.get('seq', 1), device=device,
                   zigzag=job.get('zigzag', False))
        for job in jobs
    ]
    dense = torch.load(dense_path, map_location=device, weights_only=False)
    cfg = FLAGSHIP
    wrappers = kaisa_wrappers()
    out = []
    for job, grid in zip(jobs, grids):
        ring = dict(ring_mesh=grid, ring_axis='seq') if grid.seq > 1 else {}
        model = TransformerLM(
            vocab_size=cfg['vocab'], d_model=cfg['d_model'], num_heads=cfg['heads'],
            num_layers=cfg['layers'], max_len=cfg['seq'], seed=1, device=device, **ring,
        )
        tensor_parallel.shard_params(model, grid)
        reg = kt.register_model(model, skip_layers=['lm_head'], device=device)
        config = kt.KFACPreconditioner(
            reg, damping=0.003, lr=0.1, factor_update_steps=TP_SP_CAPTURE,
            inv_update_steps=TP_SP_REFRESH, device=device, **job['kfac'],
        )
        engine = DistributedKFAC(config, grid)
        loss = lm_loss(model)
        trainer = Trainer(
            model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            lambda ms, b: (loss(b), ms), kfac=engine, device=device,
        )
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg['vocab'], (cfg['batch'], cfg['seq']), generator=gen)
        run = dataclasses.make_dataclass('Run', ['trainer', 'state', 'batch'])(
            trainer, trainer.init(), (tokens.to(device), torch.roll(tokens, -1, dims=1).to(device)),
        )
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts(wrappers)
        losses, seconds, syncs, comms, residuals = [], [], [], [], []
        for i in range(TP_SP_STEPS):
            with CommCounter() as counter:
                value, sec, n = counted_step(run)
            losses.append(value)
            seconds.append(sec)
            syncs.append(n)
            comms.append(counter.counts)
            if job['kfac'] and i % TP_SP_REFRESH == 0:
                res = engine.inverse_residuals(run.state.kfac_state)
                residuals.append(max(float(r.max()) for side in res.values() for r in side.values()))
        launches = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(device)
        grads = tensor_parallel.gather_params(
            model, {n: p.grad for n, p in model.named_parameters()}
        )
        want_grads = dense[job['kfac'] and 'ns' or 'eigen']
        scale = max(float(g.abs().max()) for g in want_grads['grads'].values())
        grad_err = max(float((grads[n] - g).abs().max()) for n, g in want_grads['grads'].items()) / scale
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_grads['losses']))
        sharded = tensor_parallel.sharded_param_names(model)
        params = dict(model.named_parameters())
        live_solves = sum(
            engine._factor_range(sb.padded)[0] < len(sb.layers)
            for sb in engine.a_store + engine.g_store
        )
        memory = engine.memory_usage(run.state.kfac_state)
        kinds = {
            'refresh': [i for i in range(TP_SP_STEPS) if i % TP_SP_REFRESH == 0],
            'capture': [i for i in range(TP_SP_STEPS) if i % TP_SP_REFRESH and i % TP_SP_CAPTURE == 0],
            'plain': [i for i in range(TP_SP_STEPS) if i % TP_SP_CAPTURE],
        }
        out.append(dict(
            job=job['name'], rank=rank, coords=[grid.row, grid.col, grid.m, grid.s],
            strategy=engine.strategy.name, topology=engine.topology(),
            losses=losses, dense_losses=want_grads['losses'], loss_rel_err=loss_err,
            pgrad_err_rel_to_max=grad_err,
            step_ms={k: [seconds[i] * 1e3 for i in v] for k, v in kinds.items()},
            plain_step_ms_median=statistics.median(seconds[i] * 1e3 for i in kinds['plain']),
            syncs={k: [syncs[i] for i in v] for k, v in kinds.items()},
            comms_by_kind={k: comms[v[-1]] for k, v in kinds.items()},
            launches=launches, expected_launches=tp_sp_expected(job, grid.s, TP_SP_STEPS),
            live_stacked_solves=live_solves, max_independent_residual_by_refresh=residuals,
            peak_memory_bytes=peak,
            decomposition_bytes=memory['a_inverses'] + memory['g_inverses'],
            factor_bytes=memory['a_factors'] + memory['g_factors'],
            replicated_digest=param_digest_of({n: p for n, p in params.items() if n not in sharded}),
            sharded_digest=param_digest_of({n: p for n, p in params.items() if n in sharded}),
        ))
        del trainer, engine, model, run
        torch.cuda.empty_cache()
    return out


def param_digest_of(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(params.items()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_sp_dense_reference(kfac_kw: dict) -> dict:
    """The dense engine's losses and last preconditioned grads on one card
    from the same weights and global batch, the tp_sp cadence."""
    run = LMRun(FLAGSHIP, torch.device('cuda'), TP_SP_CAPTURE, TP_SP_REFRESH, **kfac_kw)
    losses, _, _ = train(run, TP_SP_STEPS)
    return dict(losses=losses, grads={n: g.cpu() for n, g in run.grads().items()})


def run_tp_sp(launches, results) -> bool:
    """Tensor and sequence parallelism (see the module's docstring, phase
    18): the flash partials at every ring offset and the rings composed on
    one card; on four cards the flagship in layouts (a)-(d) over NCCL."""
    from kfac_tpu_torch.ops import factors
    from kfac_tpu_torch.parallel import spawn_world

    cards = torch.cuda.device_count()
    flash = flash_ring_checks(results)
    emit(dict(phase='tp_sp', part='flash_ring_offsets', **flash))
    compositions = [ring_composition(kind, n, heads) for kind, n, heads in TP_SP_RINGS]
    ok = flash['passed'] and all(c['passed'] for c in compositions)
    emit(dict(phase='tp_sp', part='ring_composition', runs=compositions,
              passed=all(c['passed'] for c in compositions)))
    parts = ['flash_ring_offsets', 'ring_composition']
    if cards >= 4:
        dense = {'eigen': tp_sp_dense_reference({}), 'ns': tp_sp_dense_reference(INVERSE_NS)}
        path = os.path.join(tempfile.mkdtemp(prefix='tp_sp_'), 'dense.pt')
        torch.save(dense, path)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            results_by_rank = spawn_world(
                tp_sp_rank, 4, 'nccl', 'cuda', args=(list(TP_SP_JOBS), path), timeout_s=600
            )
        finally:
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        seconds = time.perf_counter() - t0
        for j, job in enumerate(TP_SP_JOBS):
            rows = [r[j] for r in results_by_rank]
            by_shard: dict = {}
            for r in rows:
                by_shard.setdefault(tuple(r['coords'][2:]), set()).add(r['sharded_digest'])
            launches_exact = all(
                {n: r['launches'][n] for n in r['expected_launches']} == r['expected_launches']
                for r in rows
            )
            refreshes = len(range(0, TP_SP_STEPS, TP_SP_REFRESH))
            ns_range = [
                [refreshes * r['live_stacked_solves'], refreshes * r['live_stacked_solves'] * 2 * 40]
                if job['kfac'] else [0, 0] for r in rows
            ]
            ns_inside = all(lo <= r['launches']['fused_ns_step_stacked'] <= hi
                            for r, (lo, hi) in zip(rows, ns_range))
            residual_ok = all(x <= factors.NS_FALLBACK_RESIDUAL
                              for r in rows for x in r['max_independent_residual_by_refresh'])
            checks = dict(
                losses=all(r['loss_rel_err'] <= 1e-4 for r in rows),
                pgrads=all(r['pgrad_err_rel_to_max'] <= 1e-3 for r in rows),
                finite_and_falling=all(
                    all(math.isfinite(x) for x in r['losses']) and r['losses'][-1] < r['losses'][0]
                    for r in rows),
                launches_exact=launches_exact, stacked_ns_inside=ns_inside,
                residuals=residual_ok,
                zero_syncs_plain_and_capture=all(
                    max(r['syncs']['capture'] + r['syncs']['plain']) == 0 for r in rows),
                replicated_bitwise_on_every_rank=len({r['replicated_digest'] for r in rows}) == 1,
                sharded_bitwise_across_dp=all(len(d) == 1 for d in by_shard.values()),
            )
            passed = all(checks.values())
            for name, count in rows[0]['launches'].items():
                launches[name] = launches.get(name, 0) + count
            emit(dict(
                phase='tp_sp', part=job['name'], world=4, backend='nccl', frac=job['frac'],
                model=job.get('model', 1), seq=job.get('seq', 1), zigzag=job.get('zigzag', False),
                kfac=job['kfac'] or 'default (EIGEN)', steps=TP_SP_STEPS,
                cadence=[TP_SP_CAPTURE, TP_SP_REFRESH], strategy=rows[0]['strategy'],
                topology=rows[0]['topology'], losses_rank0=rows[0]['losses'],
                dense_losses=rows[0]['dense_losses'], loss_tol=1e-4, pgrad_tol=1e-3,
                loss_rel_err_by_rank=[r['loss_rel_err'] for r in rows],
                pgrad_err_rel_to_max_by_rank=[r['pgrad_err_rel_to_max'] for r in rows],
                step_ms_by_rank=[r['step_ms'] for r in rows],
                plain_step_ms_median_by_rank=[r['plain_step_ms_median'] for r in rows],
                syncs_by_rank=[r['syncs'] for r in rows],
                peak_memory_by_rank=[r['peak_memory_bytes'] for r in rows],
                factor_bytes_by_rank=[r['factor_bytes'] for r in rows],
                decomposition_bytes_by_rank=[r['decomposition_bytes'] for r in rows],
                comms_by_rank=[r['comms_by_kind'] for r in rows],
                launches_by_rank=[r['launches'] for r in rows],
                expected_launches_by_rank=[r['expected_launches'] for r in rows],
                fused_ns_step_stacked_range=ns_range,
                max_independent_residual_by_refresh=[
                    r['max_independent_residual_by_refresh'] for r in rows],
                checks=checks, passed=passed,
            ))
            ok &= passed
            parts.append(job['name'])
        emit(dict(phase='tp_sp_world', world=4, jobs=len(TP_SP_JOBS), spawn_seconds=seconds))
    emit(dict(phase='tp_sp', cards=cards, parts=parts, passed=ok))
    return ok


SOURCES = {
    'sym_cov': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov.py:88', [8192, 2049]),
    'sym_cov_ema': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov_ema.py:110', [512, 256]),
    'klclip_dot': ('cuda', 'kfac_tpu_torch/csrc/klclip.cu', 'kfac_tpu/ops/pallas_ns.py:219', [KFAC_LAYERS, 18_902_016]),
    'klclip_dot_norms': ('cuda', 'kfac_tpu_torch/csrc/klclip.cu', 'kfac_tpu/ops/pallas_ns.py:219', [KFAC_LAYERS, 18_902_016]),
    'klclip_scale': ('cuda', 'kfac_tpu_torch/csrc/klclip.cu', 'kfac_tpu/ops/pallas_ns.py:244', [KFAC_LAYERS, 18_902_016]),
    'flash_attention_partials': ('cuda', 'kfac_tpu_torch/csrc/flash_attn.cu', 'kfac_tpu/ops/pallas_attention.py:257', [16, 512, 4, 128]),
    'fused_ns_step': ('cuda', 'kfac_tpu_torch/csrc/newton_schulz.cu', 'kfac_tpu/ops/pallas_ns.py:127,139', [2049, 2049]),
    # the largest block a rank solves on this machine's cards
    'fused_ns_step_stacked': ('cuda', 'kfac_tpu_torch/csrc/newton_schulz.cu', 'kfac_tpu/ops/pallas_ns.py:127,139', None),
    # the 16-bit forms: bf16 and f16 instantiations of the same sources
    **{f'sym_cov_{tag}': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu', 'kfac_tpu/ops/pallas_cov.py:88',
                          [8192, 2049]) for tag in ('bf16', 'f16')},
    **{f'flash_attention_partials_{tag}': (
        'cuda', 'kfac_tpu_torch/csrc/flash_attn.cu', 'kfac_tpu/ops/pallas_attention.py:257',
        [16, 512, 4, 128]) for tag in ('bf16', 'f16')},
    **{f'sym_cov_ema_{tag}': ('cuda', 'kfac_tpu_torch/csrc/sym_cov.cu',
                              'kfac_tpu/ops/pallas_cov_ema.py:110', [8192, 2049])
       for tag in ('bf16', 'f16')},
}


def kernels_line(results, launches) -> dict:
    """``launches`` per kernel is the sum over the main paths, each path's
    count beside it."""
    out = []
    for name, (route, source, replaces, shape) in SOURCES.items():
        rows = [r for r in results if r['name'] == name]
        if shape is None and rows:
            shape = max((r['shape'] for r in rows), key=lambda s: s[0] * s[-1] ** 3)
        row = next((r for r in rows if r['shape'] == shape), None)
        if row is None:
            continue
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        out.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r['max_abs_err'] for r in rows), shape=shape,
            shapes=[r['shape'] for r in rows],
            ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
            bound_by=row['bound_by'], bound_share=row['bound_share'],
            library_ms=row['library_ms'],
            **{k: row[k] for k in ('bound_f32_ms', 'bound_f32_share', 'device_ms',
                                   'library_device_ms', 'library_call') if k in row},
        ))
    return {'kernels': out}


def kernel_resources(log: str) -> dict[str, str]:
    """``{kernel<template args>: "registers, spills"}`` from ptxas's
    verbose output: each instantiation apart."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            sym = name = entry.group(1)
            # a mangled name is <length><identifier>...: find the kernel's,
            # then its template arguments (literal bools and ints)
            for m in re.finditer(r'(?=(\d+))', sym):  # each digit run and its suffixes
                end = m.start() + len(m.group(1))
                ident = sym[end:end + int(m.group(1))]
                if ident.endswith('kernel') and ident.isidentifier():
                    name = ident
                    args = re.match(r'I((?:L[bi]\d+E)+)E', sym[end + len(ident):])
                    if args:
                        name += '<' + ','.join(
                            {'b1': 'true', 'b0': 'false'}.get(t + v, v)
                            for t, v in re.findall(r'L([bi])(\d+)E', args.group(1))
                        ) + '>'
                    break
        elif name and ('registers' in line or 'spill' in line):
            out[name] = (out.get(name, '') + ' ' + line.split(':', 1)[-1].strip()).strip()
    return out


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kfac_tpu_torch.ops import build
    except ImportError as exc:
        print(f'chip_smoke: the kfac_tpu_torch package is missing: {exc}', file=sys.stderr)
        return 1

    # the spawned ranks share the host's cores: unless set already, each
    # rank's BLAS and OpenMP pools (numpy's LAPACK in the KAISA host
    # refresh) get its share, not every core each
    share = str(max(1, (os.cpu_count() or 1) // torch.cuda.device_count()))
    for pool in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ.setdefault(pool, share)
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
        path: {} for path in (
            'main_path', 'main_path_ns', 'digits_mlp', 'digits_cnn', 'observed', 'resume',
            'async_refresh', 'kaisa', 'kaisa_ops', 'resnet', 'bench_lm_tiny', 'bench_lm_flagship',
            'engine_knobs', 'moe', 'lora', 'tp_sp', 'amp',
        )
    }
    bench_records: dict = {}
    observed_health: dict = {}
    eigen_summary: dict = {}
    main_losses: list[float] = []
    main_tail: list[float] = []  # main_path's profiled steps 20 and 21
    main_snaps: dict = {}
    async_summary: dict = {}
    seconds: dict[str, float] = {}

    def phase(name, fn, *args):
        nonlocal ok
        t0 = time.perf_counter()
        try:
            passed = fn(*args)
        except Exception:  # report the phase's failure and go on to the next
            traceback.print_exc()
            emit(dict(phase=name, passed=False, error=traceback.format_exc(limit=3)))
            passed = False
        ok &= bool(passed)
        seconds[name] = time.perf_counter() - t0

    def do_build():
        t0 = time.perf_counter()
        report = build.build()
        ptxas = {n: kernel_resources(r['ptxas']) for n, r in report.items()}
        emit(dict(phase='build', seconds=time.perf_counter() - t0, ptxas=ptxas, passed=True))
        return True

    phase('build', do_build)
    phase('kernel', run_kernels, results)
    phase('reference', run_reference)
    phase('main_path', run_main_path, launches['main_path'], eigen_summary, main_losses, main_snaps,
          main_tail)
    phase('main_path_ns', run_main_path_ns, launches['main_path_ns'], eigen_summary)
    phase('digits_mlp', run_digits, launches['digits_mlp'])
    phase('digits_cnn', run_digits, launches['digits_cnn'], 'digits_cnn')
    phase('observed', run_observed, launches['observed'], main_losses, observed_health)
    phase('resume', run_resume, launches['resume'], main_losses, main_snaps)
    phase('async_refresh', run_async_refresh, launches['async_refresh'], torch.device('cuda'),
          async_summary)
    phase('kaisa', run_kaisa, launches['kaisa'])
    phase('kaisa_ops', run_kaisa_ops, launches['kaisa_ops'], observed_health)
    phase('resnet', run_resnet, launches['resnet'])
    phase('bench_lm', run_bench_lm, launches, bench_records)
    phase('amp', run_amp, launches['amp'], eigen_summary, bench_records)
    phase('engine_knobs', run_engine_knobs, launches['engine_knobs'], main_losses, main_tail,
          async_summary)
    phase('moe', run_moe, launches['moe'])
    phase('lora', run_lora, launches['lora'])
    phase('tp_sp', run_tp_sp, launches['tp_sp'], results)
    emit(dict(phase='timing', seconds=seconds, total_seconds=time.perf_counter() - start))
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
