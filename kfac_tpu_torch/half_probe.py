"""What sets the time of the 16-bit ``sym_cov`` and flash kernels: device
ms of variants of their sources, on one card, in one process.

Run on a CUDA card from the repository root::

    python -m kfac_tpu_torch.half_probe

On this machine's cards ``ncu`` and ``nsys`` do not run, so the parts of a
kernel are timed by taking them out. Each variant is ``csrc/sym_cov.cu``
or ``csrc/flash_attn.cu`` with text replaced (``SYM_COV`` and ``FLASH``
below; one ``nvcc`` each, all at once, into ``build/kernels/probe/``):
build choices (the ring's depth, the exp of the softmax, two consumer
warpgroups of 64 rows sharing 128-row tiles in place of one of 64, a TMA
store of O) and ablations, whose outputs are wrong by design
(``ablation``: the ``wgmma`` products, the epilogue's stores, the
softmax's exp or a product left out).
``sym_cov`` also runs with its 2049- and 513-wide rows 8 values apart
(``rows_8_apart``) where the A builders pad them to 64. Shapes: ``sym_cov``
in bf16 at the flagship's (8192, 513 / 2049 / 512 / 2048), the flash
partials in bf16 at (16, 512, 4, 128).

Prints the card's name and power limit, then one JSON line a shape: each
variant's device ms (torch.profiler, the kernels of the form) and its
largest error relative to the plain version's max.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from kfac_tpu_torch.half_ab import THIS_KERNELS, device_ms
from kfac_tpu_torch.ops import build, flash_attention, sym_cov

# (variant: [(text, replacement), ...], ablation?)
SYM_COV = {
    'built': ([], False),
    'stages_4': ([('static constexpr int kStages = 5;', 'static constexpr int kStages = 4;')], False),
    'stages_6': ([('static constexpr int kStages = 5;',
                   'static constexpr int kStages = sizeof(Out) == 4 ? 5 : 6;')], False),
    'no_wgmma': ([('          hopper::Wgmma<T>::ss_n128_tt(acc, da, db, 1);', '')], True),
    'no_epilogue': ([('    if (c.slot >= 0) {  // a slice',
                      '    if (c.pair >= 0) continue;\n    if (c.slot >= 0) {  // a slice')], True),
}
FLASH = {
    'built': ([], False),
    'expf': ([('exp2_approx(fmaf(x, scale_log2e, -base))', 'expf(__fmul_rn(x, scale) - new_m)'),
              ('exp2_approx((m[r] - new_m) * kLog2e)', 'expf(m[r] - new_m)')], False),
    'two_warpgroups': ([
        ('''  static constexpr int kBQ = 64;
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kCtas = D == 256 ? 1 : 2;''', '''  static constexpr int kBQ = 128;
  static constexpr int kBK = 64;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kCtas = 1;'''),
        ('static constexpr int kThreads = 160;', 'static constexpr int kThreads = 384;'),
        ('__global__ void __launch_bounds__(160, Flash16<D>::kCtas)',
         '__global__ void __launch_bounds__(384, 1)'),
        ('hopper::mbar_init(&empty[s], 4);', 'hopper::mbar_init(&empty[s], 8);'),
        ('''  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128 && hi > 0) {''', '''  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n");
    if (threadIdx.x == 256 && hi > 0) {'''),
        ('''  } else {  // the consumer warpgroup
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this lane's rows g and g + 8 of its warp, as global query positions
    const int qpos0 = q_off + q0 + 16 * warp + g;
''', '''  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int qw = q0 + 64 * wg;
    const int hi_w = qw < s_q ? bound(qw, 64) : 0;
    const int qpos0 = q_off + qw + 16 * warp + g;
'''),
        ('''    if (hi > 0) hopper::mbar_wait(q_full, 0);
    const uint32_t q_at = smem_u32(qs);
''', '''    if (hi_w > 0) hopper::mbar_wait(q_full, 0);
    const uint32_t q_at = smem_u32(qs) + 64 * wg * F::kRow;
'''),
        ('''      hopper::mbar_wait(&full[stage], phase);
      {
        const uint32_t k_at''', '''      hopper::mbar_wait(&full[stage], phase);
      if (kt < hi_w) {
        const uint32_t k_at'''),
        ('(causal && k_off + key0 + F::kBK - 1 > q_off + q0);',
         '(causal && k_off + key0 + F::kBK - 1 > q_off + qw);'),
        ('      const int sq = q0 + 16 * warp + g + 8 * r;', '      const int sq = qw + 16 * warp + g + 8 * r;'),
    ], False),
    # O staged in the (free) ring, 128-byte swizzled, and written by TMA
    # bulk stores in place of the threads' streaming stores
    'tma_store': ([
        ('''flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   float* __restrict__ acc_out,''', '''flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map,
                   float* __restrict__ acc_out,'''),
        ('''    const size_t row_stride = static_cast<size_t>(h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = q0 + 16 * warp + g + 8 * r;
      if (sq >= s_q) continue;
      float* orow = acc_out + (static_cast<size_t>(b) * s_q + sq) * row_stride + hh * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)  // streaming: acc is read by a later kernel
        __stcs(reinterpret_cast<float2*>(orow + 8 * j + 2 * t),
               make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]));
      if (t == 0) {''', '''    float* os = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int chunk = (2 * (j % 4) + t / 2) ^ (row % 8);
        *reinterpret_cast<float2*>(os + (j / 4) * 64 * 32 + row * 32 + chunk * 4 + 2 * (t % 2)) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    hopper::bar_sync(1, 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < (D + 31) / 32; ++c)
        asm volatile(
            "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\\n"
            ::"l"(reinterpret_cast<uint64_t>(&o_map)), "r"(smem_u32(os + c * 64 * 32)),
            "r"(c * 32), "r"(hh), "r"(q0), "r"(b) : "memory");
      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = q0 + 16 * warp + g + 8 * r;
      if (sq >= s_q) continue;
      if (t == 0) {'''),
        ('  CUtensorMap q_map, k_map, v_map;', '  CUtensorMap q_map, k_map, v_map, o_map;'),
        ('''  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);''', '''  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(s_q),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 4,
                                   static_cast<cuuint64_t>(h) * D * 4,
                                   static_cast<cuuint64_t>(s_q) * h * D * 4};
    const cuuint32_t box[4] = {D < 32 ? D : 32, 1, F::kBQ, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const CUresult res = hopper::encode_tiled()(
        &o_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc, dims, strides, box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);'''),
        ('      q_map, k_map, v_map, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);',
         '      q_map, k_map, v_map, o_map, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);'),
    ], False),
    'no_epilogue': ([('      if (sq >= s_q) continue;', '      if (sq >= 0) continue;')], True),
    'no_exp': ([('exp2_approx(fmaf(x, scale_log2e, -base))', 'x')], True),
    'no_pv': ([('          hopper::Wgmma<T>::rs_t(o, pa[kk], dv, 1);', '')], True),
    'no_qk': ([('            hopper::Wgmma<T>::ss_n64_nn(s, dq, dk, c + kk > 0);', '')], True),
}
COVS = ((8192, 513), (8192, 2049), (8192, 512), (8192, 2048))
FLASH_SHAPE = (16, 512, 4, 128)


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise ValueError(f'a variant\'s text is not in the source: {old[:60]!r}')
        src = src.replace(old, new)
    return src


def build_variants(name: str, table: dict) -> dict[str, ctypes.CDLL]:
    """One library per variant of ``csrc/<name>.cu``, built at once."""
    out_dir = build.BUILD_DIR / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f'{name}.cu').read_text()
    started = []
    for variant, (subs, _) in table.items():
        cu = out_dir / f'{name}_{variant}.cu'
        cu.write_text(variant_source(src, subs))
        lib = cu.with_suffix('.so')
        proc = subprocess.Popen(build.compile_command(cu, lib), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((variant, lib, proc))
    libs = {}
    for variant, lib, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name} {variant}:\n{log}')
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def sym_cov_row(libs, n, d, gen) -> dict:
    dev = torch.device('cuda')
    sms = sym_cov.sm_count(dev.index or 0)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    want = sym_cov.sym_cov_plain(x).float()
    p = sym_cov.plan16(n, d, sms)
    part = sym_cov.half_scratch(p, dev)
    out = torch.empty(d, d, dtype=torch.bfloat16, device=dev)
    layouts = {'': sym_cov.kernel_rows(n, d, torch.bfloat16, dev, d % sym_cov.ROW_ALIGN16 != 0)}
    if d % sym_cov.ROW_ALIGN16:
        ld = -(-d // sym_cov.ROW_ALIGN16) * sym_cov.ROW_ALIGN16
        layouts['rows_8_apart'] = torch.empty(n, ld, dtype=torch.bfloat16, device=dev)[:, :d]
    row = {'kernel': 'sym_cov', 'dtype': 'bf16', 'shape': [n, d], 'variants': {}}
    for variant, lib in libs.items():
        fn = lib.sym_cov_bf16
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, *[ctypes.c_int] * 5,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for layout, a in layouts.items():
            if layout and variant != 'built':
                continue
            a.copy_(x)

            def run(fn=fn, a=a):
                code = fn(a.data_ptr(), a.stride(0), out.data_ptr(),
                          0 if part is None else part.data_ptr(), n, d, float(n),
                          *sym_cov.walk_args(p), torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f'{variant} returned {code}')

            run()
            torch.cuda.synchronize()
            row['variants'][layout or variant] = dict(
                device_ms=device_ms(run, THIS_KERNELS['sym_cov']),
                max_rel_err=float((out.float() - want).abs().max() / want.abs().max()),
                ablation=SYM_COV[variant][1],
            )
    return row


def flash_row(libs, gen) -> dict:
    dev = torch.device('cuda')
    b, s, h, hd = FLASH_SHAPE
    q, k, v = (torch.randn(*FLASH_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    want = flash_attention.attend_partials_rounded(q, k, v, 0, 0, True)[0]
    acc = torch.empty(FLASH_SHAPE, device=dev)
    m = torch.empty(b, h, s, device=dev)
    l = torch.empty_like(m)
    row = {'kernel': 'flash_attention_partials', 'dtype': 'bf16', 'shape': list(FLASH_SHAPE),
           'variants': {}}
    for variant, lib in libs.items():
        fn = lib.flash_attn_partials_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                      l.data_ptr(), b, h, s, s, hd, 0, 0, 1, hd ** -0.5,
                      torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f'{variant} returned {code}')

        acc.zero_()
        run()
        torch.cuda.synchronize()
        row['variants'][variant] = dict(
            device_ms=device_ms(run, ('flash_wgmma_kernel',)),
            max_rel_err=float((acc - want).abs().max() / want.abs().max()),
            ablation=FLASH[variant][1],
        )
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print('half_probe: no CUDA device is visible', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cov_libs = build_variants('sym_cov', SYM_COV)
    flash_libs = build_variants('flash_attn', FLASH)
    gen = torch.Generator('cuda').manual_seed(0)
    for n, d in COVS:
        print(json.dumps(sym_cov_row(cov_libs, n, d, gen)), flush=True)
    print(json.dumps(flash_row(flash_libs, gen)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
