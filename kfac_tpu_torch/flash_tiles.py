"""Time the flash kernel at the tile sizes it could be built with.

Run on a CUDA card::

    python -m kfac_tpu_torch.flash_tiles

``csrc/flash_attn.cu`` fixes, per head dim, the warps of a CTA (16 query
rows each) and the rows of a K/V tile (``Tiles<D>``). This builds a copy of
the source for each candidate below, with ``Tiles<D>`` rewritten (one
``nvcc`` each, all at once, into ``build/kernels/tiles/``), checks each
against the plain version and times it with CUDA events beside
``scaled_dot_product_attention``, at the attention shapes of the bench's
tiny LM, flagship and ``large``. Prints the card's name and power limit,
then one JSON line per shape: each candidate's time and its largest error
relative to the max of acc, m and l.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from kfac_tpu_torch.bench_lm import nvidia_smi
from kfac_tpu_torch.ops import build
from kfac_tpu_torch.ops.flash_attention import attend_partials_einsum

# (warps, K/V rows) per head dim; the first of each list is the one built
CANDIDATES = {
    32: [(4, 64), (4, 32), (2, 64), (8, 64)],
    128: [(4, 32), (4, 64), (8, 32), (8, 64), (4, 16), (2, 32)],
    256: [(8, 16), (4, 32), (4, 16), (8, 8), (4, 8), (2, 32)],
}
SHAPES = ((4, 128, 4, 32), (16, 512, 4, 128), (8, 1024, 4, 256))
TILES = r'struct Tiles<{d}> {{\n  static constexpr int kWarps = (\d+);\n  static constexpr int kBK = (\d+);'


def variant_source(src: str, tiles: dict[int, tuple[int, int]]) -> str:
    """``src`` with ``Tiles<D>`` set to ``tiles[D]`` for each D."""
    for d, (warps, bk) in tiles.items():
        pattern = TILES.format(d=d)
        if not re.search(pattern, src):
            raise ValueError(f'no Tiles<{d}> in the source')
        src = re.sub(
            pattern,
            f'struct Tiles<{d}> {{\n  static constexpr int kWarps = {warps};\n'
            f'  static constexpr int kBK = {bk};',
            src,
        )
    return src


def build_variants() -> list[tuple[dict, ctypes.CDLL]]:
    """One library per candidate index: candidate i of every head dim (the
    last one where a list is shorter)."""
    out_dir = build.BUILD_DIR / 'tiles'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / 'flash_attn.cu').read_text()
    started = []
    for i in range(max(map(len, CANDIDATES.values()))):
        tiles = {d: c[min(i, len(c) - 1)] for d, c in CANDIDATES.items()}
        cu = out_dir / f'flash_attn_{i}.cu'
        cu.write_text(variant_source(src, tiles))
        lib = cu.with_suffix('.so')
        proc = subprocess.Popen(
            build.compile_command(cu, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started.append((tiles, lib, proc))
    built = []
    for tiles, lib, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {tiles}:\n{log}')
        fn = ctypes.CDLL(str(lib)).flash_attn_partials_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built.append((tiles, fn))
    return built


def time_ms(fn, iters: int = 200) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    print(nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = build_variants()
    gen = torch.Generator('cuda').manual_seed(0)
    for shape in SHAPES:
        b, s, h, d = shape
        q, k, v = (torch.randn(*shape, generator=gen, device='cuda') for _ in range(3))
        want = attend_partials_einsum(q, k, v, 0, 0, True)
        acc, m, l = torch.empty_like(q), torch.empty(b, h, s, device='cuda'), torch.empty(b, h, s, device='cuda')
        stream = torch.cuda.current_stream().cuda_stream
        row = {'shape': list(shape), 'sdpa_ms': time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True
            )
        ), 'tiles': []}
        seen = set()
        for tiles, fn in variants:
            if tiles[d] in seen:
                continue
            seen.add(tiles[d])

            def run(fn=fn):
                build.check('flash_attn', fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                    l.data_ptr(), b, h, s, s, d, 0, 0, 1, d ** -0.5, stream,
                ))

            run()
            err = max(float((x - w).abs().max() / w.abs().max()) for x, w in zip((acc, m, l), want))
            row['tiles'].append({'warps': tiles[d][0], 'kv_rows': tiles[d][1],
                                 'ms': time_ms(run), 'max_rel_err': err})
        print(json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
