"""Build and load the port's CUDA kernels (``kfac_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds rather than minutes. Sources may include the
headers of ``csrc/`` (``*.cuh``). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source
and the flags, and are built at first use. :func:`build` starts one
``nvcc`` per missing source, all at once.

Every exported launcher returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('sym_cov', 'flash_attn', 'newton_schulz', 'klclip')
FLAGS = (
    '-gencode=arch=compute_90a,code=sm_90a',
    '-std=c++17',
    '-O3',
    '-shared',
    '-Xcompiler',
    '-fPIC',
    '-Xptxas=-v',
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return found


def target(name: str, source: Path | None = None) -> Path:
    """Library path for source ``name`` (``csrc/<name>.cu``, or
    ``source``), keyed by its content, the headers' and the flags."""
    src = (source or CSRC / f'{name}.cu').read_bytes()
    headers = b''.join(h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src + headers + ' '.join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def compile_command(source: Path, out: Path) -> list[str]:
    """The ``nvcc`` command that builds ``source`` into ``out``."""
    return [nvcc(), *FLAGS, f'-I{CSRC}', '-o', str(out), str(source)]


def build(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, in
    parallel. Returns ``{name: {'seconds', 'cached', 'ptxas'}}`` (the
    compiler's output, kept beside the library); raises with it if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    report: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = target(name)
        if out.exists():
            log = out.with_suffix('.log')
            report[name] = {
                'seconds': 0.0,
                'cached': True,
                'ptxas': log.read_text() if log.exists() else '',
            }
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.Popen(
            compile_command(CSRC / f'{name}.cu', tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f'--- {name} (nvcc exit {proc.returncode})\n{log}')
            continue
        out.with_suffix('.log').write_text(log)
        os.replace(tmp, out)
        report[name] = {
            'seconds': time.perf_counter() - t0,
            'cached': False,
            'ptxas': log,
        }
    if failures:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failures))
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(target(name)))


def other_library(name: str, source: Path) -> ctypes.CDLL:
    """``source``, another commit's ``csrc/<name>.cu`` (for an A/B of two
    versions of a kernel in one process), built with this tree's flags and
    loaded."""
    out = target(f'{name}_other', source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(compile_command(source, out), check=True)
    return ctypes.CDLL(str(out))


def count(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel in its ``dtype`` form: adds one to
    ``wrapper.launches`` (every form) and to
    ``wrapper.launches_by_dtype[dtype]``."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype] = wrapper.launches_by_dtype.get(dtype, 0) + 1


def reset_counts(wrapper) -> None:
    """Set ``wrapper``'s launch counts, of every form (and of every head
    dim, where it counts them), to 0."""
    wrapper.launches = 0
    wrapper.launches_by_dtype = {}
    if hasattr(wrapper, 'launches_by_head_dim'):
        wrapper.launches_by_head_dim = {}


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a nonzero CUDA error code."""
    if code != 0:
        lib = library(name)
        lib.kfac_error_string.argtypes = [ctypes.c_int]
        lib.kfac_error_string.restype = ctypes.c_char_p
        msg = lib.kfac_error_string(code).decode()
        raise RuntimeError(f'{name} kernel launch failed: {msg} ({code})')
