"""Host-side sinks for drained telemetry records (the port's own copy of
``kfac_tpu/observability/sinks.py``, stdlib only: it reads and writes the
same JSONL).

Two destinations cover the common cases: an append-only structured JSONL
file (one record per line, trivially greppable / pandas-loadable) and a
rate-limited adapter onto the stdlib ``logging`` module for interactive
runs, where emitting every step would drown the console.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, IO

logger = logging.getLogger(__name__)


def _json_default(value: Any) -> Any:
    """Coerce numpy or torch scalars and arrays that leak into records into
    JSON types."""
    if hasattr(value, 'item') and getattr(value, 'ndim', 1) == 0:
        return value.item()
    if hasattr(value, 'tolist'):
        return value.tolist()
    raise TypeError(f'not JSON serializable: {type(value).__name__}')


class JSONLWriter:
    """Append telemetry records to a JSON-lines file.

    Each ``write`` emits one compact JSON object per line and flushes, so
    a crashed run keeps every completed step's record. Usable as a
    context manager; ``write`` on an empty record is a no-op so callers
    can drain unconditionally.

    Long-running jobs can bound disk usage with ``max_bytes``: when a
    write would push the current file past the limit, the file is
    flushed and rotated (``metrics.jsonl`` -> ``metrics.jsonl.1`` -> ...
    up to ``.max_files``, oldest deleted) BEFORE the record is written,
    so no single record is ever split across files and the active file
    always holds the newest records. Rotation is off by default —
    behavior is unchanged for existing callers.

    ``run_header`` (the shared run-header from ``ledger.run_header()``,
    a ``{'kind': 'run_header', 'run_id', 'stream', 'schema'}`` mapping)
    is stamped once as the first record of a new or empty file — and of
    each rotated successor — so every stream from one run
    self-identifies to the run ledger. Appending to a file that already
    has records never duplicates the header; header-less files stay
    valid (``run_id=None`` on ingest).
    """

    def __init__(
        self,
        path: str | os.PathLike[str],
        append: bool = True,
        max_bytes: int = 0,
        max_files: int = 3,
        run_header: dict[str, Any] | None = None,
    ):
        if max_bytes < 0:
            raise ValueError(f'max_bytes must be >= 0, got {max_bytes}')
        if max_files < 1:
            raise ValueError(f'max_files must be >= 1, got {max_files}')
        self.path = os.fspath(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        # telemetry paths are routinely dated subdirectories that don't
        # exist yet (runs/2024-01-01/metrics.jsonl); create them instead
        # of failing the first write of an otherwise healthy run
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.run_header = dict(run_header) if run_header else None
        self._file: IO[str] | None = open(self.path, 'a' if append else 'w')
        if self.run_header and self._file.tell() == 0:
            self.write(self.run_header)

    def _rotate(self) -> None:
        assert self._file is not None
        self._file.flush()
        self._file.close()
        oldest = f'{self.path}.{self.max_files}'
        if os.path.exists(oldest):
            os.remove(oldest)
        for n in range(self.max_files - 1, 0, -1):
            src = f'{self.path}.{n}'
            if os.path.exists(src):
                os.replace(src, f'{self.path}.{n + 1}')
        os.replace(self.path, f'{self.path}.1')
        self._file = open(self.path, 'w')
        if self.run_header:
            self._file.write(json.dumps(
                self.run_header, default=_json_default, sort_keys=True)
                + '\n')

    def write(self, record: dict[str, Any]) -> None:
        if not record:
            return
        if self._file is None:
            raise ValueError(f'JSONLWriter({self.path!r}) is closed')
        line = (
            json.dumps(record, default=_json_default, sort_keys=True) + '\n')
        if self.max_bytes and self._file.tell() + len(line) > self.max_bytes:
            self._rotate()
        self._file.write(line)
        self._file.flush()

    def close(self) -> None:
        # flush-before-close ordering is explicit (not left to close()'s
        # implicit flush) so every record written is durable on disk by
        # the time close returns, even for exotic IO objects
        if self._file is not None:
            self._file.flush()
            self._file.close()
            self._file = None

    def __enter__(self) -> 'JSONLWriter':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class RateLimitedLogger:
    """Forward telemetry records to ``logging`` at most once per interval.

    ``emit`` returns whether the record was actually logged, so callers
    can pair it with an unconditional :class:`JSONLWriter` (full fidelity
    on disk, sampled view on the console). A handful of headline keys are
    always shown first; the remainder is summarized by count.
    """

    _HEADLINE = (
        'step', 'kl_clip_scale', 'health/skipped_steps', 'calib/model_error',
    )

    def __init__(
        self,
        log: logging.Logger | None = None,
        min_interval_s: float = 10.0,
        level: int = logging.INFO,
    ) -> None:
        self.logger = log or logger
        self.min_interval_s = float(min_interval_s)
        self.level = level
        self._last_emit: float | None = None

    def emit(self, record: dict[str, Any]) -> bool:
        if not record:
            return False
        now = time.monotonic()
        if (self._last_emit is not None
                and now - self._last_emit < self.min_interval_s):
            return False
        self._last_emit = now
        head = [f'{k}={record[k]:g}' if isinstance(record[k], float)
                else f'{k}={record[k]}'
                for k in self._HEADLINE if k in record]
        rest = sum(1 for k in record if k not in self._HEADLINE)
        self.logger.log(
            self.level,
            'metrics: %s (+%d more keys)', ' '.join(head) or '<no headline>',
            rest)
        return True
