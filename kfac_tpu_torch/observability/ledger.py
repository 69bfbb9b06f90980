"""Run identifiers and the run-header record of the unified run ledger
(the port's own copy of ``new_run_id``, ``run_header`` and
``LEDGER_SCHEMA`` from ``kfac_tpu/observability/ledger.py``; the same
schema, so the JAX package's ledger reads the port's streams)."""

from __future__ import annotations

import uuid
from typing import Any

#: ledger event format version (the run-header ``schema`` field)
LEDGER_SCHEMA = 1


def new_run_id() -> str:
    """A fresh 12-hex-char run identifier."""
    return uuid.uuid4().hex[:12]


def run_header(run_id: str, stream: str) -> dict[str, Any]:
    """The shared run-header record stamped first into each JSONL stream."""
    return {
        'kind': 'run_header',
        'run_id': str(run_id),
        'schema': LEDGER_SCHEMA,
        'stream': str(stream),
    }
