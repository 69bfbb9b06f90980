"""Datasets of the port's accuracy gate (counterpart of the ``digits``
loader of ``examples/data.py``).

The digits come from a copy of scikit-learn's ``digits.csv.gz`` kept in
``kfac_tpu_torch/datasets/`` (origin and citation in its ``README.md``),
so no machine needs scikit-learn or a network to run the gate.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

DIGITS_CSV = Path(__file__).resolve().parent / 'datasets' / 'digits.csv.gz'


def digits() -> tuple[tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """The 8x8 digits as ``((x_train, y_train), (x_test, y_test))``: pixels
    over 16 as f32 (N, 64), labels int32, rows shuffled by
    ``np.random.default_rng(0)``'s permutation and split 80/20, as
    ``examples.data.digits`` does over ``sklearn.datasets.load_digits``."""
    with gzip.open(DIGITS_CSV, 'rt') as f:
        data = np.loadtxt(f, delimiter=',')
    x, y = data[:, :-1], data[:, -1].astype(int)
    x = (x / 16.0).astype(np.float32)
    idx = np.random.default_rng(0).permutation(len(x))
    x, y = x[idx], y[idx].astype(np.int32)
    split = int(0.8 * len(x))
    return (x[:split], y[:split]), (x[split:], y[split:])
