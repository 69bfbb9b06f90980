"""Datasets of the port's accuracy gates and bench (counterpart of the
``digits`` loader, ``synthetic_classification`` and the synthetic branch
of ``cifar10`` in ``examples/data.py``: the same seeds, the same arrays).

The digits come from a copy of scikit-learn's ``digits.csv.gz`` kept in
``kfac_tpu_torch/datasets/`` (origin and citation in its ``README.md``),
so no machine needs scikit-learn or a network to run the gate. CIFAR-10 is
the JAX package's shape-faithful class-conditional synthetic set; real
images are not in the repository.
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


def synthetic_classification(
    n: int,
    shape: tuple[int, ...],
    num_classes: int,
    seed: int = 0,
    center_seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian class-conditional images ``(x f32 (n, *shape), labels
    int32)``: ``seed`` draws the labels and the per-sample noise,
    ``center_seed`` the class centres from a stream of its own, so splits
    of other seeds share one problem."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    centers = (
        np.random.default_rng([center_seed, 0xCE27E5])
        .normal(size=(num_classes,) + shape)
        .astype(np.float32)
    )
    x = 0.5 * centers[labels] + rng.normal(size=(n,) + shape).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def cifar10(n_train: int = 50000, n_test: int = 10000):
    """``((x_train, y_train), (x_test, y_test))``: (32, 32, 3) NHWC images
    of 10 classes, the synthetic set (train seed 0, test seed 1)."""
    train = synthetic_classification(n_train, (32, 32, 3), 10, seed=0)
    test = synthetic_classification(n_test, (32, 32, 3), 10, seed=1)
    return train, test
