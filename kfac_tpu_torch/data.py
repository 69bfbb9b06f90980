"""Datasets of the port's example trainers, accuracy gates and bench
(counterpart of ``examples/data.py``: the same seeds, the same arrays, the
same on-disk layouts).

The digits come from a copy of scikit-learn's ``digits.csv.gz`` kept in
``kfac_tpu_torch/datasets/`` (origin and citation in its ``README.md``),
so no machine needs scikit-learn or a network to run the gate. CIFAR-10
and the ImageNet-shaped set load from ``--data-dir`` when their files are
there (``cifar10.npz``; ``imagenet_{x,y}_{train,test}.npy`` memory-mapped,
else ``imagenet.npz``), else they are the JAX package's shape-faithful
class-conditional synthetic sets. The LM corpus is ``corpus.npy``
(memory-mapped) with its ``vocab.json``, else a seeded Zipf stream: that
stream is the data when no corpus is on disk, as in the JAX package.

The per-rank loader: :func:`batches` and :func:`lm_batches` take ``rank``
and ``world``. Every rank draws the same global permutation from the seed
and copies only its block of each batch's rows (rows ``rank * B / world``
to ``(rank + 1) * B / world``), so the ranks' rows, concatenated, are the
global batch whose block ``TrainGrid.local_rows`` would cut.
"""

from __future__ import annotations

import gzip
import json
import os
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


def cifar_on_disk(data_dir: str | None) -> bool:
    """Whether :func:`cifar10` would load a real dataset from ``data_dir``."""
    return bool(data_dir) and os.path.exists(os.path.join(data_dir, 'cifar10.npz'))


def _imagenet_memmap_files(data_dir: str) -> list[str]:
    """The on-disk memmap layout of :func:`imagenet_like`."""
    return [
        os.path.join(data_dir, f'imagenet_{k}_{s}.npy') for k in ('x', 'y') for s in ('train', 'test')
    ]


def imagenet_on_disk(data_dir: str | None) -> bool:
    """Whether :func:`imagenet_like` would load real data (the memmap
    layout needs all four files, else ``imagenet.npz``)."""
    if not data_dir:
        return False
    return all(os.path.exists(f) for f in _imagenet_memmap_files(data_dir)) or os.path.exists(
        os.path.join(data_dir, 'imagenet.npz')
    )


def _npz_splits(path: str):
    z = np.load(path)
    return (
        (z['x_train'].astype(np.float32), z['y_train'].astype(np.int32)),
        (z['x_test'].astype(np.float32), z['y_test'].astype(np.int32)),
    )


def cifar10(data_dir: str | None = None, n_train: int = 50000, n_test: int = 10000):
    """``((x_train, y_train), (x_test, y_test))``: (32, 32, 3) NHWC images
    of 10 classes: ``cifar10.npz`` from ``data_dir`` (keys x_train,
    y_train, x_test, y_test) when it is there, else the synthetic set
    (train seed 0, test seed 1)."""
    if cifar_on_disk(data_dir):
        return _npz_splits(os.path.join(data_dir, 'cifar10.npz'))
    train = synthetic_classification(n_train, (32, 32, 3), 10, seed=0)
    test = synthetic_classification(n_test, (32, 32, 3), 10, seed=1)
    return train, test


def imagenet_like(
    data_dir: str | None = None,
    image_size: int = 224,
    n_train: int = 10000,
    n_test: int = 1000,
    num_classes: int = 1000,
):
    """ImageNet-shaped ``(S, S, 3)`` NHWC images of ``num_classes``:
    ``imagenet_{x,y}_{train,test}.npy`` from ``data_dir`` with x
    memory-mapped (the native loader's worker then reads its pages from
    disk), else ``imagenet.npz`` (loaded), else the synthetic set."""
    if data_dir:
        if all(os.path.exists(f) for f in _imagenet_memmap_files(data_dir)):
            def load(split):
                x = np.load(os.path.join(data_dir, f'imagenet_x_{split}.npy'), mmap_mode='r')
                y = np.load(os.path.join(data_dir, f'imagenet_y_{split}.npy')).astype(np.int32)
                return x, y

            return load('train'), load('test')
        path = os.path.join(data_dir, 'imagenet.npz')
        if os.path.exists(path):
            return _npz_splits(path)
    shape = (image_size, image_size, 3)
    train = synthetic_classification(n_train, shape, num_classes, seed=0)
    test = synthetic_classification(n_test, shape, num_classes, seed=1)
    return train, test


def lm_corpus(
    data_dir: str | None = None,
    vocab_size: int = 8192,
    n_tokens: int = 2_000_000,
    seed: int = 0,
):
    """``(tokens, vocab)`` for LM training: ``corpus.npy`` from ``data_dir``
    memory-mapped (only each batch's windows are copied), its vocabulary
    from ``vocab.json`` (``{"size": N, "max_token": M}``; a file without
    ``max_token`` costs one pass over the corpus to check it) or from the
    largest token; else a seeded Zipf(1.3) stream of ``n_tokens`` clipped
    to ``[1, vocab_size - 1]``. Raises if ``vocab.json``'s size does not
    exceed the corpus' largest token."""
    if data_dir:
        path = os.path.join(data_dir, 'corpus.npy')
        if os.path.exists(path):
            toks = np.load(path, mmap_mode='r')
            vpath = os.path.join(data_dir, 'vocab.json')
            if os.path.exists(vpath):
                with open(vpath) as f:
                    meta = json.load(f)
                vocab = int(meta['size'])
                max_tok = int(meta['max_token']) if 'max_token' in meta else int(toks.max())
                if vocab <= max_tok:
                    raise ValueError(
                        f'vocab.json size={vocab} but {path} contains token id {max_tok}; '
                        "vocab.json must be the tokenizer's own output (one that writes a "
                        'consistent pair)'
                    )
            else:
                vocab = int(toks.max()) + 1
            return toks, vocab
    rng = np.random.default_rng(seed)
    toks = rng.zipf(1.3, size=n_tokens).astype(np.int64)
    toks = np.clip(toks, 1, vocab_size - 1).astype(np.int32)
    return toks, vocab_size


CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Per-channel normalization of (..., H, W, C) images."""
    return ((x - mean) / std).astype(np.float32)


def augment_images(
    x: np.ndarray, rng: np.random.Generator, pad: int = 4, flip: bool = True
) -> np.ndarray:
    """Random pad-crop and horizontal flip of a batch of (H, W, C) images
    (RandomCrop(padding=pad) and RandomHorizontalFlip), from ``rng``."""
    n, h, w, _ = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    dy = rng.integers(0, 2 * pad + 1, size=n)
    dx = rng.integers(0, 2 * pad + 1, size=n)
    do_flip = flip & (rng.integers(0, 2, size=n) == 1)
    out = np.empty_like(x)
    for i in range(n):
        img = padded[i, dy[i]:dy[i] + h, dx[i]:dx[i] + w]
        out[i] = img[:, ::-1] if do_flip[i] else img
    return out


def rank_rows(batch_size: int, rank: int, world: int) -> slice:
    """The rows of a batch of ``batch_size`` that rank ``rank`` of
    ``world`` keeps: its contiguous block."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f'rank {rank} is not in a world of {world}')
    if batch_size % world:
        raise ValueError(f'batch {batch_size} does not split over {world} ranks')
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def batches(x, y, batch_size: int, seed: int, drop_last: bool = True, rank: int = 0,
            world: int = 1):
    """Shuffled epoch iterator of ``(x, y)`` batches from ``seed``'s
    permutation; with ``world`` ranks, this rank's block of each batch's
    rows (:func:`rank_rows`), only those rows copied."""
    rows = rank_rows(batch_size, rank, world)
    idx = np.random.default_rng(seed).permutation(len(x))
    end = (len(x) // batch_size) * batch_size if drop_last else len(x)
    for i in range(0, end, batch_size):
        j = idx[i:i + batch_size][rows]
        yield x[j], y[j]


def lm_batches(tokens, batch_size: int, seq_len: int, seed: int, rank: int = 0, world: int = 1):
    """Contiguous next-token windows ``(x, y)`` int32 ``(B, seq_len)``,
    shuffled by ``seed`` (callers pass ``seed + epoch``, so a run resumed
    at an epoch boundary replays the uninterrupted run's batches); with
    ``world`` ranks, this rank's block of each batch's rows
    (:func:`rank_rows`). ``tokens`` may be a read-only memmap: only the
    windows kept are copied."""
    rows = rank_rows(batch_size, rank, world)
    n_windows = (len(tokens) - 1) // seq_len
    starts = np.random.default_rng(seed).permutation(n_windows)[
        : (n_windows // batch_size) * batch_size
    ]
    for i in range(0, len(starts), batch_size):
        s = starts[i:i + batch_size][rows] * seq_len
        x = np.stack([tokens[a:a + seq_len] for a in s]).astype(np.int32, copy=False)
        y = np.stack([tokens[a + 1:a + seq_len + 1] for a in s]).astype(np.int32, copy=False)
        yield x, y
