"""Rank bodies of ``tests/test_torch_examples.py``'s gloo world: the port's
``train_language_model`` on each of two ranks (no JAX, no JAX package),
with the initial weights the test made with the JAX package (numpy)."""

from __future__ import annotations

import warnings

import torch

from kfac_tpu_torch import convert, data
from kfac_tpu_torch.examples import train_language_model


def run(rank: int, world: int, device: torch.device, spec: dict) -> dict:
    warnings.simplefilter('ignore')
    out = {}
    for name, case in spec.items():
        args = train_language_model.parse_args(case['argv'] + ['--device', 'cpu'])
        params = case['params']
        if case.get('pipeline'):
            def init(grid, params=params):
                return convert.from_flax_interleaved_params(
                    params, grid.stage, grid.n_stages, args.virtual_chunks)
        else:
            def init(grid, params=params):
                return convert.from_flax_params(params)
        result = train_language_model.run(args, init_params=init)
        rows = []
        if 'loader_rows' in result:  # the rows this rank's loader read
            blocks, index = result['loader_rows']
            tokens, _ = data.lm_corpus(None, args.vocab_size)
            for xb, _ in data.lm_batches(tokens, args.batch_size, args.seq_len, args.seed,
                                         rank=index, world=blocks):
                rows.append(xb)
                if len(rows) == args.limit_steps:
                    break
        out[name] = dict(losses=result['losses'], ppl=result['ppl'], rows=rows,
                         loader_rows=result.get('loader_rows'))
    return out
