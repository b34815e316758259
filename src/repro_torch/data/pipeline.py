"""Data pipelines: deterministic synthetic streams keyed by (seed, step),
so a replay after a restore draws the same batches, with a background
prefetch thread (double buffering).  A copy of the reference's
``data/pipeline.py`` (pure numpy): the same seed gives the same arrays.
``din_batch_stream`` and ``gnn_epoch_stream`` come with their slices.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class Prefetcher:
    """Wrap an iterator with a daemon prefetch thread (depth-2 buffer)."""

    def __init__(self, it, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        for x in self._it:
            self.q.put(x)
        self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self.q.get()
        if x is self._done:
            raise StopIteration
        return x


def lm_token_stream(vocab: int, batch: int, seq_len: int, seed: int = 0,
                    n_steps: int | None = None):
    """Synthetic-but-learnable stream: Zipf unigrams + a deterministic
    bigram rule (token t+1 = (a*t + c) % V with prob 0.5) so training loss
    actually falls — validates the end-to-end optimizer path."""
    step = 0
    zipf_p = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    zipf_p /= zipf_p.sum()
    while n_steps is None or step < n_steps:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=zipf_p)
        follow = (toks[:, :-1] * 31 + 17) % vocab
        coin = rng.random((batch, seq_len)) < 0.5
        toks[:, 1:] = np.where(coin, follow, toks[:, 1:])
        yield dict(tokens=toks[:, :-1].astype(np.int32),
                   labels=toks[:, 1:].astype(np.int32))
        step += 1
