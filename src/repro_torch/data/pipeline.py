"""Data pipelines: deterministic synthetic streams keyed by (seed, step),
so a replay after a restore draws the same batches, with a background
prefetch thread (double buffering).  A copy of the reference's
``data/pipeline.py`` (pure numpy): the same seed gives the same arrays.
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


def din_batch_stream(n_items: int, n_cates: int, n_user: int, batch: int,
                     seq_len: int, n_user_multihot: int = 4, seed: int = 0,
                     n_steps: int | None = None):
    """CTR stream with planted signal: label = 1 iff target cate appears in
    the history cates (plus noise)."""
    step = 0
    while n_steps is None or step < n_steps:
        rng = np.random.default_rng(seed * 7_000_003 + step)
        hist_items = rng.integers(0, n_items, (batch, seq_len))
        hist_cates = hist_items % n_cates
        hist_len = rng.integers(seq_len // 4, seq_len + 1, (batch,))
        mask = np.arange(seq_len)[None, :] < hist_len[:, None]
        tgt_item = rng.integers(0, n_items, (batch,))
        tgt_cate = tgt_item % n_cates
        match = ((hist_cates == tgt_cate[:, None]) & mask).any(1)
        noise = rng.random(batch) < 0.1
        labels = np.where(noise, ~match, match).astype(np.float32)
        yield dict(user_feats=rng.integers(0, n_user, (batch, n_user_multihot)).astype(np.int32),
                   target_item=tgt_item.astype(np.int32),
                   target_cate=tgt_cate.astype(np.int32),
                   hist_items=hist_items.astype(np.int32),
                   hist_cates=hist_cates.astype(np.int32),
                   hist_mask=mask,
                   labels=labels)
        step += 1


def gnn_epoch_stream(graph, feats: np.ndarray, labels: np.ndarray,
                     batch_nodes: int, fanout: tuple[int, ...], seed: int = 0,
                     n_steps: int | None = None):
    """Sampled-training stream over a big graph (minibatch_lg shape): each
    step ``batch_nodes`` seeds drawn without replacement and their
    ``fanout`` neighbourhood (:func:`~repro_torch.graph.sampler.sample_neighbors`),
    as a dict of the ``GraphBatch`` fields padded to the sampler's fixed
    capacities.  One generator runs through the whole stream, so a replay
    needs the stream itself, not the step."""
    from repro_torch.graph.sampler import sample_neighbors
    rng = np.random.default_rng(seed)
    step = 0
    while n_steps is None or step < n_steps:
        seeds = rng.choice(graph.n, size=batch_nodes, replace=False)
        sub = sample_neighbors(graph, seeds, fanout, rng)
        node_ids = np.clip(sub.nodes, 0, graph.n - 1)
        yield dict(node_feats=feats[node_ids],
                   edge_src=sub.edge_src, edge_dst=sub.edge_dst,
                   edge_mask=sub.edge_mask,
                   labels=labels[node_ids],
                   label_mask=sub.seed_mask & (sub.nodes >= 0))
        step += 1
