"""Device-resident foreign-adjacency cache (the paper's §7 caching heuristic).

R-Meef rounds fetch the adjacency rows of the same foreign pivots again
and again (hubs appear as ``f(pivot)`` in many partial embeddings).  Each
virtual machine keeps a set-associative cache of fetched foreign rows, so a
repeat request is answered locally and masked off the all-to-all.

Layout, in the engine's stacked ``(ndev, ...)`` form (one cache per
machine), as in the reference:

* ``keys``    ``(ndev, slots, ways)`` int32 vertex ids, sentinel ``n`` =
  invalid line; vertex ``v`` lives only in set ``v & (slots - 1)``;
* ``rows``    ``(ndev, slots, ways, line_width)`` int32 sentinel-padded
  sorted rows, exactly as ``DeviceGraph.rows_at`` gives them;
* ``benefit`` ``(ndev, slots, ways)`` int32 counters (invalid lines sit at
  a large negative benefit so empty ways fill first);
* ``tick``    ``(ndev,)`` int32 update batches seen (the decay clock).

Admission and eviction by benefit (frequency × row size): a hit adds
``deg + 1`` to its line; a miss is a candidate with benefit ``deg + 1``
against the minimum-benefit way of its set and is admitted only if it is
at least as large; a rejected candidate ages that victim by its own
benefit; with ``decay > 0`` every ``decay`` batches halve the live
counters.  At most one insert lands per line per batch; the winner is the
max-benefit candidate, smallest id on ties, so the contents — and the
byte accounting — are exactly the reference's.

Cache state only changes which transport delivers a row, never its bytes,
so enumeration results do not depend on it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core.exchange import lexsort

# invalid lines sit far below any reachable benefit so empty ways always
# lose the victim contest; live counters are clamped to the same magnitude
_EMPTY_BENEFIT = -(1 << 20)
_BENEFIT_CLAMP = 1 << 20


@dataclass(frozen=True)
class AdjCache:
    """Set-associative foreign-adjacency cache state (see module
    docstring).  Updates return a new state, as in the reference; the
    scheduler threads it through the fetches in dispatch order."""

    ndev: int
    slots: int        # sets per device (power of two)
    ways: int         # associativity (1 = direct-mapped)
    n: int            # sentinel / invalid key (== graph.n)
    line_width: int   # payload row width (== graph.max_degree)
    decay: int        # halve live benefits every `decay` batches (0 = off)

    keys: torch.Tensor     # (ndev, slots, ways) int32, n = invalid
    rows: torch.Tensor     # (ndev, slots, ways, line_width) int32
    benefit: torch.Tensor  # (ndev, slots, ways) int32
    tick: torch.Tensor     # (ndev,) int32

    @classmethod
    def build(cls, ndev: int, slots: int, ways: int, n: int,
              line_width: int, decay: int = 0,
              device=None) -> "AdjCache":
        """An all-invalid cache of the given geometry."""
        i32 = dict(dtype=torch.int32, device=device)
        return cls(ndev=ndev, slots=slots, ways=ways, n=n,
                   line_width=line_width, decay=decay,
                   keys=torch.full((ndev, slots, ways), n, **i32),
                   rows=torch.full((ndev, slots, ways, line_width), n, **i32),
                   benefit=torch.full((ndev, slots, ways), _EMPTY_BENEFIT,
                                      **i32),
                   tick=torch.zeros((ndev,), **i32))

    @property
    def cache_bytes(self) -> int:
        """Resident device footprint of the cache tensors."""
        return int(sum(x.numel() * x.element_size()
                       for x in (self.keys, self.rows, self.benefit,
                                 self.tick)))

    def register_metrics(self, reg) -> None:
        reg["cache_enabled"] = True
        reg["cache_bytes"] = int(self.cache_bytes)

    def updated(self, ids: torch.Tensor, hit: torch.Tensor,
                way: torch.Tensor, rows: torch.Tensor) -> "AdjCache":
        """Apply one batch of probe outcomes: bump hit lines, admit misses.

        ``ids``/``hit``/``way``: (ndev, M); ``rows``: (ndev, M, line_width)
        — the merged fetch responses.  Valid (< n) ids are unique per
        device (the fetchV request buffers are deduped upstream)."""
        n = self.n
        k, r, b = _update_dev(self.keys, self.rows, self.benefit, n,
                              ids, hit, way, rows)
        tick = self.tick + 1
        if self.decay > 0:
            fire = (tick % self.decay == 0)[:, None, None]
            b = torch.where(fire & (k < n), b >> 1, b)
        return replace(self, keys=k, rows=r, benefit=b, tick=tick)


def build_cache(cfg, g) -> AdjCache | None:
    """The cache ``EngineConfig`` asks for (``None`` = disabled), on the
    device graph's device."""
    if not cfg.enable_cache:
        return None
    return AdjCache.build(ndev=g.ndev, slots=cfg.cache_slots,
                          ways=cfg.cache_ways, n=g.n,
                          line_width=g.max_degree, decay=cfg.cache_decay,
                          device=g.device)


# --------------------------------------------------------------------------- #
# Stacked primitives: a leading ndev axis replaces the reference's vmap
# --------------------------------------------------------------------------- #
def _dev_index(x: torch.Tensor) -> torch.Tensor:
    """(ndev, 1) device index broadcasting against ``x (ndev, M)``."""
    return torch.arange(x.shape[0], device=x.device)[:, None]


def probe_lines(keys: torch.Tensor, ids: torch.Tensor, n: int):
    """Where ``ids (ndev, M)`` live in every device's cache: ``(hit bool,
    slot int64, way int64)``, each (ndev, M); a missed or sentinel id has
    ``hit=False`` and way 0."""
    slots = keys.shape[1]
    slot = torch.bitwise_and(ids, slots - 1).long()
    eq = (keys[_dev_index(ids), slot] == ids[..., None]) & (ids[..., None] < n)
    hit = eq.any(dim=-1)
    way = torch.argmax(eq.to(torch.int32), dim=-1)    # first max, as jnp
    return hit, slot, way


def probe_dev(keys: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
              n: int):
    """Look ``ids (ndev, M)`` up in every device's cache.

    Returns ``(hit (ndev, M) bool, way (ndev, M) int32, out_rows (ndev, M,
    line_width))``; missed / sentinel ids get ``hit=False`` and an
    all-sentinel row."""
    hit, slot, way = probe_lines(keys, ids, n)
    out = rows[_dev_index(ids), slot, way].masked_fill_(~hit[..., None], n)
    return hit, way.to(torch.int32), out


def _update_dev(keys, rows, ben, n, ids, hit, way, frows):
    """Every device's benefit bump + admission pass (module docstring)."""
    ndev, slots, ways = keys.shape
    lines = slots * ways
    t = _dev_index(ids)
    valid = ids < n
    weight = (frows < n).sum(-1, dtype=torch.int32) + 1   # row words + id
    slot = torch.bitwise_and(ids, slots - 1).long()
    ben = ben.reshape(ndev, lines).clone()
    zero = torch.zeros_like(weight)

    # 1. hits: grow the line's benefit by the bytes it just saved (distinct
    #    ids never share a line; non-hits add 0 to an in-range line)
    h = hit & valid
    ben.scatter_add_(1, slot * ways + way.long(),
                     torch.where(h, weight, zero))

    # 2. misses: victim = min-benefit way of the set, admitted only if the
    #    candidate's benefit wins; rejected candidates age the victim
    cand = valid & ~hit
    bset = ben.view(ndev, slots, ways)[t, slot]              # (ndev, M, W)
    vben, victim = torch.min(bset, dim=-1)                  # first min
    admit = cand & (weight >= vben)
    line = slot * ways + victim
    ben.scatter_add_(1, line, torch.where(cand & ~admit, -weight, zero))

    # 3. one winner per (set, victim way): max benefit, then smallest id
    lkey = torch.where(admit, line, torch.full_like(line, lines))
    order = lexsort((ids, -weight, lkey))
    lk_s = lkey.gather(1, order)
    first = torch.ones_like(admit)
    first[:, 1:] = lk_s[:, 1:] != lk_s[:, :-1]
    win = first & admit.gather(1, order)
    # winner candidate index per line (a spare column takes the losers)
    m = ids.shape[1]
    winner = torch.full((ndev, lines + 1), m, dtype=torch.int64,
                        device=ids.device)
    winner.scatter_(1, torch.where(win, lk_s, torch.full_like(lk_s, lines)),
                    order)
    winner = winner[:, :lines]
    has = winner < m
    w = winner.clamp(max=m - 1)
    keys = torch.where(has, ids.gather(1, w), keys.reshape(ndev, lines))
    ben = torch.where(has, weight.gather(1, w), ben)
    rows = torch.where(has[..., None], frows[t, w],
                       rows.reshape(ndev, lines, -1))
    ben = ben.clamp_(-_BENEFIT_CLAMP, _BENEFIT_CLAMP)
    return (keys.view(ndev, slots, ways), rows.view(ndev, slots, ways, -1),
            ben.view(ndev, slots, ways))
