"""Execution-plan computation (§4).

A plan is a sequence of decomposition units ``(piv, leaves)`` such that the
pivots form a connected dominating set; Theorem 1 says the minimum number of
units equals the connected-domination number ``c_P``. We enumerate all
minimum CDSs, all valid pivot orderings and leaf assignments (queries are
tiny — §4: "we can simply enumerate all the possible execution plans"), then
apply the paper's selection rules in order:

  1. minimum number of rounds (guaranteed by construction),
  2. minimum span of ``dp0.piv`` (maximizes the SM-E share, §4.2),
  3. maximum score  SC(PL) = Σ_i [ |E_sib_i|+|E_cro_i| ] / (i+1)^ρ
                           + deg(piv_i) / (i+1)          (§4.3, Eq. 4).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.query import Pattern


@dataclass(frozen=True)
class Unit:
    piv: int
    leaves: tuple[int, ...]


@dataclass(frozen=True)
class Plan:
    pattern: Pattern
    units: tuple[Unit, ...]
    # derived
    matching_order: tuple[int, ...] = ()

    @property
    def n_rounds(self) -> int:
        return len(self.units)

    def prefix_vertices(self, i: int) -> set[int]:
        """V_{P_{i-1}} — vertices matched before unit i starts."""
        vs: set[int] = set()
        for j in range(i):
            vs.add(self.units[j].piv)
            vs.update(self.units[j].leaves)
        return vs

    def edge_sets(self, i: int) -> tuple[list, list, list]:
        """(E_star, E_sib, E_cro) of unit i per §3.2."""
        u = self.units[i]
        p = self.pattern
        star = [(u.piv, lf) for lf in u.leaves if p.has_edge(u.piv, lf)]
        sib = [(a, b) for a, b in itertools.combinations(u.leaves, 2)
               if p.has_edge(a, b)]
        prev = self.prefix_vertices(i)
        cro = [(x, lf) for lf in u.leaves for x in prev
               if x != u.piv and p.has_edge(x, lf)]
        return star, sib, cro

    def score(self, rho: float = 1.0) -> float:
        s = 0.0
        for i in range(len(self.units)):
            _, sib, cro = self.edge_sets(i)
            s += (len(sib) + len(cro)) / (i + 1) ** rho
            s += self.pattern.degree(self.units[i].piv) / (i + 1)
        return s

    def validate(self) -> None:
        p = self.pattern
        seen: set[int] = set()
        for i, u in enumerate(self.units):
            if i == 0:
                seen.add(u.piv)
            else:
                assert u.piv in seen, f"unit {i} pivot {u.piv} not in prefix"
            assert u.leaves, f"unit {i} has no leaves"
            for lf in u.leaves:
                assert lf not in seen, f"leaf {lf} already matched"
                assert p.has_edge(u.piv, lf), f"leaf {lf} not adjacent to pivot"
                seen.add(lf)
        assert seen == set(range(p.n)), f"plan covers {seen}, want all {p.n}"


def compute_matching_order(plan: Plan) -> tuple[int, ...]:
    """Definition 10. Vertices in the order they are matched/stored."""
    p = plan.pattern
    pivot_unit = {u.piv: j for j, u in enumerate(plan.units)}
    order: list[int] = [plan.units[0].piv]
    for u in plan.units:
        def key(lf: int):
            if lf in pivot_unit:                      # (3)(iii) + (1)
                return (0, pivot_unit[lf], 0, lf)
            return (1, 0, -p.degree(lf), lf)          # (3)(ii)
        for lf in sorted(u.leaves, key=key):
            order.append(lf)
    assert len(order) == p.n and len(set(order)) == p.n
    return tuple(order)


# --------------------------------------------------------------------------- #
# CDS / plan enumeration
# --------------------------------------------------------------------------- #
def _is_dominating(p: Pattern, subset: tuple[int, ...]) -> bool:
    dom = set(subset)
    for u in subset:
        dom.update(p.adj(u))
    return len(dom) == p.n


def _is_connected_subset(p: Pattern, subset: tuple[int, ...]) -> bool:
    ss = set(subset)
    start = subset[0]
    seen = {start}
    stack = [start]
    while stack:
        u = stack.pop()
        for w in p.adj(u):
            if w in ss and w not in seen:
                seen.add(w)
                stack.append(w)
    return seen == ss


def minimum_cds(p: Pattern) -> list[tuple[int, ...]]:
    """All minimum connected dominating sets (c_P = their size)."""
    # single-vertex special case (stars): any vertex adjacent to all others
    for size in range(1, p.n + 1):
        found = [s for s in itertools.combinations(range(p.n), size)
                 if _is_dominating(p, s) and _is_connected_subset(p, s)]
        if found:
            return found
    raise RuntimeError("no CDS found (pattern disconnected?)")


def _leaf_assignments(p: Pattern, pivots: tuple[int, ...], cap: int = 4096):
    """Yield, for each non-pivot-0 vertex, the unit index it joins as a leaf.

    Constraints: leaf v of unit i requires edge (piv_i, v); if v is pivot of
    unit j, it must join a unit i < j (so dp_j.piv in V_{P_{j-1}}).
    """
    pivot_pos = {pv: j for j, pv in enumerate(pivots)}
    others = [v for v in range(p.n) if v != pivots[0]]
    choices: list[list[int]] = []
    for v in others:
        cand = []
        limit = pivot_pos.get(v, len(pivots))
        for i, pv in enumerate(pivots):
            if i >= limit:
                break
            if p.has_edge(pv, v):
                cand.append(i)
        if not cand:
            return  # this pivot ordering cannot host v
        choices.append(cand)
    total = 1
    for c in choices:
        total *= len(c)
        if total > cap:
            break
    if total > cap:
        # too many: greedy (earliest unit) single assignment
        yield {v: c[0] for v, c in zip(others, choices)}
        return
    for combo in itertools.product(*choices):
        yield dict(zip(others, combo))


def enumerate_plans(p: Pattern, max_plans: int = 20000) -> list[Plan]:
    plans: list[Plan] = []
    seen: set[tuple] = set()
    for cds in minimum_cds(p):
        for pivots in itertools.permutations(cds):
            for assign in _leaf_assignments(p, pivots):
                leaves: list[list[int]] = [[] for _ in pivots]
                ok = True
                for v, i in assign.items():
                    leaves[i].append(v)
                if any(not lf for lf in leaves):
                    ok = False      # every unit needs >= 1 leaf (Def. 6)
                if not ok:
                    continue
                units = tuple(Unit(pv, tuple(sorted(lf)))
                              for pv, lf in zip(pivots, leaves))
                if units in seen:
                    continue
                seen.add(units)
                plan = Plan(pattern=p, units=units)
                try:
                    plan.validate()
                except AssertionError:
                    continue
                plans.append(plan)
                if len(plans) >= max_plans:
                    return plans
    return plans


def best_plan(p: Pattern, rho: float = 1.0) -> Plan:
    """Apply the paper's rules; always returns a valid plan."""
    plans = enumerate_plans(p)
    if not plans:
        # degenerate: single unit with pivot = max-degree vertex (star pattern
        # where some vertex is adjacent to all others is guaranteed by CDS=1;
        # reaching here means leaf-assignment failed => fall back to BFS plan)
        return bfs_fallback_plan(p)
    min_span = min(pl.pattern.span(pl.units[0].piv) for pl in plans)
    plans = [pl for pl in plans
             if pl.pattern.span(pl.units[0].piv) == min_span]
    plans.sort(key=lambda pl: (-pl.score(rho), tuple((u.piv, u.leaves) for u in pl.units)))
    chosen = plans[0]
    return Plan(pattern=p, units=chosen.units,
                matching_order=compute_matching_order(chosen))


def bfs_fallback_plan(p: Pattern) -> Plan:
    """BFS-tree plan from the max-degree vertex (always valid, maybe not
    minimum rounds). Used as RanS/RanM-style baseline material too."""
    root = max(range(p.n), key=p.degree)
    seen = {root}
    units: list[Unit] = []
    frontier = [root]
    while len(seen) < p.n:
        nxt = []
        for u in frontier:
            lf = tuple(w for w in p.adj(u) if w not in seen)
            if lf:
                units.append(Unit(u, lf))
                seen.update(lf)
                nxt.extend(lf)
        frontier = nxt
    plan = Plan(pattern=p, units=tuple(units))
    plan.validate()
    return Plan(pattern=p, units=plan.units,
                matching_order=compute_matching_order(plan))


def random_star_plan(p: Pattern, seed: int = 0) -> Plan:
    """RanS baseline (App. C.2): random star decomposition, no optimization."""
    import random
    rng = random.Random(seed)
    verts = list(range(p.n))
    while True:
        root = rng.choice(verts)
        seen = {root}
        units: list[Unit] = []
        frontier = [root]
        ok = True
        while len(seen) < p.n:
            cands = [u for u in frontier if any(w not in seen for w in p.adj(u))]
            if not cands:
                ok = False
                break
            u = rng.choice(cands)
            avail = [w for w in p.adj(u) if w not in seen]
            k = rng.randint(1, len(avail))
            lf = tuple(rng.sample(avail, k))
            units.append(Unit(u, lf))
            seen.update(lf)
            frontier.extend(lf)
        if ok:
            plan = Plan(pattern=p, units=tuple(units))
            try:
                plan.validate()
            except AssertionError:
                continue
            return Plan(pattern=p, units=plan.units,
                        matching_order=compute_matching_order(plan))


def min_rounds_unscored_plan(p: Pattern) -> Plan:
    """RanM baseline (App. C.2): minimum rounds, no §4.2/§4.3 heuristics —
    take the *first* enumerated minimum-round plan."""
    plans = enumerate_plans(p, max_plans=1)
    plan = plans[0] if plans else bfs_fallback_plan(p)
    return Plan(pattern=p, units=plan.units,
                matching_order=compute_matching_order(plan))
