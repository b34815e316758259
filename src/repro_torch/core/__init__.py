"""RADS / R-Meef distributed subgraph enumeration: planner, engine,
adjacency cache, scheduler and driver (dense storage, raw wire, ``sim``
exchange in this slice of the port)."""
from repro_torch.core.query import Pattern
from repro_torch.core.plan import (Plan, Unit, best_plan, enumerate_plans,
                                   minimum_cds, bfs_fallback_plan,
                                   random_star_plan, min_rounds_unscored_plan,
                                   compute_matching_order)
from repro_torch.core.engine import (PlanData, build_plan_data, run_rounds,
                                     WaveState, init_wave, fetch_stage,
                                     expand_stage, verify_stage,
                                     finalize_wave)
from repro_torch.core.cache import AdjCache, build_cache
from repro_torch.core.scheduler import (GroupQueue, PipelineScheduler,
                                        StageRunner)
from repro_torch.core.driver import (rads_enumerate, EnumerationResult,
                                     extract_embeddings)
from repro_torch.core.priors import load_priors, priors_key, save_priors
from repro_torch.core.oracle import (enumerate_oracle, count_oracle,
                                     canonicalize)
from repro_torch.core.region import (iter_region_groups, make_region_groups,
                                     proximity_groups)
from repro_torch.core.exchange import Exchange, SimExchange

__all__ = [
    "Pattern", "Plan", "Unit", "best_plan", "enumerate_plans", "minimum_cds",
    "bfs_fallback_plan", "random_star_plan", "min_rounds_unscored_plan",
    "compute_matching_order", "PlanData", "build_plan_data", "run_rounds",
    "WaveState", "init_wave",
    "fetch_stage", "expand_stage", "verify_stage", "finalize_wave",
    "load_priors", "priors_key", "save_priors",
    "AdjCache", "build_cache",
    "GroupQueue", "PipelineScheduler", "StageRunner",
    "iter_region_groups",
    "rads_enumerate", "EnumerationResult", "extract_embeddings",
    "enumerate_oracle", "count_oracle", "canonicalize",
    "make_region_groups", "proximity_groups", "Exchange", "SimExchange",
]
