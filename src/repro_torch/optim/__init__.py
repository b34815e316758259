"""AdamW with the reference's formulas (``optim/adamw.py``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, schedule)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "schedule"]
