"""Distribution of the port: only the optimization-flag context the MoE
block reads (:mod:`.ctx`); sharding comes with the multi-card slices."""
