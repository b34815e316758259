"""Distribution of the port: the optimization-flag context the MoE block
reads (:mod:`.ctx`) and the trainer's int8 error-feedback gradient
compression (:mod:`.compression`); sharding comes with the multi-card
slices."""
