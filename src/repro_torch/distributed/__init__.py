"""Distribution of the port: the optimization-flag context the MoE block,
GAT and the mesh plan read (:mod:`.ctx`), the int8 gradient compression
(:mod:`.compression`: the trainer's error feedback and
``compressed_psum``), and the per-parameter sharding rules of the
production meshes (:mod:`.sharding`)."""
