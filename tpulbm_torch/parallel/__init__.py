"""Several devices: the mesh of shards, the halo exchange between them and
the sharded chunk stepper (port of tpulbm/parallel/, 2-D single-phase)."""
