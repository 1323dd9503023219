"""Several devices: the mesh of shards, the halo exchange between them, the
sharded chunk stepper and several processes on torch.distributed (port of
tpulbm/parallel/)."""
