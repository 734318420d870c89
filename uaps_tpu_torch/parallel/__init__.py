"""Data-parallel training over ranks, one process per device: the port's
`uaps_tpu/parallel/` (mesh.py: the group, the rows and the replicated
state; ranks.py: what a step's forward and losses do on a rank, the one
module of the package that the models, losses and metrics import;
shardmap_step.py: shard_map mode's step)."""
