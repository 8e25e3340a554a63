"""Parallelism: the rank mesh, row-sharded tables and the mesh step.

Port of `oovrec_tpu/parallel/`: `distributed.py` (the process-group
bootstrap, the metric map-reduce), `mesh.py` (the ('data', 'model') mesh
over ranks, the placement rules, batch placement, host copies),
`sharded_embedding.py` (the sharded tables and their psum / all-to-all
exchanges, checkpoint layouts) and `train_step.py` (the global batch's
step on each rank). The modules are imported where they are used: the
models' layers import this package, and it imports them."""
