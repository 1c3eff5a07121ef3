"""Parallelism: the morsel task scheduler (scheduler.py) and the
multi-device layer, ported from the JAX package's parallel/: meshes and
leading-axis sharding (mesh.py), the collectives over per-shard tensors
(collectives.py) and the distributed operators (ops.py). With
Database(mesh=...), the executor runs scan-aggregates and large equi-joins
over a mesh's shards."""
