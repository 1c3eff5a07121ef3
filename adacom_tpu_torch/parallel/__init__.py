"""Host-side parallelism: the morsel task scheduler. The multi-device
layer of the JAX package (parallel/ops.py, parallel/mesh.py) is not ported
yet."""
