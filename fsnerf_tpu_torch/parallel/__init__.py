"""Data-parallel layer (port of fsnerf_tpu/parallel/): the process group
(mesh.py), ray-sharded training and tiled frame rendering
(train_parallel.py).

One process per GPU, launched by torchrun. Rays are i.i.d., so sharding
each step's ray batch over the ranks and averaging the gradients is the
single-GPU step's math; the weights, the Adam state and the occupancy grid
stay replicated. A frame's rays are marched rank by rank and gathered.
Runs without a mesh never touch this package: the single-GPU step and
renderer hold no collectives.
"""

from .mesh import (Mesh, batch_sharding, distributed_init, make_hybrid_mesh,
                   make_mesh, replicate, shard_batch)
