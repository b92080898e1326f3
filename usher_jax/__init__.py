"""usher_jax: maximum-parsimony phylogenetics on mutation-annotated trees, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of UShER
(placement of new samples on a mutation-annotated tree by maximum parsimony,
tree optimization, recombination detection, and MAT utilities).

Architecture (accelerator-first, not a port):
  - The MAT lives as dense tensors: per-node path-state matrix over segregating
    genome positions, parent indices, subtree leaf counts.
  - Placement scoring of all tree nodes x a batch of samples is one vectorized
    device kernel (ops/placement.py), replacing the per-node task-parallel
    traversal of the reference (see /root/reference/src/usher_mapper.cpp:167).
  - Whole-tree per-site Fitch-Sankoff is a level-synchronous vectorized scan
    with genome sites on vector lanes (ops/sankoff.py), replacing the
    per-site thread pool of the reference (src/usher_mapper.cpp:6).
  - Multi-device scaling uses jax.sharding Mesh (samples data-parallel x node
    shards), not MPI (see parallel/mesh.py).
"""

__version__ = "0.1.0"
