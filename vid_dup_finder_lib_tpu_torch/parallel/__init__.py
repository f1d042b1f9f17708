"""Several devices: meshes, sharded hashing, the ring search.  Counterpart
of ``vid_dup_finder_lib_tpu/parallel``.

One process drives every shard of a :class:`.mesh.Mesh` (a list of
devices, which may repeat one card), as one JAX program drives a
``jax.sharding.Mesh``:

* data parallelism over the video batch for hashing
  (:func:`sharded_hash_batch`);
* ring parallelism over the library for the self-search: each shard owns
  a row block of the packed library, and column blocks move around the
  ring (:func:`banded_adjacency_ring`, :func:`ring_candidate_scan`);
* the references split over the shards, the candidates replicated
  (:func:`.refs_sharded.refs_adjacency_sharded`).
"""

from .mesh import make_mesh
from .sharded_search import (
    banded_adjacency_ring,
    ring_candidate_scan,
    sharded_hash_batch,
)

__all__ = [
    "banded_adjacency_ring",
    "make_mesh",
    "ring_candidate_scan",
    "sharded_hash_batch",
]
