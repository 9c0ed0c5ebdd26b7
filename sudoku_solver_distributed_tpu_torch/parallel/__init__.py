"""Device-mesh execution and request scheduling: the port of the JAX
package's ``parallel/``.

  * data parallel (shard.py): a puzzle batch split over the mesh's ``data``
    axis (mesh.py), one kernel launch a shard — the throughput path;
  * search-frontier parallel (frontier.py): one hard board's disjoint
    subtrees raced across the shards to the first solution;
  * request coalescing (coalescer.py): concurrent single-board requests
    batched into the engine's buckets, closed or open loop;
  * the multi-host serving loop (serving_loop.py) on torch.distributed,
    and the virtual-mesh child harness (sim.py).

``parallel/compat.py`` of the JAX package, a ``shard_map`` shim, has no
counterpart.
"""

from .mesh import Mesh, data_sharding, default_mesh, replicated, virtual_mesh
from .shard import make_packed_serving_program, make_sharded_solver
from .frontier import frontier_solve, seed_frontier, state_handoff_frontier
from .serving_loop import FrontierServingLoop
from .coalescer import BatchCoalescer

__all__ = [
    "Mesh",
    "default_mesh",
    "virtual_mesh",
    "data_sharding",
    "replicated",
    "make_packed_serving_program",
    "make_sharded_solver",
    "frontier_solve",
    "seed_frontier",
    "state_handoff_frontier",
    "FrontierServingLoop",
    "BatchCoalescer",
]
