"""Multi-rank scaling over ``torch.distributed``.

The counterpart of ``ferreus_rbf_tpu/parallel/``: SPMD with one process
per rank instead of a ``jax.sharding`` mesh. Every rank builds the same
host plan; the ``"sp"`` axis shares out

* the FMM matvec (``FmmTree.evaluate_device``): P2M over blocks of leaves,
  M2L over blocks of target slots, L2P over blocks of target rows, the
  near field (P2P, M2P) over target rows, each pass joined by one
  all-reduce (the L2P and the near field share one);
* the Schwarz leaf buckets (``DDMTree``): each rank factors and solves its
  blocks of domains (blocks of at least 4,096), joined by one all-reduce
  per level application.

The M2M, P2L, L2L, the coarse solve, the FGMRES arithmetic and every
evaluation outside ``evaluate_device`` stay replicated. Usage, one process
per rank (``torchrun --nproc-per-node N script.py``)::

    mesh = parallel.make_mesh()
    with parallel.use_mesh(mesh):
        rbfi = RBFInterpolator(points, values, settings)
"""

from .sharding import (
    BLOCKS,
    Mesh,
    active_mesh,
    all_reduce_sum,
    make_mesh,
    pass_blocks,
    pieces,
    rank0_first,
    rank_blocks,
    rank_range,
    shard_axis_size,
    share_buffer,
    sharded,
    use_mesh,
)

__all__ = [
    "BLOCKS",
    "Mesh",
    "active_mesh",
    "all_reduce_sum",
    "make_mesh",
    "pass_blocks",
    "pieces",
    "rank0_first",
    "rank_blocks",
    "rank_range",
    "shard_axis_size",
    "share_buffer",
    "sharded",
    "use_mesh",
]
