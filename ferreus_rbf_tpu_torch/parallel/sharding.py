"""Meshes of ranks and the helpers that the sharded passes share.

The counterpart of ``ferreus_rbf_tpu/parallel/sharding.py``. The JAX
package annotates its batched tensors and lets GSPMD partition the
programs; here there is one process per rank (SPMD), every rank builds the
same host plan from the same points, each rank computes its own share of
the items of a pass (leaves, target slots, target rows, Schwarz domains)
into a zero buffer, and one explicit ``torch.distributed`` all-reduce joins
the shares. Each item of a pass belongs to exactly one rank, so the sum
adds zeros to a single contribution and is exact (the leaf pass's row may
take its L2P value from one rank and its near field, summed first, from
another: the all-reduce then adds the very two numbers one rank adds).

Bit for bit against one rank: a batched cuBLAS call may pick another
algorithm for another batch count, so a pass is cut into pieces that do
not depend on the world size (:func:`pieces`): blocks over the pass's
items, as many as the pass's size gives (:func:`pass_blocks`: blocks of
at least a minimum that the pass sets, at most ``BLOCKS``), cut again at
group boundaries and at the pass's own chunk size. One rank walks every
piece; ``n`` ranks each walk their own contiguous run of blocks
(:func:`rank_blocks`) and make the very calls that one rank makes for
them. A rank past a pass's blocks owns nothing of it and adds zeros to
its all-reduce.
"""

from __future__ import annotations

import bisect
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# The most blocks a pass is cut into, and so the most ranks of an "sp"
# axis (the largest mesh of the JAX package's scaling curve): make_mesh
# refuses more, since a rank past every pass's blocks would own nothing.
# A pass takes fewer blocks where its batches would be too small to fill
# the card (pass_blocks), so a large pass splits up to 16 ways and a small
# one costs one card no extra launches (PERF.md has the one-card price).
BLOCKS = 16


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: ``group`` is the process group of this rank's
    ``"sp"`` axis (the default group for a one-axis mesh), ``rank`` and
    ``size`` the global rank and world size, ``device`` this rank's
    device, ``backend`` "nccl" or "gloo", ``shape`` the mesh's shape over
    ``axis_names`` and ``coords`` this rank's coordinates in it."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple
    shape: tuple
    coords: tuple

    @property
    def capturable(self) -> bool:
        """False when a CUDA graph cannot hold the passes' all-reduces:
        gloo's, over more than one "sp" rank on a card, go through the host.
        NCCL's can be captured; a CPU mesh captures nothing anyway."""
        return not (self.device.type == "cuda" and self.backend == "gloo"
                    and shard_axis_size(self, "sp") > 1)


def _largest_factor_leq(n: int, k: int) -> int:
    k = max(1, min(k, n))
    for f in range(k, 0, -1):
        if n % f == 0:
            return f
    return 1


def _mesh_shape(n: int, axis_names) -> tuple:
    """The JAX package's rule: one axis takes all ranks; several split the
    factors as evenly as they can, the last axis taking the rest."""
    if len(axis_names) == 1:
        return (n,)
    shape, rem = [], n
    for _ in axis_names[:-1]:
        f = _largest_factor_leq(rem, int(round(rem ** (1 / len(axis_names)))))
        shape.append(f)
        rem //= f
    return tuple(shape) + (rem,)


def make_mesh(n_devices: int | None = None, axis_names=("sp",), *, device_type="cuda",
              backend=None) -> Mesh:
    """Join the default process group (or initialise it from ``torchrun``'s
    environment) and return this rank's :class:`Mesh`.

    Backends, never chosen silently: ``device_type="cuda"`` runs over NCCL
    with rank r on ``cuda:r`` (its local rank), and raises ``RuntimeError``
    without a card or with more ranks than cards, unless ``backend="gloo"``,
    under which every rank shares ``cuda:0`` when the cards are too few;
    ``device_type="cpu"`` runs over gloo. ``n_devices``, when given, must
    be the world size.

    Only the ``"sp"`` axis shards anything, as in the JAX package, where no
    module shards over ``"rhs"`` either (only its root dry run places one
    RHS block over that axis by hand): ranks that differ only in another
    axis compute the same shares. The ``"sp"`` axis holds at most
    ``BLOCKS`` ranks (no pass is cut into more blocks, so a further rank
    would own nothing): a larger one raises ``ValueError``.
    """
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"a CPU mesh runs over gloo, not {backend}")
        backend = "gloo"
    elif device_type == "cuda":
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"a CUDA mesh runs over nccl or gloo, not {backend}")
        backend = backend or "nccl"
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card is available: pass device_type="cpu" for a '
                               "mesh on the CPU")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")

    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if dist.get_backend() != backend:
            raise ValueError(f"the default process group runs {dist.get_backend()}, "
                             f"not {backend}")
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise RuntimeError("no process group: start the ranks with torchrun, or call "
                           "torch.distributed.init_process_group first")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh in a world of {world} ranks")
    names = tuple(axis_names)
    shape = _mesh_shape(world, names)
    if "sp" in names and shape[names.index("sp")] > BLOCKS:
        raise ValueError(f"the 'sp' axis of a {world}-rank mesh {dict(zip(names, shape))} "
                         f"exceeds {BLOCKS} ranks, the most blocks that a pass is cut into")

    if device_type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if local_world <= cards:
            device = torch.device("cuda", local_rank)
        elif backend == "gloo":
            device = torch.device("cuda", 0)
        else:
            raise RuntimeError(
                f"{local_world} ranks on this host but {cards} CUDA card(s): NCCL needs one "
                f'card per rank; pass backend="gloo" to share cuda:0')
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend)

    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    group = dist.group.WORLD
    if "sp" in names and shape[names.index("sp")] < world:
        # one "sp" group per coordinate of the other axes; every rank makes
        # every group, in the same order
        axis = names.index("sp")
        rows = np.moveaxis(np.arange(world).reshape(shape), axis, -1).reshape(-1, shape[axis])
        for ranks in rows:
            g = dist.new_group(ranks.tolist())
            if rank in ranks:
                group = g
    mesh = Mesh(group, rank, world, device, backend, names, shape, coords)
    # the first collective sets up the communicator, outside any capture
    all_reduce_sum(torch.zeros(1, device=device), mesh)
    return mesh


def shard_axis_size(mesh: Mesh | None, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 when absent / no mesh)."""
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[mesh.axis_names.index(axis)])


def sharded(mesh: Mesh | None) -> bool:
    """True when ``mesh`` splits a pass over more than one rank."""
    return shard_axis_size(mesh, "sp") > 1


def rank_blocks(n_blocks: int, mesh: Mesh | None) -> range:
    """This rank's contiguous run of whole blocks out of ``n_blocks`` (all
    of them without a mesh); the runs of the ranks differ by at most one
    block."""
    sp = shard_axis_size(mesh, "sp")
    if sp == 1:
        return range(n_blocks)
    c = mesh.coords[mesh.axis_names.index("sp")]
    return range(n_blocks * c // sp, n_blocks * (c + 1) // sp)


def pass_blocks(total: int, min_block: int) -> int:
    """Blocks of a pass of ``total`` items: as many as hold ``min_block``
    items each, at least 1 and at most ``BLOCKS``. It depends on the pass
    and never on the world size."""
    return max(1, min(BLOCKS, int(total) // max(int(min_block), 1)))


def _block_bounds(total: int, blocks: int) -> list:
    nb = min(blocks, BLOCKS, total)
    return [total * b // nb for b in range(nb + 1)] if nb else [0]


def rank_range(n: int, mesh: Mesh | None, blocks: int = BLOCKS) -> tuple:
    """(lo, hi): the items of ``range(n)``, cut into ``blocks`` blocks (at
    most ``BLOCKS``), in this rank's blocks."""
    bounds = _block_bounds(n, blocks)
    mine = rank_blocks(len(bounds) - 1, mesh)
    return bounds[mine.start], bounds[mine.stop]


def _snap(bound: int, starts: list, steps) -> int:
    """A block bound moved to the nearest of its group's step cuts (the
    lower on a tie); a bound on a group boundary, or in a group without a
    step, stays."""
    g = bisect.bisect_right(starts, bound) - 1
    if g >= len(steps) or bound == starts[g] or steps[g] is None:
        return bound
    step = max(int(steps[g]), 1)
    lower = starts[g] + (bound - starts[g]) // step * step
    upper = min(lower + step, starts[g + 1])
    return lower if bound - lower <= upper - bound else upper


def pieces(sizes, mesh: Mesh | None, steps=None, blocks: int = BLOCKS) -> list:
    """This rank's pieces of a pass over groups of items, as (group, lo,
    hi) with ``lo:hi`` within the group.

    The groups' items are laid end to end and cut into ``blocks`` blocks
    (at most ``BLOCKS``), a number the pass fixes without the world size
    (:func:`pass_blocks`); the rank takes its run of blocks
    (:func:`rank_blocks`). The pieces are the rank's items cut at the
    group boundaries, at every ``steps[g]`` items from a group's start
    (where ``steps[g]`` is not None) and at the block bounds. A block bound
    inside a group with a step moves to the nearest of that group's step
    cuts, so there the blocks add no piece to the chunks that the pass
    walks anyway. The cuts do not depend on the world size, so one rank
    walks the very pieces that ``n`` ranks share."""
    steps = steps or [None] * len(sizes)
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + int(size))
    cuts = set(starts)
    for g, step in enumerate(steps):
        if step is not None:
            cuts.update(range(starts[g], starts[g + 1], max(int(step), 1)))
    bounds = [_snap(b, starts, steps) for b in _block_bounds(starts[-1], blocks)]
    mine = rank_blocks(len(bounds) - 1, mesh)
    lo, hi = bounds[mine.start], bounds[mine.stop]
    cuts = sorted(c for c in cuts | set(bounds) if lo <= c <= hi)
    out = []
    for a, b in zip(cuts, cuts[1:]):
        g = bisect.bisect_right(starts, a) - 1  # the group that starts at or before a
        out.append((g, a - starts[g], b - starts[g]))
    return out


def share_buffer(like: torch.Tensor, shape, mesh: Mesh | None) -> torch.Tensor:
    """A buffer, shaped ``shape`` like ``like``, for this rank's pieces of
    a pass: zeros under a sharded ``mesh`` (the other ranks' items stay 0
    for the all-reduce), uninitialised otherwise (every piece is written)."""
    return like.new_zeros(shape) if sharded(mesh) else like.new_empty(shape)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum ``t`` in place over the ``"sp"`` axis and return it; a no-op
    without a mesh or for one rank. Under gloo a CUDA tensor goes through
    gloo's own staging on the host; NCCL reduces it on the card (and can be
    captured in a CUDA graph)."""
    if sharded(mesh):
        dist.all_reduce(t, group=mesh.group)
    return t


def rank0_first(fn, mesh: Mesh | None):
    """Run ``fn`` on global rank 0, then, after every rank has reached this
    point, on the others: a build that rank 0 leaves on disk is loaded by
    the rest, not raced."""
    if mesh is None or mesh.size == 1:
        return fn()
    out = fn() if mesh.rank == 0 else None
    dist.all_reduce(torch.zeros(1, device=mesh.device))  # every rank, default group
    return fn() if mesh.rank != 0 else out


# --------------------------------------------------------------------------
# The active mesh: the solver and FMM layers take it at construction,
# without a mesh argument threaded through every constructor.

_ACTIVE_MESH: Mesh | None = None


def active_mesh() -> Mesh | None:
    """The mesh installed by :func:`use_mesh`, or ``None`` (one device)."""
    return _ACTIVE_MESH


class use_mesh:
    """Context manager: state built inside is sharded over ``mesh``.

    While active, ``FmmTree`` and ``DDMTree`` take the mesh at construction:
    ``FmmTree.evaluate_device`` shares its P2M, M2L and leaf pass out over
    the ``"sp"`` ranks and ``DDMTree`` factors and solves only this rank's
    blocks of Schwarz domains; entry points run on the mesh's device.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False

