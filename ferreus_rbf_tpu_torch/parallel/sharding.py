"""Meshes of ranks and the helpers that the sharded passes share.

The counterpart of ``ferreus_rbf_tpu/parallel/sharding.py``. The JAX
package annotates its batched tensors and lets GSPMD partition the
programs; here there is one process per rank (SPMD), every rank builds the
same host plan from the same points, each rank computes its own share of
the items of a pass (leaves, target slots, target rows, Schwarz domains)
into a zero buffer, and one explicit ``torch.distributed`` all-reduce joins
the shares. Each item of a pass belongs to exactly one rank, so the sum
adds zeros to a single contribution and is exact.

Bit for bit against one rank: a batched cuBLAS call may pick another
algorithm for another batch count, so a pass is cut into pieces that do
not depend on the world size (:func:`pieces`): at most ``BLOCKS`` blocks
over the pass's items (fewer where a pass's batches would be too small to
fill the card), cut again at group boundaries and at the pass's own
chunk size. One rank walks every piece; ``n`` ranks each walk their own
contiguous run of blocks (:func:`rank_blocks`) and make the very calls
that one rank makes for them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# Blocks a pass is cut into, and so the most ranks of an "sp" axis:
# make_mesh refuses more, since a rank without a block would own nothing.
# One rank walks them all, so each block costs a one-card matvec a few
# launches (PERF.md has the one-card price of 4 and of 8 blocks).
BLOCKS = 4


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
    ``BLOCKS`` ranks (a pass is cut into that many blocks, so a further
    rank would own nothing): a larger one raises ``ValueError``.
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
                         f"exceeds {BLOCKS} ranks, the most that a pass's {BLOCKS} blocks "
                         f"can share out")

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


def _block_bounds(total: int, blocks: int = BLOCKS) -> list:
    nb = min(blocks, BLOCKS, total)
    return [total * b // nb for b in range(nb + 1)] if nb else [0]


def rank_range(n: int, mesh: Mesh | None, blocks: int = BLOCKS) -> tuple:
    """(lo, hi): the items of ``range(n)``, cut into ``blocks`` blocks (at
    most ``BLOCKS``), in this rank's blocks."""
    bounds = _block_bounds(n, blocks)
    mine = rank_blocks(len(bounds) - 1, mesh)
    return bounds[mine.start], bounds[mine.stop]


def pieces(sizes, mesh: Mesh | None, steps=None, blocks: int = BLOCKS) -> list:
    """This rank's pieces of a pass over groups of items, as (group, lo,
    hi) with ``lo:hi`` within the group.

    The groups' items are laid end to end and cut into ``blocks`` blocks
    (at most ``BLOCKS``; :func:`rank_range`), a number the pass fixes
    without the world size; the pieces are the rank's blocks cut again at the
    group boundaries and, where ``steps[g]`` is not None, every
    ``steps[g]`` items from the group's start. The cuts do not depend on
    the world size, so one rank walks the very pieces that ``n`` ranks
    share."""
    steps = steps or [None] * len(sizes)
    lo, hi = rank_range(int(sum(sizes)), mesh, blocks)
    bounds = [b for b in _block_bounds(int(sum(sizes)), blocks) if lo <= b <= hi]
    out, g0 = [], 0
    for g, (size, step) in enumerate(zip(sizes, steps)):
        cuts = {min(max(b - g0, 0), size) for b in bounds}
        if step is not None:
            cuts.update(range(0, size, max(int(step), 1)))
        cuts = sorted(c for c in cuts | {0, size} if lo <= g0 + c <= hi)
        out.extend((g, a, b) for a, b in zip(cuts, cuts[1:]) if b > a)
        g0 += size
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

