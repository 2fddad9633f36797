"""FmmTree: the black-box FMM evaluator on torch tensors.

Port of the single-device ``FmmTree`` of ``ferreus_rbf_tpu/ops/fmm/api.py``.
The octree, interaction lists, M2L operators and the source bucket layout
are built once on the host in numpy (``tree.py``, ``cheb.py``, ``m2l.py``)
and moved to ``device`` as flat tensors; the compressed M2L levels come from
``m2l``'s memo where an earlier tree of the same kernel, order, compression,
epsilon and cell length built them. A target set is binned on ``device``:
its (n, d) coordinates are copied there once (from page-locked memory on a
card, so the copy waits for no pass before it), and its leaves (a search
of each level's sorted leaf keys), rows, u- and w-list tables and inverse
map are built with torch ops, with one read of their sizes back to the
host (``_bin_targets``). One matvec is

* upward pass: P2M as one batched matmul against the leaf anterpolation
  weights, then M2M per level (one einsum + index_add);
* downward pass: M2L per level as two batched einsums over per-vector
  (U, V^T) stacks, chunked over target cells; P2L over the x-list on the
  near-field kernel (target cells' Chebyshev nodes as targets); L2L;
* leaf pass: L2P against the target anterpolation weights, then the near
  field (:func:`near_field.near_field`: u-list P2P and w-list M2P on the
  same tile kernels), then a gather back to target order.

Two memory budgets decide what stays resident at scale. The P2M table
(leaves, smax, p^d) and each target set's L2P table (rows, T, p^d) are
precomputed while their float64 bytes stay within ``_WEIGHT_TABLE_BYTES``;
above it the weights are computed per leaf chunk and per row chunk inside
the pass, with transients of at most ``(1 << 23) * eval_chunk_size / 1024``
elements (the JAX package's ``_upward`` and ``_l2p_impl``). The M2P node
tiles (each w-list cell's p^d nodes, float64 plus a float32 copy) are kept
while their bytes stay within ``FERREUS_RBF_TPU_NODETILE_BYTES`` (default
1.5e9, the JAX package's variable and default); above it the tree is
*gated* (``_m2p_tiles_gated``): no node tiles are stored, the w-list table
holds global cell ids, and the M2P runs on :func:`near_field.near_field_cells`,
which computes each cell's nodes while it stages them.

``precision="f32"`` runs every pass in float32 (the solver's inner
matvec); ``"f64"`` runs every pass in float64. Results come back float64.

Gradients with respect to the target coordinates (``evaluate_with_gradients``,
``evaluate_leaves_with_gradients``) are float64 only, as in the JAX package:
L2P against the anterpolation weights' derivatives, and P2P and M2P through
:func:`near_field.near_field_grad`. Values come back (n, nrhs), gradients
(n, nrhs * d), rhs-major and dim-minor. After :meth:`FmmTree.set_local_coefficients`
(one full downward pass) the leaf-only ``evaluate_leaves*`` calls evaluate
any target set without a downward pass.

The tree's ``device`` defaults to the CUDA card; pass ``device="cpu"`` to
run on the CPU (the kernels' plain versions).

A tree built under ``parallel.use_mesh`` keeps the mesh, and its
``evaluate_device`` shares the P2M (blocks of leaves), the M2L (blocks of
target slots) and the leaf pass (L2P over blocks of target rows, the near
field's P2P and M2P over target rows) out over the ranks, each pass joined
by one all-reduce; the M2M, P2L and L2L and every other entry point stay
replicated, as in the JAX package. Every batched pass, sharded or not,
walks the same pieces (``parallel.pieces``, each pass's block count set by
its size), and the near field computes each row from that row's own work
items however the rows are split, so a sharded matvec gives one rank's
bits.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...config import FmmCompressionType, FmmParams
from ...parallel import sharding
from ...utils.timing import count, record_event, to_device, traced_stage
from ..kernels import Kernel, KernelParams, make_kernel
from . import cheb, m2l, tree as tree_mod
from .near_field import (build, near_field, near_field_cells, near_field_cells_grad,
                         near_field_grad)
from .tree import Octree, PointOutsideTreeError, calculate_tree_center_and_radius

__all__ = ["FmmTree", "KernelDoesNotSupportGradientsError", "PointOutsideTreeError",
           "resolve_device"]

_PRECISIONS = {"f32": torch.float32, "f64": torch.float64}

# Largest float64 P2M or L2P weight table (bytes) kept resident; larger
# tables are computed per chunk inside the pass. Resident tables are the
# faster path wherever they fit (weight_budget.py): this keeps config 4 at
# 1M points resident (a 10.5 GB P2M table, ~43 GB peak with the f32
# copies) and bounds what a larger tree keeps on an 80 GB card.
_WEIGHT_TABLE_BYTES = 12e9

# Fewest items in a block of a sharded P2M or L2P with resident weights
# (``parallel.pass_blocks``): a pass of fewer than twice as many is one
# block. One card walks every block, and each block of these passes is a
# call of its own: 16 blocks cost the 1M f32 matvec +0.7%, blocks of at
# least 2048 (7 and 8 there) +0.3%, and split no worse over 4 or 8 ranks;
# the small passes (config 2, albatite) stay whole (PERF.md,
# pieces_price.py). The M2L, and these passes when their weights are made
# per chunk, cut their blocks at their own chunks' bounds, where blocks
# cost one card nothing: they take ``parallel.BLOCKS`` blocks.
_MIN_BLOCK_LEAVES = 2048  # P2M leaves
_MIN_BLOCK_ROWS = 2048  # L2P target rows


class KernelDoesNotSupportGradientsError(ValueError):
    def __init__(self):
        super().__init__(
            "FMM evaluation failed: gradient evaluation requested but kernel "
            "does not support gradients"
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card. Without a card and with no device named this raises; it
    never moves to the CPU silently. Under an active mesh it is the mesh's
    device for this rank, and a device named that is not it raises
    ``ValueError``."""
    mesh = sharding.active_mesh()
    if mesh is not None:
        if device is None:
            return mesh.device
        dev = torch.device(device)
        if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
            raise ValueError(f"device {dev} is not this rank's mesh device {mesh.device}")
        return mesh.device
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _next_pow2(n) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class FmmTree:
    """Black-box FMM over a fixed set of source points."""

    def __init__(
        self,
        source_points,
        interpolation_order: int,
        kernel_params: KernelParams,
        adaptive_tree: bool = True,
        sparse: bool = False,
        extents=None,
        params: FmmParams | None = None,
        device=None,
    ):
        pts = np.asarray(source_points, np.float64)
        if pts.ndim != 2 or pts.shape[1] not in (1, 2, 3):
            raise ValueError(f"Unsupported source point shape {pts.shape}")
        self._points = pts
        self.device = resolve_device(device)
        self.mesh = sharding.active_mesh()
        if sharding.sharded(self.mesh) and self.device.type == "cuda":
            sharding.rank0_first(build, self.mesh)  # one nvcc, loaded by the other ranks
        self.p = int(interpolation_order)
        self.d = pts.shape[1]
        self.nnodes = self.p**self.d
        self.kernel_params = kernel_params
        self.kernel_np: Kernel = make_kernel(kernel_params, xp=np)
        self.params = params if params is not None else FmmParams(
            interpolation_order=self.p, epsilon=10.0 ** (-self.p)
        )
        if extents is None:
            extents = np.concatenate([pts.min(axis=0), pts.max(axis=0)])
        center, radius = calculate_tree_center_and_radius(np.asarray(extents, np.float64))
        self._world_center = np.asarray(center, np.float64)

        with traced_stage("fmm_octree_build"):
            self.tree: Octree = tree_mod.build_tree(
                pts, center, radius, self.params.max_points_per_cell,
                store_empty_leaves=not sparse, dimensions=self.d, adaptive=adaptive_tree,
            )
        with traced_stage("fmm_operators"):
            self._build_operators()
        with traced_stage("fmm_plan"):
            self._build_plan()
        with traced_stage("fmm_device_state"):
            self._build_device_state()

        # fixed target-bucket width (leaves with more targets span rows)
        self._tmax = min(128, _next_pow2(max(self.smax, 8)))
        self._target_cache = {}
        self._weight_tiles = None
        self._multipole = None
        self._local = None

    # ------------------------------------------------------------ operators
    def _build_operators(self):
        t = self.tree
        nodes = cheb.chebyshev_nodes(self.p)
        self.nodes_t, _ = cheb.chebyshev_polynomials(nodes, self.p)
        self.nodes_nd = cheb.nodes_tensor_product(nodes, self.d)
        self.m2m_ops = cheb.m2m_transfer_matrices(self.p, self.d)
        self.perm_tables = m2l.build_permutation_tables(self.p, self.d)
        compression = {
            FmmCompressionType.None_: "None",
            FmmCompressionType.SVD: "SVD",
            FmmCompressionType.ACA: "ACA",
        }[self.params.compression_type]
        with traced_stage("fmm_m2l_build"):
            self.level_ops = m2l.build_level_operators(
                self.kernel_params, self.p, self.d, t.radius, t.depth, compression,
                self.params.epsilon,
            )

    # ------------------------------------------------------------ plan
    def _build_plan(self):
        t = self.tree
        d = self.d

        # --- source leaf buckets; row nsl is the empty sentinel tile ------
        counts = np.diff(t.leaf_offsets)
        smax = int(counts.max()) if counts.size else 1
        nsl = t.leaf_cells.size
        src_idx = np.zeros((nsl + 1, smax), np.int64)
        src_mask = np.zeros((nsl + 1, smax), bool)
        if nsl:
            sm = np.arange(smax)[None, :] < counts[:, None]
            src_idx[:nsl][sm] = (t.leaf_offsets[:-1, None] + np.arange(smax)[None, :])[sm]
            src_mask[:nsl] = sm
        self.smax = smax
        self.nsl = nsl
        self.src_leaf_cells = t.leaf_cells
        self.src_bucket_idx = src_idx  # into the SORTED point arrays
        self.src_bucket_mask = src_mask
        self.points_sorted = self._points[t.point_order]
        self.cell_to_src_row = np.full(t.num_cells, -1, np.int64)
        self.cell_to_src_row[t.leaf_cells] = np.arange(nsl)

        # --- M2M (has_points only) / L2L (all cells) level groups --------
        # one padded (2^d, cmax) child/parent table per level; pad slots
        # gather row 0 and scatter into the sink row num_cells
        def octant_groups(cells, scatter_child: bool):
            octants = t.child_octant[cells]
            no = 1 << d
            cmax = max(int(np.bincount(octants, minlength=no).max()), 1)
            ch_t = np.full((no, cmax), t.num_cells if scatter_child else 0, np.int64)
            pa_t = np.full((no, cmax), 0 if scatter_child else t.num_cells, np.int64)
            for o in range(no):
                sel = cells[octants == o]
                ch_t[o, : sel.size] = sel
                pa_t[o, : sel.size] = t.parent[sel]
            return ch_t, pa_t

        self.m2m_groups = []  # deep -> shallow; gathers ch, scatters pa
        self.l2l_groups = []  # shallow -> deep; gathers pa, scatters ch
        for level in range(t.depth, 0, -1):
            up_cells = t.cells_at_level(level)
            up_cells = up_cells[t.has_points[up_cells]]
            if up_cells.size:
                self.m2m_groups.append(octant_groups(up_cells, scatter_child=False))
        for level in range(1, t.depth + 1):
            cells = t.cells_at_level(level)
            if cells.size:
                self.l2l_groups.append(octant_groups(cells, scatter_child=True))

        # --- M2L: per level, one (U_v, Vt_v) per m2l vector id present ----
        # The symmetry permutations are folded into the operators here, so
        # the device pass is plain batched matmuls. Target-slot layout: one
        # column per target cell, one row per vector id; each (vid, tgt)
        # has at most one source (a vid names a relative offset). Sources
        # index the level's compact source block; index n_src = zero row.
        pt = self.perm_tables
        vp = t.v_pairs
        if vp.shape[0]:
            vp = vp[t.has_points[vp[:, 1]]]
        lv = t.levels[vp[:, 0]] if vp.shape[0] else np.zeros(0, np.int64)
        self.m2l_levels = []  # (U_stack, Vt_stack|None, src_tab, src_cells, level_cells)
        nnodes = self.nnodes
        for level in range(2, t.depth + 1):
            sel = vp[lv == level] if vp.shape[0] else vp
            if sel.shape[0] == 0:
                continue
            vids = sel[:, 2]
            present = np.unique(vids)
            g = len(present)
            level_cells = np.unique(sel[:, 0])
            slot_of = np.full(t.num_cells + 1, -1, np.int64)
            slot_of[level_cells] = np.arange(level_cells.size)
            src_list = np.unique(sel[:, 1])
            n_src = src_list.size
            src_cells = np.concatenate([src_list, [t.num_cells]])
            local_of = np.full(t.num_cells + 1, n_src, np.int64)
            local_of[src_list] = np.arange(n_src)
            src_tab = np.full((g, level_cells.size), n_src, np.int64)
            vid_row = np.full(int(present.max()) + 1, -1, np.int64)
            vid_row[present] = np.arange(g)
            src_tab[vid_row[vids], slot_of[sel[:, 0]]] = local_of[sel[:, 1]]
            dense = self.level_ops[level][0][1] is None
            rmax = (
                nnodes
                if dense
                else max(self.level_ops[level][r][0].shape[1] for r in range(pt.num_reference))
            )
            u_stack = np.zeros((g, nnodes, rmax))
            vt_stack = None if dense else np.zeros((g, rmax, nnodes))
            for gi, v in enumerate(present):
                u, vt = self.level_ops[level][pt.ref_lookup[v]]
                pid = pt.perm_lookup[v]
                rows = pt.perm_indices[pid]
                inv = pt.inverse_perm[pid]
                if dense:
                    # y = (K @ x[rows])[inv], both gathers folded into K
                    k2 = np.zeros_like(u)
                    k2[:, rows] = u
                    u_stack[gi] = k2[inv]
                else:
                    # y = (U @ (Vt @ x[rows]))[inv] -> U_v = U[inv], Vt_v[:, rows] = Vt
                    u_stack[gi, :, : u.shape[1]] = u[inv]
                    vt2 = np.zeros((vt.shape[0], nnodes))
                    vt2[:, rows] = vt
                    vt_stack[gi, : vt.shape[0]] = vt2
            self.m2l_levels.append((u_stack, vt_stack, src_tab, src_cells, level_cells))

        # --- P2L (x list), grouped by target cell ------------------------
        # Each target cell's Chebyshev nodes form one row of targets and its
        # x-list source leaves the row's neighbour tiles, so P2L runs on the
        # near-field kernel: (cells, U_x) tile table + per-cell counts.
        xp = t.x_pairs
        src_rows = self.cell_to_src_row[xp[:, 1]] if xp.shape[0] else np.zeros(0, np.int64)
        keep = src_rows >= 0
        tgt = xp[keep, 0] if xp.shape[0] else np.zeros(0, np.int64)
        order = np.argsort(tgt, kind="stable")
        self.p2l_cells, p2l_cnt = np.unique(tgt[order], return_counts=True)
        self.p2l_cnt = p2l_cnt.astype(np.int32)
        ux = int(p2l_cnt.max()) if p2l_cnt.size else 1
        self.p2l_tab = np.full((self.p2l_cells.size, ux), nsl, np.int32)
        self.p2l_tab[np.arange(ux)[None, :] < p2l_cnt[:, None]] = src_rows[keep][order]

        all_cells = np.arange(t.num_cells)
        self.cell_centers = t.cell_centers(all_cells)
        self.cell_lengths = t.cell_lengths(all_cells)

    # ------------------------------------------------------- device state
    def _tensor(self, a, dtype=None):
        return to_device(np.ascontiguousarray(a), self.device, dtype)

    def _build_device_state(self):
        """Index tensors in ``self._dev``; float tensors in f64 in
        ``self._floats64`` (f32 copies are made on first f32 use).

        Geometry is stored relative to the tree centre: the kernels are
        translation-invariant, and the f32 tier then keeps its digits for
        real-world coordinates (UTM eastings/northings ~1e6-1e7)."""
        d = self.d
        center = self._world_center
        long = torch.int64
        cell_centers_c = self.cell_centers - center
        pts_c = self.points_sorted - center
        nsl = self.nsl
        mask = self.src_bucket_mask

        # source tiles (nsl+1, d, smax); pad slots sit at the tree centre
        tiles = np.where(mask[:, None, :], pts_c[self.src_bucket_idx].transpose(0, 2, 1), 0.0)
        nodes_t = self._tensor(self.nodes_t)
        self._dev = {
            "src_orig": self._tensor(self.tree.point_order[self.src_bucket_idx], long),
            "src_mask": self._tensor(mask),
            # live source slots per tile (the leading ones; 0 for the sentinel)
            "src_scnt": self._tensor(mask.sum(1).astype(np.int32)),
            "leaf_cells": self._tensor(self.src_leaf_cells, long),
            "m2m_groups": [(self._tensor(c, long), self._tensor(p, long))
                           for c, p in self.m2m_groups],
            "l2l_groups": [(self._tensor(c, long), self._tensor(p, long))
                           for c, p in self.l2l_groups],
            "m2l_levels": [(self._tensor(st, long), self._tensor(sc, long),
                            self._tensor(lc, long))
                           for _u, _vt, st, sc, lc in self.m2l_levels],
            # every level's target cells end to end (each cell on one level)
            "m2l_cells": self._tensor(np.concatenate(
                [lc for *_, lc in self.m2l_levels] or [np.zeros(0, np.int64)]), long),
            "p2l_cells": self._tensor(self.p2l_cells, long),
            "p2l_nbr": self._tensor(self.p2l_tab.T),
            "p2l_cnt": self._tensor(self.p2l_cnt),
        }
        p2l_nodes = cheb.scale_nodes_to_cell(
            self.nodes_nd, cell_centers_c[self.p2l_cells], self.cell_lengths[self.p2l_cells]
        )
        self._floats64 = {
            "src_tiles": self._tensor(tiles),
            "m2m_ops": self._tensor(self.m2m_ops),
            "m2l": [(self._tensor(u), None if vt is None else self._tensor(vt))
                    for u, vt, _st, _sc, _lc in self.m2l_levels],
            "p2l_nodes": self._tensor(p2l_nodes),
            "nodes_t": nodes_t,
            "cell_centers": self._tensor(cell_centers_c),
            "cell_lengths": self._tensor(self.cell_lengths),
        }
        self._floats32 = None
        # P2M anterpolation weights (nsl, smax, p^d), pad slots zeroed; kept
        # only within the budget (else computed per leaf chunk in _upward)
        self.p2m_bytes = nsl * self.smax * self.nnodes * 8
        if self.p2m_bytes <= _WEIGHT_TABLE_BYTES:
            self._floats64["p2m_w"] = cheb.anterpolation_weights_torch(
                self._floats64["src_tiles"][:nsl].transpose(1, 2),
                self._floats64["cell_centers"][self._dev["leaf_cells"]],
                self._floats64["cell_lengths"][self._dev["leaf_cells"]],
                nodes_t, d,
            ) * self._dev["src_mask"][:nsl, :, None]

        # --- M2P cell-node tiles ------------------------------------------
        # Each w-list cell with points is a source tile of its p^d Chebyshev
        # nodes; its multipole coefficients are the tile's weights (rebuilt
        # each matvec by one gather). Tile nw is the zero sentinel. Above
        # the node-tile budget the tree is gated: no tiles, and the M2P
        # computes the nodes of the listed cells while it stages them.
        wc = self.tree.w_pairs[:, 1]
        wc = np.unique(wc[self.tree.has_points[wc]])
        nw = int(wc.size)
        self.m2p_cells = nw
        self.nodetile_bytes = (nw + 1) * d * self.nnodes * (8 + 4)  # f64 tiles + f32 copy
        budget = int(float(os.environ.get("FERREUS_RBF_TPU_NODETILE_BYTES", 1.5e9)))
        self._m2p_tiles_gated = bool(nw) and self.nodetile_bytes > budget
        if self._m2p_tiles_gated:
            nw = 0
            self._floats64["nodes_nd"] = self._tensor(self.nodes_nd)
        self._m2p_nw = nw
        record_event("fmm_tree", {
            "points": int(self._points.shape[0]), "leaves": nsl, "smax": self.smax,
            "p2m_bytes": self.p2m_bytes, "p2m_resident": "p2m_w" in self._floats64,
            "m2p_cells": self.m2p_cells, "nodetile_bytes": self.nodetile_bytes,
            "m2p_tiles_gated": self._m2p_tiles_gated})
        cell_to_wtile = None
        if nw:
            node_xyz = cheb.scale_nodes_to_cell(
                self.nodes_nd, cell_centers_c[wc], self.cell_lengths[wc])  # (nw, P, d)
            node_tiles = np.zeros((nw + 1, d, self.nnodes))
            node_tiles[:nw] = node_xyz.transpose(0, 2, 1)
            self._floats64["node_tiles"] = self._tensor(node_tiles)
            self._dev["wtile_cells"] = self._tensor(wc, long)
            cell_to_wtile = np.full(self.tree.num_cells, nw, np.int32)
            cell_to_wtile[wc] = np.arange(nw, dtype=np.int32)
        self._build_bin_state(cell_to_wtile)

    def _build_bin_state(self, cell_to_wtile):
        """What target binning reads on the device (``self._bin``): the
        tree's lower corner and deepest cell side, the sorted packed keys
        (``tree._pack``) of each level's leaves beside their cells (levels
        without leaves left out), and the u- and w-lists as CSR by target
        cell (``cnt`` and ``off`` per cell, ``flat`` with the table's
        sentinel appended). A u-list holds the source rows of the neighbour leaves with points,
        sentinel ``nsl``; a w-list the node tiles of the far cells with
        points (``cell_to_wtile``), sentinel ``nw``, or, gated, their cell
        ids, sentinel ``num_cells``; no w-list table without either."""
        t = self.tree
        long = torch.int64

        def csr(pairs, values, keep, sentinel):
            # stable by target cell: each cell's entries in list order
            order = np.argsort(pairs[:, 0], kind="stable")
            keep = keep[order]
            cnt = np.bincount(pairs[order, 0][keep], minlength=t.num_cells)
            return {"cnt": self._tensor(cnt, long), "off": self._tensor(np.cumsum(cnt) - cnt, long),
                    "flat": self._tensor(np.append(values[order][keep], sentinel), torch.int32)}

        src_rows = self.cell_to_src_row[t.u_pairs[:, 1]]
        far = t.w_pairs[:, 1]
        levels = []
        for level, (keys, cells) in enumerate(t._level_key_sorted):
            leaf = t.is_leaf[cells]
            if leaf.any():
                levels.append((level, self._tensor(keys[leaf], long),
                               self._tensor(cells[leaf], long)))
        w = None
        if self._m2p_tiles_gated:
            w = csr(t.w_pairs, far, t.has_points[far], t.num_cells)
        elif cell_to_wtile is not None:
            w = csr(t.w_pairs, cell_to_wtile[far], t.has_points[far], self._m2p_nw)
        self._bin = {
            "lo": self._tensor(t.center - t.radius),
            "side": self._tensor(np.full(self.d, 2.0 * t.radius / (1 << t.depth))),
            "center": self._tensor(self._world_center),
            "levels": levels,
            "u": csr(t.u_pairs, src_rows, src_rows >= 0, self.nsl),
            "w": w,
        }

    def _floats(self, dtype):
        if dtype == torch.float64:
            return self._floats64
        if self._floats32 is None:
            self._floats32 = {
                k: ([(u.float(), None if vt is None else vt.float()) for u, vt in v]
                    if k == "m2l" else v.float())
                for k, v in self._floats64.items()
            }
        return self._floats32

    # ------------------------------------------------------------ targets
    def _bin_targets(self, target_points, reuse_key=None, with_grads=False):
        """Bucket targets by leaf into rows of width T, on the tree's device
        (:meth:`_binned_tables`), and make the L2P weights (with their
        derivatives when ``with_grads``) within the budget. A set binned
        anew adds its targets to the counter ``fmm_targets_binned``; one
        taken from the cache by ``reuse_key`` adds none, and reads nothing
        back from the device."""
        if reuse_key is not None and reuse_key in self._target_cache:
            binned = self._target_cache[reuse_key]
            if with_grads and binned["l2p_resident"] and "l2p_dw" not in binned:
                rows = binned["tcnt"].shape[0]
                if self._l2p_fits(rows, True):
                    binned["l2p_dw"] = self._l2p_weights(binned, True)[1]
                else:
                    # kept weights, derivatives past the budget: this
                    # gradient pass makes them per chunk
                    record_event("fmm_targets", {"targets": binned["ntargets"], "rows": rows,
                                                 "l2p_resident": False, "kept": True})
            return binned

        # the binning's transients are freed when it returns, before the
        # L2P table is made
        binned = self._binned_tables(np.ascontiguousarray(target_points, np.float64))
        n, ntl = binned["ntargets"], binned["tcnt"].shape[0]
        # L2P weights kept only within the budget (else per row chunk)
        binned["l2p_resident"] = self._l2p_fits(ntl, with_grads)
        record_event("fmm_targets", {"targets": n, "rows": ntl,
                                     "l2p_resident": binned["l2p_resident"]})
        if binned["l2p_resident"]:
            weights = self._l2p_weights(binned, with_grads)
            if with_grads:
                binned[torch.float64]["l2p_w"], binned["l2p_dw"] = weights
            else:
                binned[torch.float64]["l2p_w"] = weights
        if reuse_key is not None:
            self._target_cache[reuse_key] = binned
        return binned

    def _binned_tables(self, targets):
        """The row tables of an (n, d) host target set, built with torch ops
        on the tree's device from one copy of the targets:

        * ``tcells`` (rows,) int64: each row's leaf, leaves ascending, a
          leaf with more than T targets on consecutive rows;
        * ``tcnt`` (rows,) int32: live target slots per row (the leading
          ones), targets in input order within a leaf;
        * ``nbr`` (U, rows) int32: each row's u-list source tiles, padded
          with the sentinel tile ``nsl``;
        * ``wtab`` (Uw, rows) int32 and ``wcnt`` (rows,) int32: its w-list
          tiles (cell ids when gated) and their count, or None where no
          row has a w-list;
        * ``inv_flat`` (n,) int64: each target's row * T + slot;
        * ``tpts`` (rows, T, d) float64 under ``torch.float64``: the
          targets less the tree centre, pad slots repeating target 0.

        One host read (``fmm_bin_host_syncs``) brings back, together, the
        first target outside the tree (``PointOutsideTreeError``) and the
        tables' sizes."""
        b, dev, tmax = self._bin, self.device, self._tmax
        targets = torch.from_numpy(targets)
        if dev.type == "cuda":
            # from page-locked memory the copy and the launches below queue
            # behind the pass before them instead of waiting for it
            targets = targets.pin_memory()
        targets = to_device(targets, dev)
        n = targets.shape[0]
        count("fmm_targets_binned", n)
        leaf, first_bad = self._target_leaves(targets)
        # leaves ascending, each leaf's targets in input order
        sorted_leaf, order = torch.sort(leaf, stable=True)
        cells = torch.arange(self.tree.num_cells, device=dev)
        off_c = torch.searchsorted(sorted_leaf, cells)
        cnt_c = torch.searchsorted(sorted_leaf, cells, right=True) - off_c
        nrow_c = (cnt_c + tmax - 1) // tmax
        row_off_c = torch.cumsum(nrow_c, 0) - nrow_c
        live = cnt_c > 0
        uw = (b["w"]["cnt"] * live).max() if b["w"] is not None else first_bad.new_zeros(())
        count("fmm_bin_host_syncs")
        first_bad, ntl, u_max, uw_max = torch.stack(
            [first_bad, nrow_c.sum(), (b["u"]["cnt"] * live).max(), uw]).tolist()
        if first_bad < n:
            raise PointOutsideTreeError(first_bad)

        rcell = torch.repeat_interleave(nrow_c, output_size=ntl)  # row -> its leaf
        rrank = torch.arange(ntl, device=dev) - row_off_c[rcell]
        rlen = (cnt_c[rcell] - rrank * tmax).clamp_(max=tmax)
        # each target's flat (row, slot): its leaf's first row, then its rank
        flat = row_off_c[sorted_leaf] * tmax + torch.arange(n, device=dev) - off_c[sorted_leaf]
        inv_flat = torch.empty_like(flat).scatter_(0, order, flat)
        tgt_idx = torch.zeros(ntl * tmax, dtype=torch.int64, device=dev).scatter_(0, flat, order)
        tpts = targets[tgt_idx.view(ntl, tmax)]  # pad slots read target 0
        tpts -= b["center"]

        def table(lists, width):
            """(width, rows) entries of each row's list, padded with the
            list's sentinel, and the rows' counts."""
            cnt = lists["cnt"][rcell]
            slot = torch.arange(width, device=dev)[:, None]
            pos = torch.where(slot < cnt, lists["off"][rcell] + slot, lists["flat"].numel() - 1)
            return lists["flat"][pos], cnt.int()

        nbr = table(b["u"], max(u_max, 1))[0]
        wtab, wcnt = table(b["w"], uw_max) if uw_max else (None, None)
        return {"ntargets": n, "tcells": rcell, "tcnt": rlen.int(), "nbr": nbr, "wtab": wtab,
                "wcnt": wcnt, "inv_flat": inv_flat, torch.float64: {"tpts": tpts}}

    def _target_leaves(self, targets):
        """Each target's leaf, as ``linear_tree.rs:487-520`` finds it: the
        deepest level whose cell holding the target exists and is a leaf,
        from a search of each level's sorted leaf keys (a leaf has no cells
        below it, so at most one level finds one; targets on the tree's max
        faces count as inside); and, as a device scalar, the first target
        outside the tree or on no leaf (n if none)."""
        b = self._bin
        depth = self.tree.depth
        top = float(1 << depth)
        n = targets.shape[0]
        # divided by a device tensor: true division, as on the host (a CUDA
        # division by a host scalar multiplies by its reciprocal)
        f = torch.floor((targets - b["lo"]) / b["side"])
        inside = ((f >= 0) & (f <= top)).all(1)  # on a max face: anchor 2^depth, inside
        anchors = torch.where(inside[:, None], f.clamp(max=top - 1), 0.0).long()
        bits = tree_mod._AXIS_BITS
        packed = torch.zeros((n,), dtype=torch.int64, device=self.device)
        for j in range(self.d - 1, -1, -1):  # ``tree._anchor_key``
            packed = (packed << bits) | anchors[:, j]
        leaf = torch.full_like(packed, -1)
        for level, keys, cells in b["levels"]:
            # the anchors >> s of every axis at once: shift the packed key,
            # then clear the bits each axis took from the one above it
            s = depth - level
            axis_mask = sum(((1 << (bits - s)) - 1) << (bits * j) for j in range(self.d))
            key = (((packed >> s) & axis_mask) << 5) | level  # ``tree._pack``
            pos = torch.searchsorted(keys, key).clamp_(max=keys.numel() - 1)
            leaf = torch.where(keys[pos] == key, cells[pos], leaf)
        bad = torch.where((leaf < 0) | ~inside, torch.arange(n, device=self.device), n)
        return leaf, torch.cat([bad, bad.new_full((1,), n)]).min()

    def _l2p_fits(self, rows, with_grads) -> bool:
        """Whether the L2P tables of ``rows`` target rows stay within
        ``_WEIGHT_TABLE_BYTES``: the (rows, T, p^d) f64 weights and, with
        ``with_grads``, their d derivative tables beside them."""
        return rows * self._tmax * self.nnodes * 8 * (1 + self.d * with_grads) \
            <= _WEIGHT_TABLE_BYTES

    def _l2p_resident(self, binned, with_grads) -> bool:
        """Whether a pass over a binned target set reads kept L2P tables
        (the derivatives too, ``with_grads``), or makes them per chunk."""
        return binned["l2p_resident"] and (not with_grads or "l2p_dw" in binned)

    def _l2p_weights(self, binned, with_grads, rows=slice(None), values=True):
        """L2P anterpolation weights (rows, T, p^d) of a binned target set,
        and with ``with_grads`` their derivatives (rows, T, d, p^d), f64,
        for the row slice ``rows``; ``values=False`` makes the derivatives
        only (the weights come back None)."""
        f64 = self._floats64
        tc = binned["tcells"][rows]
        return cheb.anterpolation_weights_torch(
            binned[torch.float64]["tpts"][rows], f64["cell_centers"][tc],
            f64["cell_lengths"][tc], f64["nodes_t"], self.d, with_gradients=with_grads,
            values=values,
        )

    def _chunk(self, per_item: int) -> int:
        """Items per chunk of a chunked pass: the transient stays within
        ``(1 << 23) * eval_chunk_size / 1024`` elements."""
        elems = (1 << 23) * max(int(self.params.eval_chunk_size), 1) // 1024
        return max(1, elems // max(per_item, 1))

    def _binned_floats(self, binned, dtype):
        if dtype not in binned:
            binned[dtype] = {k: v.to(dtype) for k, v in binned[torch.float64].items()}
        return binned[dtype]

    def prepare_targets(self, target_points, reuse_key) -> None:
        """Bind a named target set for :meth:`evaluate_device`."""
        self._bin_targets(target_points, reuse_key)

    # ------------------------------------------------------------ passes
    def _weight_tiles_of(self, weights, dtype):
        """(nsl+1, nrhs, smax) bucketed weights; pad slots and the sentinel
        tile are zero."""
        w = weights.to(dtype)[self._dev["src_orig"]] * self._dev["src_mask"][..., None]
        return w.transpose(1, 2).contiguous()

    def _upward(self, wt, fs, mesh=None):
        """P2M + M2M -> multipole expansions (ncells, p^d, nrhs); under a
        sharded ``mesh`` each rank anterpolates its pieces of leaves and one
        all-reduce joins them (the M2M is replicated)."""
        ncells = self.tree.num_cells
        nr = wt.shape[1]
        leaves = self._dev["leaf_cells"]
        resident = "p2m_w" in fs
        # weights per chunk are made in f64 and rounded to the pass's dtype,
        # as the resident table's f32 copy is: both paths give the same sums
        p2m = sharding.share_buffer(wt, (self.nsl, nr, self.nnodes), mesh)
        for _, l0, l1 in self._p2m_pieces(resident, mesh):
            sl = slice(l0, l1)
            if resident:
                w = fs["p2m_w"][sl]
            else:
                f64 = self._floats64
                w = (cheb.anterpolation_weights_torch(
                    f64["src_tiles"][sl].transpose(1, 2), f64["cell_centers"][leaves[sl]],
                    f64["cell_lengths"][leaves[sl]], f64["nodes_t"], self.d,
                ) * self._dev["src_mask"][sl, :, None]).to(wt.dtype)
            torch.bmm(wt[sl], w, out=p2m[sl])
        sharding.all_reduce_sum(p2m, mesh)
        mult = wt.new_zeros((ncells + 1, self.nnodes, nr))  # row ncells = sink
        mult[leaves] = p2m.transpose(1, 2)
        # A parent takes up to 2^d children, one per octant; within one
        # octant row the parents are unique. One index_add_ per octant, in
        # octant order, adds each parent's children in a fixed order, so
        # repeat passes on the card are bitwise equal (one add over all
        # octants would race its atomics).
        for ch, pa in self._dev["m2m_groups"]:
            contrib = torch.einsum("opq,ocqr->ocpr", fs["m2m_ops"], mult[ch])
            for o in range(pa.shape[0]):
                mult.index_add_(0, pa[o], contrib[o])
        return mult[:ncells]

    def _downward(self, mult, wt, fs, mesh=None):
        """M2L + P2L, then L2L -> local expansions (ncells, p^d, nrhs);
        under a sharded ``mesh`` each rank contracts its pieces of the
        levels' target slots and one all-reduce joins them (P2L and L2L are
        replicated)."""
        ncells = self.tree.num_cells
        nn = self.nnodes
        nr = mult.shape[2]
        levels = self._dev["m2l_levels"]
        sizes, plan = self._m2l_pieces(nr, mesh)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        m2l = sharding.share_buffer(mult, (int(offsets[-1]), nn, nr), mesh)  # slots end to end
        mult_pad = torch.cat([mult, mult.new_zeros((1, nn, nr))])
        src_level = None
        for li, c0, c1 in plan:
            (u, vt), (src_tab, src_cells, _) = fs["m2l"][li], levels[li]
            if li != src_level:  # the level's sources once, + zero row
                src_level, mult_src = li, mult_pad[src_cells]
            x = mult_src[src_tab[:, c0:c1]]  # (g, c, p^d, r)
            z = x if vt is None else torch.einsum("gkq,gcqr->gckr", vt, x)
            m2l[offsets[li] + c0 : offsets[li] + c1] = torch.einsum("gpk,gckr->cpr", u, z)
        sharding.all_reduce_sum(m2l, mesh)
        local = mult.new_zeros((ncells + 1, nn, nr))  # row ncells = sink
        local[self._dev["m2l_cells"]] = m2l

        if self._dev["p2l_cells"].numel():
            local[self._dev["p2l_cells"]] += near_field(
                fs["p2l_nodes"], fs["src_tiles"], wt, self._dev["p2l_nbr"],
                self._dev["p2l_cnt"], kparams=self.kernel_params, scnt=self._dev["src_scnt"])

        # each child has one parent: the scatter writes unique rows (and the
        # discarded sink), so one index_add_ per level is deterministic
        for ch, pa in self._dev["l2l_groups"]:
            contrib = torch.einsum("opq,ocpr->ocqr", fs["m2m_ops"], local[pa])
            local.index_add_(0, ch.reshape(-1), contrib.reshape(-1, nn, nr))
        return local[:ncells]

    def _l2p(self, binned, fs, local, with_grads=False, mesh=None):
        """L2P at a binned target set: values (rows, T, r) and, with
        ``with_grads``, gradients (rows, T, d, r), in the dtype of ``fs``;
        under a sharded ``mesh`` only this rank's pieces of rows are filled,
        the other rows are 0."""
        bs = self._binned_floats(binned, fs["nodes_t"].dtype)
        rows, t, d = bs["tpts"].shape
        nr = local.shape[2]
        vals = sharding.share_buffer(local, (rows, t, nr), mesh)
        grads = sharding.share_buffer(local, (rows, t, d, nr), mesh) if with_grads else None
        # per-chunk weights are made in f64 and rounded to the pass's dtype
        for _, r0, r1 in self._l2p_pieces(binned, with_grads, mesh):
            sl = slice(r0, r1)
            loc = local[binned["tcells"][sl]]  # (c, p^d, r)
            if self._l2p_resident(binned, with_grads):
                w = bs["l2p_w"][sl]
                dw = binned["l2p_dw"][sl] if with_grads else None
            elif binned["l2p_resident"]:  # kept weights, derivatives per chunk
                w = bs["l2p_w"][sl]
                dw = self._l2p_weights(binned, True, sl, values=False)[1]
            else:
                w = self._l2p_weights(binned, with_grads, sl)
                w, dw = w if with_grads else (w, None)
                w = w.to(loc.dtype)
            torch.bmm(w, loc, out=vals[sl])
            if with_grads:
                # einsum("ltdp,lpr->ltdr") as one bmm over (T*d) weight rows
                torch.bmm(dw.flatten(1, 2), loc, out=grads[sl].view(-1, t * d, nr))
        return (vals, grads) if with_grads else vals

    def _p2m_pieces(self, resident, mesh):
        """The P2M's pieces of leaves on this rank (``parallel.pieces``):
        chunks of leaves when the weights are made per chunk."""
        if resident:
            return sharding.pieces([self.nsl], mesh, None,
                                   sharding.pass_blocks(self.nsl, _MIN_BLOCK_LEAVES))
        return sharding.pieces([self.nsl], mesh, [self._chunk(self.smax * self.nnodes)])

    def _m2l_pieces(self, nr, mesh):
        """(slots per level, this rank's pieces of them): each level cut
        into chunks whose gathered sources stay within the budget."""
        budget = (1 << 24) * max(int(self.params.eval_chunk_size), 1) // 1024
        levels = self._dev["m2l_levels"]
        sizes = [src_tab.shape[1] for src_tab, _, _ in levels]
        steps = [max(1, budget // (src_tab.shape[0] * self.nnodes * nr))
                 for src_tab, _, _ in levels]
        return sizes, sharding.pieces(sizes, mesh, steps)

    def _l2p_pieces(self, binned, with_grads, mesh):
        """The L2P's pieces of target rows on this rank: chunks of rows when
        the weights are made per chunk."""
        rows, t = binned["tcnt"].shape[0], binned[torch.float64]["tpts"].shape[1]
        if self._l2p_resident(binned, with_grads):
            return sharding.pieces([rows], mesh, None, sharding.pass_blocks(rows, _MIN_BLOCK_ROWS))
        d = self.d if with_grads else 0
        made = d + (not binned["l2p_resident"])  # tables made per chunk
        return sharding.pieces([rows], mesh, [self._chunk(t * self.nnodes * made)])

    def _rank_rows(self, binned, mesh):
        """This rank's contiguous rows of a binned target set for the near
        field, and their tables: (lo, hi, nbr, tcnt, wtab, wcnt). The near
        field computes each row from that row's own work items whatever
        rows a call holds, so the rows are split evenly over the ranks, one
        block each. Under a sharded ``mesh`` the slices are made once per
        target set and kept, so the work lists kept on them
        (``nbr._work_items``) are built once."""
        if not sharding.sharded(mesh):
            return (0, binned["tcnt"].shape[0], binned["nbr"], binned["tcnt"], binned["wtab"],
                    binned["wcnt"])
        if "rank_rows" not in binned:
            mine = sharding.rank_blocks(binned["tcnt"].shape[0], mesh)
            lo, hi = mine.start, mine.stop
            wtab = binned["wtab"]
            binned["rank_rows"] = (
                lo, hi, binned["nbr"][:, lo:hi].contiguous(), binned["tcnt"][lo:hi],
                None if wtab is None else wtab[:, lo:hi].contiguous(),
                None if wtab is None else binned["wcnt"][lo:hi])
        return binned["rank_rows"]

    def _leaf(self, binned, dtype, fs, local, mult, wt, mesh=None):
        """L2P + near field (P2P, M2P) at a binned target set -> (n, nrhs);
        under a sharded ``mesh`` each rank runs its L2P pieces and its near
        field rows, and one all-reduce joins them before the un-bucketing.
        A row's near field is summed first and added to its L2P value once:
        where the L2P and the near field of a row fall to two ranks, the
        all-reduce adds the very two numbers that one rank adds."""
        bs = self._binned_floats(binned, dtype)
        nr = local.shape[2]
        vals = self._l2p(binned, fs, local, mesh=mesh)  # (rows, T, r)
        lo, hi, nbr, tcnt, wtab, wcnt = self._rank_rows(binned, mesh)
        if hi > lo:
            tpts = bs["tpts"][lo:hi]
            near = near_field(tpts, fs["src_tiles"], wt, nbr, kparams=self.kernel_params,
                              tcnt=tcnt, scnt=self._dev["src_scnt"])
            if wtab is not None and self._m2p_tiles_gated:
                near += near_field_cells(tpts, wtab, wcnt, *self._cell_geometry(), mult,
                                         kparams=self.kernel_params, tcnt=tcnt)
            elif wtab is not None:
                near += near_field(tpts, fs["node_tiles"], self._m2p_tiles(mult), wtab, wcnt,
                                   kparams=self.kernel_params, tcnt=tcnt)
            vals[lo:hi].add_(near)
        sharding.all_reduce_sum(vals, mesh)
        return vals.reshape(-1, nr)[binned["inv_flat"]]

    def shares(self, reuse_key, nrhs: int = 1) -> dict:
        """This rank's share of a sharded ``evaluate_device`` of ``nrhs``
        columns at a prepared target set: (owned, total) leaves of the P2M,
        target slots of the M2L, target rows of the L2P and target rows of
        the near field."""
        binned = self._target_cache[reuse_key]
        sizes, m2l = self._m2l_pieces(nrhs, self.mesh)
        lo, hi = self._rank_rows(binned, self.mesh)[:2]
        rows = binned["tcnt"].shape[0]

        def owned(plan, total):
            return (sum(b - a for _, a, b in plan), int(total))

        return {"leaves": owned(self._p2m_pieces("p2m_w" in self._floats64, self.mesh), self.nsl),
                "m2l_slots": owned(m2l, sum(sizes)),
                "l2p_rows": owned(self._l2p_pieces(binned, False, self.mesh), rows),
                "rows": (hi - lo, rows)}

    def _cell_geometry(self):
        """(centres, lengths, reference nodes), float64, for the gated M2P."""
        f64 = self._floats64
        return f64["cell_centers"], f64["cell_lengths"], f64["nodes_nd"]

    def _leaf_with_grads(self, binned):
        """f64 L2P + near field with target gradients against the kept
        locals -> (n, nrhs) values and (n, nrhs * d) gradients."""
        fs = self._floats64
        tpts = binned[torch.float64]["tpts"]
        d = tpts.shape[2]
        nr = self._local.shape[2]
        vals, grads = self._l2p(binned, fs, self._local, with_grads=True)
        grads = grads.transpose(2, 3).contiguous()  # (rows, T, r, d)
        kp = self.kernel_params
        tcnt = binned["tcnt"]
        legs = [near_field_grad(tpts, fs["src_tiles"], self._weight_tiles, binned["nbr"],
                                kparams=kp, tcnt=tcnt, scnt=self._dev["src_scnt"])]
        if binned["wtab"] is not None and self._m2p_tiles_gated:
            legs.append(near_field_cells_grad(tpts, binned["wtab"], binned["wcnt"],
                                              *self._cell_geometry(), self._multipole,
                                              kparams=kp, tcnt=tcnt))
        elif binned["wtab"] is not None:
            legs.append(near_field_grad(tpts, fs["node_tiles"], self._m2p_tiles(self._multipole),
                                        binned["wtab"], binned["wcnt"], kparams=kp, tcnt=tcnt))
        for v, g in legs:
            vals += v
            grads += g
        inv = binned["inv_flat"]
        return vals.reshape(-1, nr)[inv], grads.reshape(-1, nr * d)[inv]

    def _m2p_tiles(self, mult):
        """(nw + 1, nrhs, p^d) M2P weight tiles: each w-list cell's multipole
        coefficients; the last tile is the zero sentinel."""
        mt = mult.new_zeros((self._m2p_nw + 1, mult.shape[2], self.nnodes))
        mt[:-1] = mult[self._dev["wtile_cells"]].transpose(1, 2)
        return mt

    # ------------------------------------------------------------ public
    @property
    def source_points(self) -> np.ndarray:
        return self._points

    def _as_weights(self, weights):
        w = to_device(weights, self.device, torch.float64)
        return w.reshape(self._points.shape[0], -1)

    def set_weights(self, weights) -> None:
        """Upward pass (P2M + M2M) at f64."""
        fs = self._floats64
        self._weight_tiles = self._weight_tiles_of(self._as_weights(weights), torch.float64)
        with traced_stage("fmm_upward"):
            self._multipole = self._upward(self._weight_tiles, fs)
        self._local = None

    def set_local_coefficients(self, weights) -> None:
        """Full-tree downward pass at f64, kept; enables ``evaluate_leaves``."""
        if self._multipole is None:
            self.set_weights(weights)
        with traced_stage("fmm_downward"):
            self._local = self._downward(self._multipole, self._weight_tiles, self._floats64)

    def _check_gradients(self):
        if not self.kernel_np.supports_gradients:
            raise KernelDoesNotSupportGradientsError()

    def evaluate_device(self, weights_dev, reuse_key, precision: str = "f64"):
        """Full matvec at a prepared target set, device tensor in and out.

        ``weights_dev`` (N, nrhs) on ``self.device``; returns (n_targets,
        nrhs) float64. ``precision`` "f32" runs every pass in float32. Under
        the tree's mesh every rank passes the same weights and gets the same
        result, its passes shared out over the ranks.
        """
        dtype = _PRECISIONS[precision]
        binned = self._target_cache[reuse_key]
        fs = self._floats(dtype)
        wt = self._weight_tiles_of(weights_dev, dtype)
        mult = self._upward(wt, fs, self.mesh)
        local = self._downward(mult, wt, fs, self.mesh)
        return self._leaf(binned, dtype, fs, local, mult, wt, self.mesh).to(torch.float64)

    def evaluate(self, weights, target_points, reuse_key=None) -> np.ndarray:
        """Downward + leaf pass at ``target_points`` (f64); host array out."""
        self.set_local_coefficients(weights)
        return self.evaluate_leaves(weights, target_points, reuse_key)

    def evaluate_with_gradients(self, weights, target_points, reuse_key=None):
        """Downward + leaf pass with target gradients (f64): host arrays
        (n, nrhs) and (n, nrhs * d)."""
        self._check_gradients()
        self.set_local_coefficients(weights)
        return self.evaluate_leaves_with_gradients(weights, target_points, reuse_key)

    def evaluate_leaves(self, weights, target_points, reuse_key=None) -> np.ndarray:
        """Leaf pass only, against the locals of the last downward pass
        (:meth:`set_local_coefficients`)."""
        if self._local is None:
            raise RuntimeError("call set_local_coefficients before evaluate_leaves")
        with traced_stage("fmm_bin_targets"):
            binned = self._bin_targets(target_points, reuse_key)
        with traced_stage("fmm_leaf"):
            vals = self._leaf(binned, torch.float64, self._floats64, self._local,
                              self._multipole, self._weight_tiles)
            return vals.cpu().numpy()

    def evaluate_leaves_with_gradients(self, weights, target_points, reuse_key=None):
        self._check_gradients()
        if self._local is None:
            raise RuntimeError("call set_local_coefficients before evaluate_leaves")
        with traced_stage("fmm_bin_targets"):
            binned = self._bin_targets(target_points, reuse_key, with_grads=True)
        with traced_stage("fmm_leaf_grad"):
            vals, grads = self._leaf_with_grads(binned)
            return vals.cpu().numpy(), grads.cpu().numpy()
