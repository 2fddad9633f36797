"""FmmTree: the black-box FMM evaluator on torch tensors.

Port of the single-device ``FmmTree`` of ``ferreus_rbf_tpu/ops/fmm/api.py``.
The octree, interaction lists, M2L operators and the bucket layout are
built once on the host in numpy (``tree.py``, ``cheb.py``, ``m2l.py``) and
moved to ``device`` as flat tensors. One matvec is

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
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...config import FmmCompressionType, FmmParams
from ...utils.timing import record_event, traced_stage
from ..kernels import Kernel, KernelParams, make_kernel
from . import cheb, m2l, tree as tree_mod
from .near_field import near_field, near_field_cells, near_field_cells_grad, near_field_grad
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


class KernelDoesNotSupportGradientsError(ValueError):
    def __init__(self):
        super().__init__(
            "FMM evaluation failed: gradient evaluation requested but kernel "
            "does not support gradients"
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card. Without a card and with no device named this raises; it
    never moves to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _next_pow2(n) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _concat_ranges(starts, lens):
    """Vectorised concat of [arange(s, s+l) for s, l in zip(starts, lens)]."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    off = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(off, lens) + np.repeat(starts, lens)


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
        self.level_ops = m2l.build_level_operators(
            self.kernel_np, self.p, self.d, t.radius, t.depth, compression,
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

        # --- u/w pair lookup sorted by target cell ------------------------
        self._u_sorted = t.u_pairs[np.argsort(t.u_pairs[:, 0], kind="stable")]
        self._w_sorted = t.w_pairs[np.argsort(t.w_pairs[:, 0], kind="stable")]

        all_cells = np.arange(t.num_cells)
        self.cell_centers = t.cell_centers(all_cells)
        self.cell_lengths = t.cell_lengths(all_cells)

    # ------------------------------------------------------- device state
    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

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
        wc = self._w_sorted[:, 1]
        wc = np.unique(wc[self.tree.has_points[wc]]) if wc.size else wc
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
        self._cell_to_wtile = None
        if nw:
            node_xyz = cheb.scale_nodes_to_cell(
                self.nodes_nd, cell_centers_c[wc], self.cell_lengths[wc])  # (nw, P, d)
            node_tiles = np.zeros((nw + 1, d, self.nnodes))
            node_tiles[:nw] = node_xyz.transpose(0, 2, 1)
            self._floats64["node_tiles"] = self._tensor(node_tiles)
            self._dev["wtile_cells"] = self._tensor(wc, long)
            cmap = np.full(self.tree.num_cells, nw, np.int32)
            cmap[wc] = np.arange(nw, dtype=np.int32)
            self._cell_to_wtile = cmap

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
        """Bucket targets by leaf into rows of width T; build the per-row
        u-list leaf-tile table, the w-list cell-tile table and the L2P
        weights (with their derivatives when ``with_grads``)."""
        if reuse_key is not None and reuse_key in self._target_cache:
            binned = self._target_cache[reuse_key]
            if with_grads and binned["l2p_resident"] and "l2p_dw" not in binned:
                binned["l2p_dw"] = self._l2p_weights(binned, True)[1]
            return binned

        targets = np.asarray(target_points, np.float64)
        n = targets.shape[0]
        leaf_of_target = self.tree.points_to_leaves(targets)
        tcells_u, tinv = np.unique(leaf_of_target, return_inverse=True)
        order = np.argsort(tinv, kind="stable")
        counts = np.bincount(tinv, minlength=tcells_u.size)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        nc = tcells_u.size

        tmax = self._tmax
        nrow_per_cell = -(-counts // tmax)
        ntl = int(nrow_per_cell.sum())
        rcell = np.repeat(np.arange(nc), nrow_per_cell)  # row -> cell (in tcells_u)
        rrank = _concat_ranges(np.zeros(nc, np.int64), nrow_per_cell)
        rstart = offsets[rcell] + rrank * tmax
        rlen = np.minimum(counts[rcell] - rrank * tmax, tmax)
        slot = np.arange(tmax)
        rmask = slot[None, :] < rlen[:, None]  # (ntl, tmax)
        tgt_idx = np.zeros((ntl, tmax), np.int64)  # pad slots read target 0
        tgt_idx[rmask] = order[(rstart[:, None] + slot[None, :])[rmask]]
        tcells = tcells_u[rcell]

        t = self.tree
        # u list -> neighbour source-leaf rows per cell
        lo_u = np.searchsorted(self._u_sorted[:, 0], tcells_u)
        hi_u = np.searchsorted(self._u_sorted[:, 0], tcells_u, side="right")
        pair_pos = _concat_ranges(lo_u, hi_u - lo_u)
        pair_cell = np.repeat(np.arange(nc), hi_u - lo_u)
        srows_all = self.cell_to_src_row[self._u_sorted[pair_pos, 1]]
        keep = srows_all >= 0
        flat_srows = srows_all[keep]
        nbr_cnt_c = np.bincount(pair_cell[keep], minlength=nc)
        nbr_off_c = np.cumsum(nbr_cnt_c) - nbr_cnt_c
        u_max = max(int(nbr_cnt_c.max()) if nc else 0, 1)
        nbr_tab = np.full((ntl, u_max), self.nsl, np.int32)
        nbr_cnt_row = nbr_cnt_c[rcell]
        nmask = np.arange(u_max)[None, :] < nbr_cnt_row[:, None]
        npos = nbr_off_c[rcell][:, None] + np.arange(u_max)[None, :]
        nbr_tab[nmask] = flat_srows[npos[nmask]]

        # w list -> (Uw, rows) table and per-row counts: node-tile ids
        # (sentinel nw), or global cell ids (sentinel num_cells) when gated
        wtab = wcnt = None
        if self._cell_to_wtile is not None or self._m2p_tiles_gated:
            lo_w = np.searchsorted(self._w_sorted[:, 0], tcells_u)
            hi_w = np.searchsorted(self._w_sorted[:, 0], tcells_u, side="right")
            wpos = _concat_ranges(lo_w, hi_w - lo_w)
            wcell = np.repeat(np.arange(nc), hi_w - lo_w)
            wcat = self._w_sorted[wpos, 1]
            wkeep = t.has_points[wcat]
            wcnt_c = np.bincount(wcell[wkeep], minlength=nc)
            if wcnt_c.size and wcnt_c.max() > 0:
                woff_c = np.cumsum(wcnt_c) - wcnt_c
                uw_max = int(wcnt_c.max())
                gated = self._m2p_tiles_gated
                wtab_r = np.full((ntl, uw_max), t.num_cells if gated else self._m2p_nw,
                                 np.int32)
                wcnt_row = wcnt_c[rcell]
                wmask = np.arange(uw_max)[None, :] < wcnt_row[:, None]
                wpos2 = woff_c[rcell][:, None] + np.arange(uw_max)[None, :]
                wcells = wcat[wkeep][wpos2[wmask]]
                wtab_r[wmask] = wcells if gated else self._cell_to_wtile[wcells]
                wtab = self._tensor(wtab_r.T)
                wcnt = self._tensor(wcnt_row.astype(np.int32))

        # un-bucketing is a gather through the inverse (row, slot) table
        rr, ss = np.nonzero(rmask)
        inv_flat = np.zeros(n, np.int64)
        inv_flat[tgt_idx[rr, ss]] = rr * tmax + ss

        binned = {
            "ntargets": n,
            "tcells": self._tensor(tcells, torch.int64),
            # live target slots per row (the leading ones)
            "tcnt": self._tensor(rlen.astype(np.int32)),
            "nbr": self._tensor(nbr_tab.T),
            "wtab": wtab,
            "wcnt": wcnt,
            "inv_flat": self._tensor(inv_flat),
            # (rows, T, d) target rows; pad slots repeat target 0
            torch.float64: {"tpts": self._tensor((targets - self._world_center)[tgt_idx])},
            # L2P weights kept only within the budget (else per row chunk)
            "l2p_resident": ntl * tmax * self.nnodes * 8 <= _WEIGHT_TABLE_BYTES,
        }
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

    def _l2p_weights(self, binned, with_grads, rows=slice(None)):
        """L2P anterpolation weights (rows, T, p^d) of a binned target set,
        and with ``with_grads`` their derivatives (rows, T, d, p^d), f64,
        for the row slice ``rows``."""
        f64 = self._floats64
        tc = binned["tcells"][rows]
        return cheb.anterpolation_weights_torch(
            binned[torch.float64]["tpts"][rows], f64["cell_centers"][tc],
            f64["cell_lengths"][tc], f64["nodes_t"], self.d, with_gradients=with_grads,
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

    def _upward(self, wt, fs):
        """P2M + M2M -> multipole expansions (ncells, p^d, nrhs)."""
        ncells = self.tree.num_cells
        nr = wt.shape[1]
        mult = wt.new_zeros((ncells + 1, self.nnodes, nr))  # row ncells = sink
        leaves = self._dev["leaf_cells"]
        if "p2m_w" in fs:
            mult[leaves] = torch.bmm(wt[: self.nsl], fs["p2m_w"]).transpose(1, 2)
        else:
            # weights made in f64 and rounded to the pass's dtype, as the
            # resident table's f32 copy is: both paths give the same sums
            f64 = self._floats64
            step = self._chunk(self.smax * self.nnodes)
            for l0 in range(0, self.nsl, step):
                sl = slice(l0, min(l0 + step, self.nsl))
                w = cheb.anterpolation_weights_torch(
                    f64["src_tiles"][sl].transpose(1, 2), f64["cell_centers"][leaves[sl]],
                    f64["cell_lengths"][leaves[sl]], f64["nodes_t"], self.d,
                ) * self._dev["src_mask"][sl, :, None]
                mult[leaves[sl]] = torch.bmm(wt[sl], w.to(wt.dtype)).transpose(1, 2)
        for ch, pa in self._dev["m2m_groups"]:
            contrib = torch.einsum("opq,ocqr->ocpr", fs["m2m_ops"], mult[ch])
            mult.index_add_(0, pa.reshape(-1), contrib.reshape(-1, self.nnodes, nr))
        return mult[:ncells]

    def _downward(self, mult, wt, fs):
        """M2L + P2L, then L2L -> local expansions (ncells, p^d, nrhs)."""
        ncells = self.tree.num_cells
        nn = self.nnodes
        nr = mult.shape[2]
        budget = (1 << 24) * max(int(self.params.eval_chunk_size), 1) // 1024
        local = mult.new_zeros((ncells + 1, nn, nr))  # row ncells = sink
        mult_pad = torch.cat([mult, mult.new_zeros((1, nn, nr))])
        for (u, vt), (src_tab, src_cells, level_cells) in zip(fs["m2l"], self._dev["m2l_levels"]):
            mult_src = mult_pad[src_cells]  # the level's sources once, + zero row
            g, c_all = src_tab.shape
            step = max(1, budget // (g * nn * nr))
            for c0 in range(0, c_all, step):
                x = mult_src[src_tab[:, c0 : c0 + step]]  # (g, c, p^d, r)
                z = x if vt is None else torch.einsum("gkq,gcqr->gckr", vt, x)
                local[level_cells[c0 : c0 + step]] += torch.einsum("gpk,gckr->cpr", u, z)

        if self._dev["p2l_cells"].numel():
            local[self._dev["p2l_cells"]] += near_field(
                fs["p2l_nodes"], fs["src_tiles"], wt, self._dev["p2l_nbr"],
                self._dev["p2l_cnt"], kparams=self.kernel_params, scnt=self._dev["src_scnt"])

        for ch, pa in self._dev["l2l_groups"]:
            contrib = torch.einsum("opq,ocpr->ocqr", fs["m2m_ops"], local[pa])
            local.index_add_(0, ch.reshape(-1), contrib.reshape(-1, nn, nr))
        return local[:ncells]

    def _l2p(self, binned, fs, local, with_grads=False):
        """L2P at a binned target set: values (rows, T, r) and, with
        ``with_grads``, gradients (rows, T, d, r), in the dtype of ``fs``."""
        bs = self._binned_floats(binned, fs["nodes_t"].dtype)
        loc = local[binned["tcells"]]  # (rows, p^d, r)
        rows, t, d = bs["tpts"].shape
        nr = loc.shape[2]
        if binned["l2p_resident"]:
            vals = torch.bmm(bs["l2p_w"], loc)
            if not with_grads:
                return vals
            # einsum("ltdp,lpr->ltdr") as one bmm over (T*d) weight rows
            return vals, torch.bmm(binned["l2p_dw"].flatten(1, 2), loc).view(rows, t, d, nr)
        # weights made in f64 per row chunk and rounded to the pass's dtype
        vals = loc.new_empty((rows, t, nr))
        grads = loc.new_empty((rows, t, d, nr)) if with_grads else None
        step = self._chunk(t * self.nnodes * (1 + (d if with_grads else 0)))
        for r0 in range(0, rows, step):
            sl = slice(r0, r0 + step)
            w = self._l2p_weights(binned, with_grads, sl)
            if with_grads:
                w, dw = w
                grads[sl] = torch.bmm(dw.flatten(1, 2), loc[sl]).view(-1, t, d, nr)
            vals[sl] = torch.bmm(w.to(loc.dtype), loc[sl])
        return (vals, grads) if with_grads else vals

    def _leaf(self, binned, dtype, fs, local, mult, wt):
        """L2P + near field (P2P, M2P) at a binned target set -> (n, nrhs)."""
        bs = self._binned_floats(binned, dtype)
        nr = local.shape[2]
        vals = self._l2p(binned, fs, local)  # (rows, T, r)
        vals += near_field(bs["tpts"], fs["src_tiles"], wt, binned["nbr"],
                           kparams=self.kernel_params, tcnt=binned["tcnt"],
                           scnt=self._dev["src_scnt"])
        if binned["wtab"] is not None and self._m2p_tiles_gated:
            vals += near_field_cells(bs["tpts"], binned["wtab"], binned["wcnt"],
                                     *self._cell_geometry(), mult, kparams=self.kernel_params,
                                     tcnt=binned["tcnt"])
        elif binned["wtab"] is not None:
            vals += near_field(bs["tpts"], fs["node_tiles"], self._m2p_tiles(mult),
                               binned["wtab"], binned["wcnt"], kparams=self.kernel_params,
                               tcnt=binned["tcnt"])
        return vals.reshape(-1, nr)[binned["inv_flat"]]

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
    def _as_weights(self, weights):
        w = torch.as_tensor(weights, dtype=torch.float64, device=self.device)
        return w.reshape(self._points.shape[0], -1)

    def set_weights(self, weights) -> None:
        """Upward pass (P2M + M2M) at f64."""
        fs = self._floats64
        self._weight_tiles = self._weight_tiles_of(self._as_weights(weights), torch.float64)
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
        nrhs) float64. ``precision`` "f32" runs every pass in float32.
        """
        dtype = _PRECISIONS[precision]
        binned = self._target_cache[reuse_key]
        fs = self._floats(dtype)
        wt = self._weight_tiles_of(weights_dev, dtype)
        mult = self._upward(wt, fs)
        local = self._downward(mult, wt, fs)
        return self._leaf(binned, dtype, fs, local, mult, wt).to(torch.float64)

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
