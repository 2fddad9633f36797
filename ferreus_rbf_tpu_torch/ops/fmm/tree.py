"""Host-side linear octree build + interaction lists as flat index arrays.

Copy of ``ferreus_rbf_tpu/ops/fmm/tree.py``, less its target binning
(``Octree.points_to_leaves``; the port bins on the tree's device in
``api.py``). The interaction lists come
from the port's native builder (``csrc/treebuild.cpp``, compiled with g++
at first use by ``ferreus_rbf_tpu_torch.native``; a failed build raises),
or from the numpy builder, ``_build_interaction_lists_numpy``, its plain
version, under ``FERREUS_RBF_TPU_NATIVE=0``. Both give the same FMM plan.

Replaces the HashMap/HashSet tree of the reference
(``ferreus_bbfmm/src/linear_tree.rs``, ``morton.rs``) with a dense cell
table built by vectorised numpy: cells are rows (anchor ints + level), with
parent/child index columns, and the u/v/w/x interaction lists are flat
(target_cell, source_cell[, meta]) pair arrays ready to be grouped into the
padded device plan. Semantics preserved:

* adaptive split rule: a cell splits iff it holds > max_points_per_cell
  points and level < MAXIMUM_LEVEL (``linear_tree.rs:88-99``),
* uniform rule: split all cells while any exceeds the threshold and level <
  optimal_depth = ceil(log2(N)/d) (``linear_tree.rs:100-130``),
* ``store_empty_leaves`` (non-sparse): every split materialises all 2^d
  children; empty children become leaves,
* u/v/w/x list definitions as documented at ``linear_tree.rs:189-267``,
* tree extents: floor/ceil of the AABB with +1e-3 radius epsilon
  (``morton.rs:349-373``); target binning (``api.FmmTree._target_leaves``)
  finds the deepest existing leaf over the per-level sorted keys kept here
  and reports out-of-tree points (``linear_tree.rs:487-520``).

Cell identity: key = pack(level, anchor) into int64 (16 bits/axis, 5 bits
level) — plain arithmetic, no interleaved Morton lookups needed because
cells are rows of arrays, not hash keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ... import native
from ...utils.timing import traced_stage

MAXIMUM_LEVEL = 15


class PointOutsideTreeError(ValueError):
    """A target point lies outside the tree extents (``FmmError``)."""

    def __init__(self, point_index: int):
        self.point_index = point_index
        super().__init__(
            f"FMM evaluation failed: target point at row {point_index} lies "
            f"outside the tree extents"
        )


def calculate_tree_center_and_radius(extents: np.ndarray):
    """Floor/ceil-snapped cube center + radius (+1e-3) from AABB extents."""
    extents = np.asarray(extents, np.float64)
    d = extents.size // 2
    lo = np.floor(extents[:d])
    hi = np.ceil(extents[d:])
    center = (lo + hi) / 2.0
    radius = float(np.max((hi - lo) / 2.0) + 1e-3)
    return center, radius


_AXIS_BITS = 16  # per anchor axis in a key; anchors stay below 2^MAXIMUM_LEVEL


def _anchor_key(anchors: np.ndarray) -> np.ndarray:
    """Level-free int64 key per anchor row: 16 bits per axis, axis 0 lowest."""
    key = np.zeros(anchors.shape[0], dtype=np.int64)
    for j in range(anchors.shape[1] - 1, -1, -1):
        key = (key << _AXIS_BITS) | anchors[:, j].astype(np.int64)
    return key


def _unpack_anchors(keys: np.ndarray, d: int) -> np.ndarray:
    """(n, d) int64 anchor rows of ``_anchor_key`` keys."""
    mask = (1 << _AXIS_BITS) - 1
    return np.stack([(keys >> (_AXIS_BITS * j)) & mask for j in range(d)], axis=1)


def _pack(level: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Unique int64 key per (level, anchor)."""
    return (_anchor_key(anchors) << 5) | np.asarray(level, np.int64)


def _unique_anchors(anchors: np.ndarray) -> np.ndarray:
    """The distinct rows of (n, d) int64 anchors, as one 1-D sort of their
    packed keys (``np.unique(axis=0)`` sorts rows as a void dtype, about
    ten times slower). Rows come out in key order, not row order."""
    if anchors.size and (anchors.min() < 0 or anchors.max() >> _AXIS_BITS):
        raise ValueError(
            f"an octree anchor does not fit the {_AXIS_BITS} bits of its key axis")
    return _unpack_anchors(np.unique(_anchor_key(anchors)), anchors.shape[1])


def _unique_pairs(pairs: np.ndarray) -> np.ndarray:
    """``np.unique(pairs, axis=0)`` of (n, 2) cell-index pairs, as one 1-D
    sort of ``(target << 32) | source``: cell indices are non-negative and
    below 2^31, so the keys sort as the rows do."""
    keys = np.unique((pairs[:, 0].astype(np.int64) << 32) | pairs[:, 1])
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1).astype(pairs.dtype, copy=False)


@dataclasses.dataclass
class Octree:
    """Dense cell table + flat interaction lists."""

    dimensions: int
    center: np.ndarray
    radius: float
    depth: int  # number of levels (root = level 0, deepest = depth)
    adaptive: bool
    sparse: bool

    # cell table, all shape (ncells,) / (ncells, ...)
    anchors: np.ndarray  # (ncells, d) int32
    levels: np.ndarray  # (ncells,) int32
    parent: np.ndarray  # (ncells,) int64, -1 for root
    children: np.ndarray  # (ncells, 2^d) int64, -1 where absent
    child_octant: np.ndarray  # (ncells,) int8: index within parent
    is_leaf: np.ndarray  # (ncells,) bool
    has_points: np.ndarray  # (ncells,) bool (cell subtree contains sources)

    # source points, Morton-sorted per leaf
    point_order: np.ndarray  # (npoints,) permutation: sorted -> original
    point_leaf: np.ndarray  # (npoints,) leaf cell index per ORIGINAL point
    leaf_cells: np.ndarray  # (nleaves,) cell indices of leaves with sources
    leaf_offsets: np.ndarray  # (nleaves+1,) CSR into point_order

    # interaction lists (flat pairs)
    v_pairs: np.ndarray  # (nv, 3): target cell, source cell, m2l vector id
    u_pairs: np.ndarray  # (nu, 2): target leaf cell, source leaf cell
    w_pairs: np.ndarray  # (nw, 2): target leaf cell, far source cell (M2P)
    x_pairs: np.ndarray  # (nx, 2): target cell (P2L), source leaf cell

    # lookup helpers
    _level_key_sorted: list  # per level: (sorted keys, cell indices)

    @property
    def num_cells(self) -> int:
        return self.anchors.shape[0]

    def cells_at_level(self, level: int) -> np.ndarray:
        return np.nonzero(self.levels == level)[0]

    def cell_centers(self, cell_idx) -> np.ndarray:
        lv = self.levels[cell_idx].astype(np.float64)
        side = 2.0 * self.radius / (2.0**lv)
        lo = self.center - self.radius
        return (self.anchors[cell_idx].astype(np.float64) + 0.5) * side[..., None] + lo

    def cell_lengths(self, cell_idx) -> np.ndarray:
        lv = self.levels[cell_idx].astype(np.float64)
        return 2.0 * self.radius / (2.0**lv)

    def lookup(self, level: int, anchors: np.ndarray) -> np.ndarray:
        """Cell indices for (level, anchor) queries; -1 where absent."""
        sorted_keys, sorted_idx = self._level_key_sorted[level]
        if sorted_keys.size == 0:
            return np.full(anchors.shape[0], -1, np.int64)
        keys = _pack(np.full(anchors.shape[0], level, np.int64), anchors)
        pos = np.searchsorted(sorted_keys, keys)
        pos = np.clip(pos, 0, sorted_keys.size - 1)
        hit = sorted_keys[pos] == keys
        return np.where(hit, sorted_idx[pos], -1)


def build_tree(
    points: np.ndarray,
    center: np.ndarray,
    radius: float,
    max_points_per_cell: int,
    store_empty_leaves: bool,
    dimensions: int,
    adaptive: bool,
) -> Octree:
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    d = dimensions
    lo = center - radius

    optimal_depth = int(np.ceil(np.log2(max(n, 2)) / d))

    # --- decide per-point leaf level -----------------------------------
    # anchors per level; level L anchor = floor((p - lo) / side_L)
    level_anchors = {}
    counts = {}

    def anchors_at(level: int) -> np.ndarray:
        if level not in level_anchors:
            side = 2.0 * radius / (1 << level)
            a = np.floor((pts - lo) / side).astype(np.int64)
            np.clip(a, 0, (1 << level) - 1, out=a)
            level_anchors[level] = a
        return level_anchors[level]

    def counts_at(level: int):
        if level not in counts:
            a = anchors_at(level)
            keys = _pack(np.full(n, level, np.int64), a)
            uniq, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
            counts[level] = (uniq, inv, cnt)
        return counts[level]

    if adaptive:
        # Leaf level per point: first level >= 1 where its cell count <=
        # threshold. (The reference always splits the root once, so leaves
        # live at level >= 1 even for tiny inputs — ``linear_tree.rs:46``.)
        point_leaf_level = np.zeros(n, dtype=np.int64)
        unresolved = np.ones(n, dtype=bool)
        level = 1
        while np.any(unresolved) and level <= MAXIMUM_LEVEL:
            _, inv, cnt = counts_at(level)
            ok = cnt[inv] <= max_points_per_cell
            settle = unresolved & (ok | (level == MAXIMUM_LEVEL))
            point_leaf_level[settle] = level
            unresolved &= ~settle
            level += 1
        depth = int(point_leaf_level.max()) if n else 1
        depth = max(depth, 1)
    else:
        # uniform: subdivide all until nothing exceeds threshold, capped at
        # optimal depth (and MAXIMUM_LEVEL)
        depth = 0
        while depth < min(optimal_depth, MAXIMUM_LEVEL):
            _, _, cnt = counts_at(depth)
            if np.all(cnt <= max_points_per_cell):
                break
            depth += 1
        depth = max(depth, 1)
        point_leaf_level = np.full(n, depth, dtype=np.int64)

    # --- build cell set --------------------------------------------------
    # Nonempty cells: all ancestors of point leaf cells. With
    # store_empty_leaves, add all siblings of every nonempty non-root cell.
    keys_list = []
    anchors_list = []
    levels_list = []

    point_keys = np.zeros(n, dtype=np.int64)
    for level in range(0, depth + 1):
        a = anchors_at(level)
        active = point_leaf_level >= level
        if level == 0:
            cell_anchors = np.zeros((1, d), dtype=np.int64)
        else:
            cell_anchors = _unique_anchors(a[active])
        if store_empty_leaves and level > 0:
            # add all siblings: parent anchors * 2 + all offsets (distinct
            # parents have distinct children, so no second unique)
            parents = _unique_anchors(cell_anchors >> 1)
            offs = np.array(
                [[(i >> j) & 1 for j in range(d)] for i in range(1 << d)], np.int64
            )
            cell_anchors = (parents[:, None, :] * 2 + offs[None, :, :]).reshape(-1, d)
        lv = np.full(cell_anchors.shape[0], level, np.int64)
        keys_list.append(_pack(lv, cell_anchors))
        anchors_list.append(cell_anchors)
        levels_list.append(lv)
        # record the leaf key of points whose leaf is this level
        mask = point_leaf_level == level
        if np.any(mask):
            point_keys[mask] = _pack(np.full(mask.sum(), level, np.int64), a[mask])

    all_keys = np.concatenate(keys_list)
    all_anchors = np.concatenate(anchors_list)
    all_levels = np.concatenate(levels_list)

    order = np.argsort(all_keys, kind="stable")
    all_keys = all_keys[order]
    all_anchors = all_anchors[order]
    all_levels = all_levels[order].astype(np.int32)
    ncells = all_keys.size

    # per-level sorted lookup
    level_key_sorted = []
    for level in range(depth + 1):
        m = all_levels == level
        idx = np.nonzero(m)[0]
        level_key_sorted.append((all_keys[m], idx))

    def lookup_keys(level, anchors):
        keys = _pack(np.full(anchors.shape[0], level, np.int64), anchors)
        skeys, sidx = level_key_sorted[level]
        pos = np.searchsorted(skeys, keys)
        pos = np.clip(pos, 0, max(skeys.size - 1, 0))
        if skeys.size == 0:
            return np.full(anchors.shape[0], -1, np.int64)
        hit = skeys[pos] == keys
        return np.where(hit, sidx[pos], -1)

    # parent / children / octant
    parent = np.full(ncells, -1, dtype=np.int64)
    children = np.full((ncells, 1 << d), -1, dtype=np.int64)
    child_octant = np.zeros(ncells, dtype=np.int8)
    for level in range(1, depth + 1):
        m = all_levels == level
        idx = np.nonzero(m)[0]
        if idx.size == 0:
            continue
        panc = all_anchors[idx] >> 1
        pidx = lookup_keys(level - 1, panc)
        parent[idx] = pidx
        oct_bits = (all_anchors[idx] & 1) @ (1 << np.arange(d, dtype=np.int64))
        child_octant[idx] = oct_bits.astype(np.int8)
        children[pidx, oct_bits] = idx

    # point -> leaf cell index (original order)
    skeys = all_keys
    pos = np.searchsorted(skeys, point_keys)
    point_cell = pos  # all point leaf keys exist by construction

    # leaf flags: a cell is a leaf iff it has no children in the tree
    is_leaf = np.all(children < 0, axis=1)

    # has_points: propagate up from point leaves
    has_points = np.zeros(ncells, dtype=bool)
    np.add.at(has_points, point_cell, True)
    for level in range(depth, 0, -1):
        m = (all_levels == level) & has_points
        pidx = parent[np.nonzero(m)[0]]
        has_points[pidx[pidx >= 0]] = True

    # CSR of source points per leaf (Morton-ish sort by cell index)
    point_order = np.argsort(point_cell, kind="stable")
    sorted_cells = point_cell[point_order]
    leaf_cells, starts = np.unique(sorted_cells, return_index=True)
    leaf_offsets = np.concatenate([starts, [n]])

    tree = Octree(
        dimensions=d,
        center=np.asarray(center, np.float64),
        radius=float(radius),
        depth=depth,
        adaptive=adaptive,
        sparse=not store_empty_leaves,
        anchors=all_anchors.astype(np.int32),
        levels=all_levels,
        parent=parent,
        children=children,
        child_octant=child_octant,
        is_leaf=is_leaf,
        has_points=has_points,
        point_order=point_order,
        point_leaf=point_cell,
        leaf_cells=leaf_cells,
        leaf_offsets=leaf_offsets,
        v_pairs=np.zeros((0, 3), np.int64),
        u_pairs=np.zeros((0, 2), np.int64),
        w_pairs=np.zeros((0, 2), np.int64),
        x_pairs=np.zeros((0, 2), np.int64),
        _level_key_sorted=level_key_sorted,
    )

    with traced_stage("fmm_interaction_lists"):
        _build_interaction_lists(tree)
    return tree


def _neighbor_offsets(d: int) -> np.ndarray:
    """All 3^d - 1 nonzero offsets in {-1,0,1}^d."""
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * d), indexing="ij")
    offs = np.stack([g.reshape(-1) for g in grids], axis=1)
    return offs[np.any(offs != 0, axis=1)]


def m2l_vector_id(delta: np.ndarray, d: int) -> np.ndarray:
    """Base-7 id of an M2L offset vector in [-3, 3]^d (``bbfmm.rs:989-998``).

    delta = (target_anchor - source_anchor) per dim; id treats dim 0 as the
    most significant digit, matching the reference's enumeration order.
    """
    out = np.zeros(delta.shape[0], dtype=np.int64)
    for j in range(d):
        out = out * 7 + (delta[:, j] + 3)
    return out


def _build_interaction_lists(tree: Octree) -> None:
    """Populate u/v/w/x flat pair lists with the native builder, or with
    the numpy one under ``FERREUS_RBF_TPU_NATIVE=0``.

    u and w come out as the numpy builder's: sorted unique rows. The native
    v list holds only sources with points and runs in cell order; the FMM
    plan drops the numpy list's other sources and does not depend on the
    order (each (vector id, target) slot has one source), so both builders
    give the same plan.
    """
    if not native.enabled():
        _build_interaction_lists_numpy(tree)
        return
    v, u, w = native.build_interaction_lists(
        tree.anchors, tree.levels, tree.parent, tree.children, tree.is_leaf,
        tree.has_points)
    tree.v_pairs = v
    tree.u_pairs = _unique_pairs(u)
    tree.w_pairs = _unique_pairs(w)
    tree.x_pairs = tree.w_pairs[:, ::-1].copy()


def _build_interaction_lists_numpy(tree: Octree) -> None:
    """Populate u/v/w/x flat pair lists (the plain version).

    v: children of parent's colleagues, existing, non-adjacent (same level).
    u (leaves): adjacent leaves of any level, incl. self.
    w (leaves): descendants of colleagues whose parent is adjacent but which
       are not adjacent themselves.
    x: inverse of w.

    For the sparse (adaptive fit) tree the reference only materialises cells
    with points, and u/w sources must hold source points; pairs towards
    empty cells are dropped at plan build, not here.
    """
    d = tree.dimensions
    offs = _neighbor_offsets(d)

    v_list = []
    # --- v list: vectorised over each level -----------------------------
    for level in range(2, tree.depth + 1):
        cells = tree.cells_at_level(level)
        if cells.size == 0:
            continue
        anchors = tree.anchors[cells].astype(np.int64)
        parents = tree.parent[cells]
        panchors = tree.anchors[parents].astype(np.int64)
        # parent colleagues: panchor + off (26 in 3D)
        max_box_parent = 1 << (level - 1)
        for off in offs:
            cand = panchors + off
            valid = np.all((cand >= 0) & (cand < max_box_parent), axis=1)
            pc = np.full(cells.size, -1, np.int64)
            pc[valid] = tree.lookup(level - 1, cand[valid])
            has = pc >= 0
            if not np.any(has):
                continue
            # children of that colleague
            ch = tree.children[pc[has]]  # (m, 2^d)
            tgt = cells[has]
            tanch = anchors[has]
            for c in range(1 << d):
                src = ch[:, c]
                ok = src >= 0
                if not np.any(ok):
                    continue
                sanch = tree.anchors[src[ok]].astype(np.int64)
                delta = tanch[ok] - sanch
                nonadj = np.max(np.abs(delta), axis=1) >= 2
                if not np.any(nonadj):
                    continue
                t_sel = tgt[ok][nonadj]
                s_sel = src[ok][nonadj]
                vid = m2l_vector_id(delta[nonadj], d)
                v_list.append(np.stack([t_sel, s_sel, vid], axis=1))

    tree.v_pairs = (
        np.concatenate(v_list, axis=0) if v_list else np.zeros((0, 3), np.int64)
    )

    # --- u/w lists: frontier sweep over all leaves ----------------------
    leaves = np.nonzero(tree.is_leaf)[0]
    u_list = [np.stack([leaves, leaves], axis=1)]  # self-interaction
    w_list = []

    # Phase 1: same-level colleagues; walk UP when absent (coarser adjacent
    # cells). A coarser cell found this way is adjacent by construction
    # (it contains the would-be colleague). Collect it if it is a leaf.
    lanch = tree.anchors[leaves].astype(np.int64)
    llev = tree.levels[leaves].astype(np.int64)
    for off in offs:
        cand = lanch + off
        max_box = (1 << llev[:, None]).astype(np.int64)
        valid = np.all((cand >= 0) & (cand < max_box), axis=1)
        # resolve at each level walking up
        resolved = np.full(leaves.size, -1, np.int64)
        for level in range(tree.depth, -1, -1):
            m = valid & (resolved < 0) & (llev >= level)
            if not np.any(m):
                continue
            shifted = cand[m] >> (llev[m, None] - level)
            idx = tree.lookup(level, shifted)
            hit = idx >= 0
            sub = np.nonzero(m)[0]
            resolved[sub[hit]] = idx[hit]
        ok = resolved >= 0
        if not np.any(ok):
            continue
        tgt = leaves[ok]
        src = resolved[ok]
        src_is_leaf = tree.is_leaf[src]
        # coarser-or-equal adjacent leaf -> u
        if np.any(src_is_leaf):
            u_list.append(np.stack([tgt[src_is_leaf], src[src_is_leaf]], axis=1))
        # non-leaf colleague at same level -> descend (phase 2 frontier)
        same_level = tree.levels[src] == tree.levels[tgt]
        frontier_mask = (~src_is_leaf) & same_level
        if np.any(frontier_mask):
            w_list.append(("frontier", tgt[frontier_mask], src[frontier_mask]))

    # Phase 2: BFS down the non-leaf adjacent colleagues. Children adjacent
    # to the leaf recurse (leaves -> u); non-adjacent children -> w.
    frontier_t = []
    frontier_s = []
    for tag, t, s in w_list:
        frontier_t.append(t)
        frontier_s.append(s)
    w_list = []
    if frontier_t:
        ft = np.concatenate(frontier_t)
        fs = np.concatenate(frontier_s)
    else:
        ft = np.zeros(0, np.int64)
        fs = np.zeros(0, np.int64)

    while ft.size:
        # expand children of fs
        ch = tree.children[fs]  # (m, 2^d)
        ft2 = np.repeat(ft, 1 << d)
        fs2 = ch.reshape(-1)
        keep = fs2 >= 0
        ft2, fs2 = ft2[keep], fs2[keep]
        if ft2.size == 0:
            break
        # adjacency test between target leaf (coarser/equal) and child cell
        t_lev = tree.levels[ft2].astype(np.int64)
        s_lev = tree.levels[fs2].astype(np.int64)
        # compare at the finer level: t box spans [ta<<dl, (ta+1)<<dl)
        dl = s_lev - t_lev  # >= 1
        ta = tree.anchors[ft2].astype(np.int64)
        sa = tree.anchors[fs2].astype(np.int64)
        t_lo = ta << dl[:, None]
        t_hi = ((ta + 1) << dl[:, None]) - 1
        adjacent = np.all((sa >= t_lo - 1) & (sa <= t_hi + 1), axis=1)

        # non-adjacent -> w list (stop descending)
        w_sel = ~adjacent
        if np.any(w_sel):
            w_list.append(np.stack([ft2[w_sel], fs2[w_sel]], axis=1))

        # adjacent leaves -> u; adjacent internals -> next frontier
        adj_t = ft2[adjacent]
        adj_s = fs2[adjacent]
        s_leaf = tree.is_leaf[adj_s]
        if np.any(s_leaf):
            u_list.append(np.stack([adj_t[s_leaf], adj_s[s_leaf]], axis=1))
        ft = adj_t[~s_leaf]
        fs = adj_s[~s_leaf]

    u_pairs = np.concatenate(u_list, axis=0)
    # deduplicate (self pair could reappear via sibling sweep)
    u_pairs = np.unique(u_pairs, axis=0)
    tree.u_pairs = u_pairs
    tree.w_pairs = (
        np.unique(np.concatenate(w_list, axis=0), axis=0)
        if w_list
        else np.zeros((0, 2), np.int64)
    )
    # x = inverse of w: (target cell receiving P2L, source leaf)
    tree.x_pairs = tree.w_pairs[:, ::-1].copy()
