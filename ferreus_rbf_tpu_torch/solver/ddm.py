"""Multilevel overlapping domain decomposition for Schwarz preconditioning.

Port of ``ferreus_rbf_tpu/solver/ddm.py`` (Beatson/Light/Billings 2000;
Haase et al. 2018): per level, recursive median split along the longest
axis into leaf domains of ~``leaf_threshold`` points; per leaf, the coarse
set is a centroid-closest seed plus farthest-point sampling of
``coarse_ratio`` of the internal points, and the overlap is the nearest
neighbouring-internal points ranked by point-to-AABB distance; levels
recurse on the coarse sets until ``coarse_threshold``, which gets a single
directly-factored coarse domain (with the polynomial tail when a drift is
present).

The decomposition combinatorics run on the host in numpy/scipy. Each
level's leaf systems are grouped into (padded size, rank) buckets, and each
bucket is assembled and factored by one batched ``torch.linalg.cholesky_ex``
on the device; the per-iteration solves are batched triangular solves.
Factors may be held in f32: right-preconditioned *flexible* GMRES tolerates
an inexact preconditioner.

Each level sizes its leaves by a memory budget for its stored factors
(``FERREUS_RBF_TPU_DDM_MEM_GB``, default 5.0, the JAX package's variable):
leaves halve from ``leaf_threshold`` down to a 128-point floor until the
level's factors fit its share. When even the floor does not fit, or when
``FERREUS_RBF_TPU_DDM_RECOMPUTE=1`` and the cap is below the user's leaf,
the level keeps full-size leaves and stores no factors: every application
assembles, factors and solves them (recompute-from-points), dropping for
that application any domain whose block is not SPD.
``FERREUS_RBF_TPU_DDM_RECOMPUTE=0`` keeps shrink-to-fit.

Each level's domains, its buckets end to end, are solved in pieces that
do not depend on the world size (``parallel.pieces``: blocks of at least
``_MIN_BLOCK_DOMAINS`` domains, cut again at the bucket boundaries) and
factored in chunks of a piece. A
tree built under ``parallel.use_mesh`` factors and solves only this rank's
pieces, so factor memory and time split across the ranks, and one
all-reduce per level application joins the solves: each internal point
belongs to one domain of a level, so the sum is exact and every rank holds
one rank's bits. The coarse level stays replicated.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.linalg
import torch

from ..config import DDMParams
from ..interpolant_config import InterpolantSettings
from ..ops.dense import get_a_matrix_symmetric_solver
from ..ops.kernels import make_kernel
from ..ops.polynomials import (
    evaluate_lagrange_polynomials,
    evaluate_monomials,
    get_lagrange_coefficients,
)
from ..parallel import sharding
from ..utils.common import farthest_point_sampling, get_cheb_cube_scaling_factors
from ..utils.timing import record_event, to_device, traced_stage
from .domain import Domain, _rank_from_pivoted_qr


@dataclasses.dataclass
class LeafPlan:
    """Host-side description of one overlapping leaf domain."""

    point_indices: np.ndarray  # QTAQ order: special points first
    internal_mask: np.ndarray
    extents: np.ndarray
    q_top: np.ndarray | None  # (k, n-k) or None when no drift
    rank: int


class Level:
    def __init__(self, point_indices: np.ndarray):
        self.point_indices = np.asarray(point_indices, np.int64)
        self.leaf_plans: list[LeafPlan] = []
        self.buckets: list[dict] = []  # device solve plan, one per (S, k)
        self.coarse_domain: Domain | None = None
        self.leaf_threshold = 0  # this level's leaf size (memory-budget sizing)
        self.recompute = False  # factors rebuilt per application, none stored


def _next_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _factor_chunk(s_pad: int) -> int:
    """Domains per factor call: the assembly temporaries scale as nb * S^2
    (A, the QTAQ products and the Cholesky workspace, ~2 GB per chunk)."""
    return max(1, int(2e9 // (s_pad * s_pad * 8 * 6)))


# Fewest domains in a block of a level's solves. A batched triangular solve
# of a few hundred domains takes about as long as one of a few dozen (the
# card is not full), so cutting such a level into blocks multiplies its
# time on one card and saves nothing on several: a level of fewer domains
# than twice this is one block, solved by one rank. Each block is a solve
# of its own on one card: the 1M fit's level 0 (16,384 domains) in 8
# blocks of 2,048 took +8% over 4 of 4,096 (PERF.md).
_MIN_BLOCK_DOMAINS = 4096


def _factor_chunks(lo: int, hi: int, s_pad: int):
    """The domains ``lo:hi`` of a bucket as slices of at most one factor
    chunk each, cut from ``lo`` (a piece's start: the same on any number of
    ranks)."""
    step = _factor_chunk(s_pad)
    return [slice(c, min(c + step, hi)) for c in range(lo, hi, step)]


def _leaf_qtaq_structure(points, indices, internal_mask, settings, global_trend=None):
    """Special-point selection + Q_top for one leaf (host; the same
    procedure as ``Domain.factorise`` without assembling A, monomials on
    the inverse-transformed points under a trend)."""
    dpts = points[indices]
    translation, scale = get_cheb_cube_scaling_factors(dpts)
    mpts = global_trend.inverse_transform_points(dpts) if global_trend is not None else dpts
    monomials = evaluate_monomials(
        mpts, settings.polynomial_degree, settings.basis_size, translation, scale
    )
    _, rc, piv = scipy.linalg.qr(monomials, mode="economic", pivoting=True)
    rank = _rank_from_pivoted_qr(rc)
    cols = np.sort(piv[:rank])
    frm = monomials[:, cols]
    _, _, piv2 = scipy.linalg.qr(frm.T, mode="economic", pivoting=True)
    special = np.sort(piv2[:rank])
    is_special = np.zeros(indices.size, bool)
    is_special[special] = True
    non_special = np.nonzero(~is_special)[0]
    order = np.concatenate([special, non_special])
    lagrange = get_lagrange_coefficients(frm[special])
    q_top = -evaluate_lagrange_polynomials(frm[non_special], lagrange).T
    return indices[order], internal_mask[order], q_top, rank


def factor_bucket(pts, mask, q_top, *, kparams, nugget, k, dtype):
    """Batched QTAQ assembly + Cholesky for one (S, k) bucket.

    pts (nb, S, d); mask (nb, S) bool; q_top (nb, k, S-k). Padded rows and
    columns are replaced by identity so the padded system stays SPD.
    Returns (factors (nb, S-k, S-k) in ``dtype``, failed (nb,) bool).

    The system is assembled in the factors' precision. In f32 a tiny
    scale-relative jitter keeps borderline blocks SPD, and blocks whose
    Cholesky still fails are refactored with a 1e-4 relative diagonal shift
    (this perturbs only the preconditioner, and FGMRES is flexible). Blocks
    that fail even shifted are reported in ``failed``.

    Each domain's points are moved to its first point in f64 before the
    cast: the kernels depend only on distances, and real-world coordinates
    (northings ~7.7e6, where f32 resolves 0.5) would otherwise lose the
    spacing of close points in f32.
    """
    kernel = make_kernel(kparams, dtype=dtype)
    pts = (pts - pts[:, :1]).to(dtype)
    a = kernel.pair(pts, pts)
    s = pts.shape[1]
    eye = torch.eye(s, dtype=dtype, device=pts.device)
    if dtype == torch.float32:
        a = a + (3e-7 * a.abs().amax(dim=(1, 2), keepdim=True)) * eye
    a = a + nugget * eye
    a = torch.where(mask[:, :, None] & mask[:, None, :], a, eye)
    if k:
        q = q_top.to(dtype)
        a11, a12 = a[:, :k, :k], a[:, :k, k:]
        a21, a22 = a[:, k:, :k], a[:, k:, k:]
        lhs = q.transpose(1, 2) @ (a11 @ q) + q.transpose(1, 2) @ a12 + a21 @ q + a22
    else:
        lhs = a
    chol, info = torch.linalg.cholesky_ex(lhs)
    failed = info != 0
    if dtype == torch.float32 and bool(failed.any()):
        dmag = lhs.abs().amax(dim=(1, 2), keepdim=True)
        chol2, info2 = torch.linalg.cholesky_ex(
            lhs + (1e-4 * dmag) * torch.eye(lhs.shape[1], dtype=dtype, device=lhs.device))
        chol = torch.where(failed[:, None, None], chol2, chol)
        failed = failed & (info2 != 0)
    return chol, failed


def _factor_drop_failed(pts, mask, q_top, scatter_idx, n_out, **kw):
    """Factor one chunk of a recompute bucket; a domain whose block is not
    SPD even shifted gets an identity factor and scatters into the sink row
    ``n_out``, so it adds nothing to this application."""
    chol, failed = factor_bucket(pts, mask, q_top, **kw)
    eye = torch.eye(chol.shape[1], dtype=chol.dtype, device=chol.device)
    chol = torch.where(failed[:, None, None], eye, chol)
    return chol, torch.where(failed[:, None], n_out, scatter_idx)


def solve_piece(residual, bucket, sl, chol, scatter_idx, out):
    """Batched local solves of the domains ``sl`` of one bucket with their
    factors ``chol``; adds their internal-point coefficients into ``out``
    (n_out + 1, nrhs), whose last row is the sink of the other rows
    (internal points are disjoint across domains, so each row takes one
    add)."""
    k = bucket["k"]
    d = residual[bucket["pts_idx"][sl]] * bucket["mask"][sl, :, None]  # (nb, S, nrhs)
    q_top = bucket["q_top"][sl]
    rhs = q_top.transpose(1, 2) @ d[:, :k] + d[:, k:] if k else d
    y = torch.linalg.solve_triangular(chol, rhs.to(chol.dtype), upper=False)
    gamma = torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True).to(torch.float64)
    lam = torch.cat([q_top @ gamma, gamma], dim=1) if k else gamma
    out.index_add_(0, scatter_idx.reshape(-1), lam.reshape(-1, lam.shape[2]))


class DDMTree:
    """The multilevel overlapping decomposition, finest level first.

    ``points`` are the fit's points (transformed under a ``global_trend``);
    with a trend every leaf's QTAQ structure and the coarse domain take
    their monomials on the inverse-transformed points. A recompute level
    assembles from the same stored structure (``q_top``, the special-point
    order), so it applies the trended blocks too."""

    def __init__(
        self,
        points: np.ndarray,
        interpolant_settings: InterpolantSettings,
        ddm_params: DDMParams,
        factor_dtype=torch.float64,
        *,
        device,
        global_trend=None,
    ):
        self.points = np.asarray(points, np.float64)
        self.settings = interpolant_settings
        self.params = ddm_params
        self.global_trend = global_trend
        self.factor_dtype = factor_dtype
        self.device = torch.device(device)
        self.mesh = sharding.active_mesh()
        # stored factor bytes of all ranks and of this one; Schwarz domains
        # of all fine levels and this rank's
        self.factor_bytes = self.factor_bytes_rank = 0
        self.domains = self.domains_rank = 0
        self.levels: list[Level] = []
        self._pts_dev = to_device(self.points, self.device)
        self._build()

    def _leaf_threshold_for(self, m: int) -> tuple[int, bool]:
        """(leaf threshold, recompute) of a level of ``m`` points: the
        largest power-of-two halving of ``leaf_threshold`` (down to 128)
        whose stored factors, ~ m * S * (1 + overlap)^2 * itemsize bytes,
        fit 40% of ``FERREUS_RBF_TPU_DDM_MEM_GB``; the user's leaf with
        recompute when even 128 does not fit (or, with
        ``FERREUS_RBF_TPU_DDM_RECOMPUTE=1``, whenever the cap is below the
        user's leaf). The JAX package's rule (``ddm.py:260-301``)."""
        budget = float(os.environ.get("FERREUS_RBF_TPU_DDM_MEM_GB", "5.0")) * 1e9
        bytes_per = 4 if self.factor_dtype == torch.float32 else 8
        q2 = (1.0 + self.params.overlap_quota) ** 2
        cap = int(0.4 * budget / max(m * q2 * bytes_per, 1.0))
        leaf = self.params.leaf_threshold
        rc_env = os.environ.get("FERREUS_RBF_TPU_DDM_RECOMPUTE", "auto")
        if rc_env not in ("0", "false", "False") and (
            cap < min(128, leaf) or (rc_env in ("1", "true", "True") and cap < leaf)
        ):
            return leaf, True
        while leaf > 128 and leaf > cap:
            leaf //= 2
        return leaf, False

    # -------------------------------------------------------------- build
    def _build(self):
        pts = self.points
        n, d = pts.shape
        p = self.params
        active = np.arange(n)

        while active.size > p.coarse_threshold:
            level = Level(active)
            leaf_t, level.recompute = self._leaf_threshold_for(active.size)
            level.leaf_threshold = leaf_t
            # --- recursive median split (FIFO, like the reference) -------
            with traced_stage("ddm_split"):
                queue = [(active, self._extents_of(active))]
                leaves_raw = []
                while queue:
                    idx, ext = queue.pop(0)
                    cur = pts[idx]
                    axis = int(np.argmax(cur.max(axis=0) - cur.min(axis=0)))
                    order = np.argsort(cur[:, axis], kind="stable")
                    mid = idx.size // 2
                    left = np.sort(idx[order[:mid]])
                    right = np.sort(idx[order[mid:]])
                    mid_coord = pts[idx[order[mid]], axis]
                    lext = ext.copy()
                    lext[axis + d] = mid_coord
                    rext = ext.copy()
                    rext[axis] = mid_coord
                    if idx.size * (1.0 + p.overlap_quota) >= 2.0 * leaf_t:
                        queue.append((left, lext))
                        queue.append((right, rext))
                    else:
                        leaves_raw.append((left, lext))
                        leaves_raw.append((right, rext))

            nleaves = len(leaves_raw)
            num_coarse = int(np.ceil(np.ceil(active.size * p.coarse_ratio) / nleaves))

            # --- coarse point selection per leaf --------------------------
            with traced_stage("ddm_coarse_sel"):
                coarse_all = []
                for idx, _ext in leaves_raw:
                    internal_points = pts[idx]
                    sample = min(idx.size, num_coarse)
                    center = internal_points.mean(axis=0)
                    seed = int(np.argmin(np.linalg.norm(internal_points - center, axis=1)))
                    sel = farthest_point_sampling(internal_points, sample, seed)
                    coarse_all.append(np.sort(idx[sel]))

            # --- overlap from neighbouring leaves' internal points --------
            with traced_stage("ddm_overlap_qtaq"):
                exts = np.stack([ext for _idx, ext in leaves_raw])
                lo, hi = exts[:, :d], exts[:, d:]
                # AABB intersection (touching counts), excluding self
                inter = np.all(
                    (lo[:, None, :] <= hi[None, :, :]) & (hi[:, None, :] >= lo[None, :, :]),
                    axis=2,
                )
                np.fill_diagonal(inter, False)
                plans = []
                for i, (idx, ext) in enumerate(leaves_raw):
                    nbr = np.nonzero(inter[i])[0]
                    nbr_idx = (
                        np.concatenate([leaves_raw[j][0] for j in nbr])
                        if nbr.size
                        else np.zeros(0, np.int64)
                    )
                    num_overlap = int(np.ceil(idx.size * 2 * p.overlap_quota))
                    if nbr_idx.size:
                        clipped = np.clip(pts[nbr_idx], ext[:d], ext[d:])
                        dist = np.linalg.norm(pts[nbr_idx] - clipped, axis=1)
                        overlap_idx = nbr_idx[np.argsort(dist, kind="stable")[:num_overlap]]
                    else:
                        overlap_idx = np.zeros(0, np.int64)
                    all_idx = np.concatenate([idx, overlap_idx])
                    internal = np.concatenate(
                        [np.ones(idx.size, bool), np.zeros(overlap_idx.size, bool)]
                    )
                    if self.settings.basis_size != 0:
                        all_idx, internal, q_top, rank = _leaf_qtaq_structure(
                            pts, all_idx, internal, self.settings, self.global_trend
                        )
                    else:
                        q_top, rank = None, 0
                    plans.append(LeafPlan(all_idx, internal, ext, q_top, rank))

            level.leaf_plans = plans
            with traced_stage("ddm_factorise"):
                self._factorise_level(level)
            record_event("ddm_level", {
                "level": len(self.levels), "points": int(active.size), "leaves": nleaves,
                "leaf_threshold": leaf_t, "recompute": level.recompute})
            self.levels.append(level)
            active = np.sort(np.concatenate(coarse_all))

        # --- coarse level: one direct domain (host) -----------------------
        coarse_level = Level(active)
        dom = Domain(active.copy())
        dom.internal_points_mask = np.ones(active.size, bool)
        dom.factorise(pts, self.settings, self.settings.basis_size != 0, self.global_trend)
        coarse_level.coarse_domain = dom
        coarse_level.coarse_idx = to_device(dom.overlapping_point_indices, self.device)
        self.levels.append(coarse_level)

    def _extents_of(self, idx):
        sel = self.points[idx]
        return np.concatenate([sel.min(axis=0), sel.max(axis=0)])

    # ---------------------------------------------------------- device plan
    def _factorise_level(self, level: Level):
        """Group leaves into (S, k) buckets and factor this rank's pieces of
        them on the device, batched (a recompute level stores its buckets
        without factors). ``bucket["pieces"]`` lists this rank's (lo, hi)
        domain ranges, ``bucket["chol"]`` their factors."""
        kparams = self.settings.kernel_params()
        groups = {}
        for plan in level.leaf_plans:
            s_pad = _next_multiple(max(plan.point_indices.size, 8), 64)
            groups.setdefault((s_pad, plan.rank), []).append(plan)
        groups = list(groups.items())

        n_out = self.points.shape[0] + self.settings.basis_size
        dev = self.device
        pts_d = self._pts_dev
        itemsize = 4 if self.factor_dtype == torch.float32 else 8
        for (s_pad, k), plans in groups:
            nb = len(plans)
            pts_idx = np.zeros((nb, s_pad), np.int64)
            mask = np.zeros((nb, s_pad), bool)
            internal = np.zeros((nb, s_pad), bool)
            q_top = np.zeros((nb, k, s_pad - k))
            for b, plan in enumerate(plans):
                npts = plan.point_indices.size
                pts_idx[b, :npts] = plan.point_indices
                mask[b, :npts] = True
                internal[b, :npts] = plan.internal_mask
                if k:
                    q_top[b, :, : npts - k] = plan.q_top
            # internal rows scatter to their point; the rest to the sink n_out
            bucket = {"pts_idx": to_device(pts_idx, dev),
                      "mask": to_device(mask, dev),
                      "q_top": to_device(q_top, dev), "k": k,
                      "scatter_idx": to_device(np.where(internal & mask, pts_idx, n_out), dev),
                      "pieces": []}
            if not level.recompute:
                bucket["chol"] = []
                self.factor_bytes += nb * (s_pad - k) ** 2 * itemsize
            level.buckets.append(bucket)
            self.domains += nb
        sizes = [len(plans) for _, plans in groups]
        blocks = sharding.pass_blocks(sum(sizes), _MIN_BLOCK_DOMAINS)
        for g, lo, hi in sharding.pieces(sizes, self.mesh, blocks=blocks):
            (s_pad, k), plans = groups[g]
            bucket = level.buckets[g]
            bucket["pieces"].append((lo, hi))
            self.domains_rank += hi - lo
            if level.recompute:
                continue
            chol = torch.empty((hi - lo, s_pad - k, s_pad - k), dtype=self.factor_dtype, device=dev)
            failed = torch.empty(hi - lo, dtype=torch.bool, device=dev)
            for sl in _factor_chunks(lo, hi, s_pad):
                at = slice(sl.start - lo, sl.stop - lo)
                chol[at], failed[at] = factor_bucket(
                    pts_d[bucket["pts_idx"][sl]], bucket["mask"][sl], bucket["q_top"][sl],
                    kparams=kparams, nugget=self.settings.nugget, k=k, dtype=self.factor_dtype,
                )
            bad = np.nonzero(failed.cpu().numpy())[0]
            if bad.size:
                self._host_refactor(plans[lo:hi], chol, bad, k)
            bucket["chol"].append(chol)
            self.factor_bytes_rank += chol.numel() * chol.element_size()

    def _host_refactor(self, plans, chol, bad, k):
        """Host rescue for non-SPD leaves: dense Cholesky with a growing
        diagonal shift, else the nearest-SPD factor of the clipped
        spectrum (the block is only a preconditioner)."""
        kparams = self.settings.kernel_params()
        for b in bad:
            plan = plans[b]
            a = get_a_matrix_symmetric_solver(
                self.points[plan.point_indices], kparams, self.settings.nugget, xp=np
            )
            if k:
                q = plan.q_top
                lhs = q.T @ (a[:k, :k] @ q) + q.T @ a[:k, k:] + a[k:, :k] @ q + a[k:, k:]
            else:
                lhs = a
            shift = 1e-12 * max(np.abs(np.diag(lhs)).max(), 1.0)
            for _ in range(8):
                try:
                    low = np.linalg.cholesky(lhs + shift * np.eye(lhs.shape[0]))
                    break
                except np.linalg.LinAlgError:
                    shift *= 10.0
            else:
                ew, ev = np.linalg.eigh((lhs + lhs.T) / 2.0)
                floor = 1e-12 * max(float(ew.max()), 1.0)
                low = np.linalg.cholesky(
                    (ev * np.maximum(ew, floor)) @ ev.T + floor * np.eye(lhs.shape[0])
                )
            l_pad = np.eye(chol.shape[1])
            l_pad[: low.shape[0], : low.shape[1]] = low
            chol[b] = to_device(l_pad, chol.device, chol.dtype)

    # ------------------------------------------------------------- solves
    def solve_fine_level(self, level_idx: int, residual):
        """All leaf solves of one level; returns internal-row coefficients.
        Under a sharded mesh each rank solves its pieces and one all-reduce
        joins them."""
        n_out = residual.shape[0]
        out = residual.new_zeros((n_out + 1, residual.shape[1]))  # row n_out = sink
        level = self.levels[level_idx]
        for bucket in level.buckets:
            for i, (lo, hi) in enumerate(bucket["pieces"]):
                if not level.recompute:
                    solve_piece(residual, bucket, slice(lo, hi), bucket["chol"][i],
                                bucket["scatter_idx"][lo:hi], out)
                    continue
                for sl in _factor_chunks(lo, hi, bucket["pts_idx"].shape[1]):
                    chol, scatter = self._recompute_factors(bucket, sl, n_out)
                    solve_piece(residual, bucket, sl, chol, scatter, out)
        sharding.all_reduce_sum(out, self.mesh)
        return out[:n_out]

    def _recompute_factors(self, bucket, sl, n_out):
        """Assemble and factor the domains ``sl`` (at most one factor chunk)
        of a bucket that stores no factors: (factors, scatter rows), a
        domain that is not SPD scattering into the sink."""
        return _factor_drop_failed(
            self._pts_dev[bucket["pts_idx"][sl]], bucket["mask"][sl], bucket["q_top"][sl],
            bucket["scatter_idx"][sl], n_out, kparams=self.settings.kernel_params(),
            nugget=self.settings.nugget, k=bucket["k"], dtype=self.factor_dtype)

    def coarse_device_arrays(self):
        """The coarse solve's data on the tree's device, for the fused FGMRES
        cycle (``solver/fused.py``): ``(arrays, k, solve_for_poly)`` with
        ``arrays`` = {idx, chol (lower, f64), q_top, a_special, inv_special},
        or None when the coarse system is not SPD (its factorisation fell
        back to LDL), which keeps the host loop."""
        dom = self.levels[-1].coarse_domain
        if not dom.is_spd:
            return None
        k, nc = dom.num_special, dom.num_points
        arrays = {
            "idx": self.levels[-1].coarse_idx,
            "chol": dom.cholesky_lower(),
            "q_top": dom.q_matrix_top if dom.q_matrix_top is not None else np.zeros((0, nc)),
            "a_special": (dom.a_special_points_rows if dom.a_special_points_rows is not None
                          else np.zeros((k, nc))),
            "inv_special": (scipy.linalg.lu_solve(dom._special_point_lu, np.eye(k))
                            if dom._special_point_lu is not None else np.zeros((k, k))),
        }
        arrays = {key: to_device(v, self.device) for key, v in arrays.items()}
        return arrays, k, dom.solve_for_poly

    def solve_coarse(self, residual, add_poly: bool):
        """Direct coarse solve on the host; only the coarse rows move."""
        coarse = self.levels[-1]
        dom = coarse.coarse_domain
        gathered = residual[coarse.coarse_idx].cpu().numpy()
        sol = dom.solve_gathered(gathered)
        out = residual.new_zeros(residual.shape)
        out[coarse.coarse_idx] = to_device(sol.point_coefficients, residual.device)
        if dom.solve_for_poly and add_poly and sol.poly_coefficients is not None:
            m = sol.poly_coefficients.shape[0]
            out[-m:] = to_device(sol.poly_coefficients, residual.device)
        return out
