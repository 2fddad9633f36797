"""Restarted FGMRES with each restart cycle on the device.

Port of ``ferreus_rbf_tpu/solver/fused.py``. The inner Krylov loop runs on
the device: CGS2 over the basis, the Givens rotations (dlartg semantics,
without branches) and the stopping test, so that the host sees one small
transfer per restart cycle, the stats vector [res_g, res_r, jf, hist...].
The semantics are those of :func:`.fgmres.fgmres_device` and
``ferreus_rbf/src/iterative_solvers.rs:38-173``: restarted right-
preconditioned flexible GMRES; an Absolute tolerance takes the max-norm
for beta and |g| as it is, a Relative one the l2 norm and |g| / beta;
:func:`refined_fgmres_fused` has the refinement, escalation and
best-iterate logic of :func:`.fgmres.refined_fgmres_device`.

The preconditioner runs whole on the device: the fine Schwarz levels are
batched bucket solves already, and the coarse domain's Cholesky factor is
moved to the device once (``DDMTree.coarse_device_arrays``), so the coarse
solve is two triangular solves there instead of a host round trip.

On a CUDA device each restart cycle is captured once as a CUDA graph per
(inner precision, tolerance type, mi), so at most two graphs per fit (f32
inner solves, f64 after escalation), and replayed for every later cycle
of that key. The first cycle of a key runs eagerly on the capture stream
(one per device, shared by every fused system):
it is the warm-up that builds what the passes create on first use (the
near-field work lists, the f32 tables, cuBLAS' workspace on that stream),
since nothing made during a capture holds data before a replay. The graph
is the masked, unrolled cycle: all mi inner steps run on every replay,
and each step's updates are gated on the device by its flag, (j < mi) &
(res >= tol), so the result is that of the JAX package's early-exiting
``lax.while_loop``; steps past convergence cost a preconditioner
application and a matvec each (``stats["masked_steps"]``). The region
makes no host sync and is captured in the "global" error mode, so that a
sync there raises. Eagerly (the CPU, and a first cycle on the card) the
same step functions run with a host check of the flag, which stops at the
first step that fails it; a masked step leaves every buffer as it was, so
the two give the same bits.

A replay runs no Python, so no kernel wrapper counts its launches: the
counts that the capture added are taken back, and each replay adds them
again (a replay runs everything it captured) to each dict in ``COUNTS``.
For the same reason the tracer's stages inside a cycle (``schwarz_apply``,
``fmm_matvec``) are timed in its eager and capture runs only; each cycle
is the stage ``fgmres_cycle``, each capture ``fused_graph_capture`` (its
stages inside the capture skip their synchronize), and the tracer's
``fgmres_iters`` counts each cycle's steps from its stats on the host.

Three gates keep the host loop (``ok`` False, ``gate`` names the one that
fired): the coarse system is not SPD; a Schwarz level recomputes its
factors per application; the stored factors of all ranks exceed
``FACTOR_BYTES_MAX``.

Under a mesh every rank runs the same cycles on the same bits. Over NCCL
the capture holds the passes' all-reduces (the eager first cycle has run
each of them once); gloo's cannot be captured, so under a gloo mesh of
more ranks than one every cycle runs eagerly (``stats["graphs"]`` stays 0
and ``stats["graph_gate"]`` says why, from ``Mesh.capturable``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..interpolant_config import FittingAccuracy, FittingAccuracyType
from ..ops.fmm import near_field
from ..progress import SolverIteration, emit, progress_from_rel
from ..utils.timing import count, record_event, to_device, traced_stage
from .schwarz import schwarz_preconditioner

# Stored Schwarz factors above which the host loop is kept: the JAX
# package's gate (its fused loop body held ~9x the factor bytes live).
FACTOR_BYTES_MAX = 512 << 20

# Python-side count dicts that a replay keeps exact: near_field.LAUNCHES,
# and any dict of counts a caller appends while it counts wrapper calls of
# its own (chip_smoke.py's per-leg counter).
COUNTS = [near_field.LAUNCHES]

# The side stream of every fused system on a device, made once: cuBLAS keeps
# a workspace (32 MiB on an H100) on the card for each stream it has run
# on, so a stream per system would hold one more workspace after each fit,
# up to the 32 streams of torch's pool.
_CAPTURE_STREAMS = {}


def _capture_stream(dev) -> torch.cuda.Stream:
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


def _givens_device(f, g):
    """(c, s, r) with dlartg semantics, without branches (cf.
    ``fgmres.givens_rotation``); 0-d float64 tensors."""
    d = torch.hypot(f, g)  # sqrt(f^2 + g^2) without overflow
    one = torch.ones_like(d)
    sgnf = torch.where(f >= 0.0, one, -one)
    sgng = torch.where(g >= 0.0, one, -one)
    c = torch.where(g == 0.0, one, torch.where(f == 0.0, 0.0, f.abs() / d))
    s = torch.where(g == 0.0, 0.0, torch.where(f == 0.0, sgng, g * sgnf / d))
    r = torch.where(g == 0.0, f, torch.where(f == 0.0, g.abs(), sgnf * d))
    return c, s, r


@contextlib.contextmanager
def _taken_back():
    """Counts that the wrappers add inside the block (a capture, which runs
    nothing) are taken back; the yielded list receives them as (count
    dict, {key: n}) pairs."""
    before = [dict(c) for c in COUNTS]
    taken = []
    try:
        yield taken
    finally:
        for c, b in zip(COUNTS, before):
            taken.append((c, {k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}))
            c.clear()
            c.update(b)


class _Graph:
    """One captured cycle: the graph, its static inputs and outputs, the
    pinned host copy of the stats and the counts its capture took back."""

    def __init__(self, b, x, r, mi):
        dev = b.device
        self.mi = mi
        self.graph = torch.cuda.CUDAGraph()
        self.b, self.x, self.r = b.clone(), x.clone(), r.clone()
        self.beta = torch.zeros((), dtype=torch.float64, device=dev)
        self.tol = torch.zeros((), dtype=torch.float64, device=dev)
        self.host = torch.empty(3 + mi, dtype=torch.float64, pin_memory=True)
        self.done = torch.cuda.Event()
        self.counts = []
        self.out = None


class FusedSystem:
    """The fused solver's view of a ``DeviceSystem``: its operators, the
    Schwarz preconditioner with the coarse solve on the device, and the
    restart cycle (captured per key on a CUDA device)."""

    f64_prec = "f64"

    def __init__(self, system):
        self.system = system
        self.n, self.m = system.n, system.m
        ddm = system.ddm_tree
        self.ddm = ddm
        self.factor_bytes = ddm.factor_bytes  # the same on every rank
        mesh = system.fmm_tree.mesh
        self.stats = {"graphs": 0, "cycles": 0, "replays": 0, "host_pulls": 0,
                      "masked_steps": 0, "graph_gate": None}
        if mesh is not None and not mesh.capturable:
            self.stats["graph_gate"] = "gloo collectives cannot be captured"
        self._graphs = {}
        self.ok, self.gate = False, None
        coarse = ddm.coarse_device_arrays()
        if coarse is None:
            self.gate = "coarse system not SPD"
        elif any(level.recompute for level in ddm.levels[:-1]):
            self.gate = "a Schwarz level recomputes its factors"
        elif self.factor_bytes > FACTOR_BYTES_MAX:
            self.gate = f"factor bytes above {FACTOR_BYTES_MAX}"
        else:
            self.coarse, self.coarse_k, self.coarse_poly = coarse
            self.ok = True

    # ---------------------------------------------------------- operators
    def matvec(self, w, prec):
        return self.system.matvec(w, precision=prec)

    def _solve_coarse(self, residual, add_poly):
        """The coarse direct solve from its Cholesky factor on the device;
        the polynomial tail from the special points when ``add_poly``."""
        c, k = self.coarse, self.coarse_k
        gathered = residual[c["idx"]]
        rhs = c["q_top"].T @ gathered[:k] + gathered[k:] if k else gathered
        y = torch.linalg.solve_triangular(c["chol"], rhs, upper=False)
        gamma = torch.linalg.solve_triangular(c["chol"].T, y, upper=True)
        coeffs = torch.cat([c["q_top"] @ gamma, gamma]) if k else gamma
        out = torch.zeros_like(residual)
        out[c["idx"]] = coeffs
        if self.coarse_poly and add_poly:
            out[-k:] = c["inv_special"] @ (gathered[:k] - c["a_special"] @ coeffs)
        return out

    def precon(self, rg):
        """``schwarz_preconditioner`` (the system's restricted matvecs, the
        tree's batched fine-level solves) with the coarse solve on the
        device."""
        system = self.system
        return schwarz_preconditioner(rg, self.ddm, system.matvec_partial, system.settings,
                                      system.ortho_poly, solve_coarse=self._solve_coarse)

    # -------------------------------------------------------------- cycle
    def _start(self, r, mi):
        """The cycle's buffers: basis vectors and preconditioned vectors as
        rows (V (mi+1, n), Z (mi, n)), H, g, cs, sn, hist, the steps run jf
        and the residual res."""
        n_tot = r.shape[0]
        r_norm = torch.linalg.norm(r)
        new = lambda *shape: r.new_zeros(shape)  # noqa: E731
        st = {"V": new(mi + 1, n_tot), "Z": new(mi, n_tot), "H": new(mi + 1, mi),
              "g": new(mi + 1), "cs": new(mi), "sn": new(mi), "hist": new(mi),
              "jf": torch.zeros((), dtype=torch.int64, device=r.device),
              "res": torch.full((), math.inf, dtype=torch.float64, device=r.device)}
        st["V"][0] = torch.where(r_norm > 0.0, r[:, 0] / r_norm, r[:, 0])
        st["g"][0] = r_norm
        return st

    def _step(self, st, j, flag, prec, tol_abs, beta):
        """Inner step ``j``; its updates gated by the device boolean ``flag``
        (a step whose flag is false leaves every buffer as it was)."""
        V, g, cs, sn = st["V"], st["g"], st["cs"], st["sn"]
        mi = cs.shape[0]
        w = self.precon(V[j][:, None])
        wj = self.matvec(w, prec)[:, 0]
        # CGS2 over the basis so far ("twice is enough")
        basis = V[: j + 1]
        h1 = basis @ wj
        wj = wj - basis.T @ h1
        h2 = basis @ wj
        wj = wj - basis.T @ h2
        norm = torch.linalg.norm(wj)
        hcol = torch.cat([h1 + h2, norm[None], wj.new_zeros(mi - j - 1)])
        for i in range(j):
            a, b = hcol[i], hcol[i + 1]
            hcol[i : i + 2] = torch.stack([cs[i] * a + sn[i] * b, -sn[i] * a + cs[i] * b])
        c, s, _ = _givens_device(hcol[j], hcol[j + 1])
        hcol[j : j + 2] = torch.stack([c * hcol[j] + s * hcol[j + 1], torch.zeros_like(c)])
        gj = torch.stack([c * g[j] + s * g[j + 1], -s * g[j] + c * g[j + 1]])
        res = gj[1].abs() if tol_abs else gj[1].abs() / beta
        vnew = torch.where(norm != 0.0, wj / norm, wj)
        for dst, val in ((st["Z"][j], w[:, 0]), (st["H"][:, j], hcol), (g[j : j + 2], gj),
                         (cs[j], c), (sn[j], s), (V[j + 1], vnew), (st["hist"][j], res),
                         (st["res"], res)):
            dst.copy_(torch.where(flag, val, dst))
        st["jf"].add_(flag.long())

    def _end(self, st, b, x, prec, tol_abs, beta):
        """Masked back-substitution (unit diagonal and zero right-hand side
        past jf), x += Z^T y, r = b - A x; returns (x, r, stats)."""
        mi = st["hist"].shape[0]
        steps = torch.arange(mi, device=b.device)
        hs = st["H"][:mi] + torch.diag((steps >= st["jf"]).double())
        gs = torch.where(steps < st["jf"], st["g"][:mi], 0.0)
        y = torch.linalg.solve_triangular(hs, gs[:, None], upper=True)
        x = x + st["Z"].T @ y
        r = b - self.matvec(x, prec)
        res_r = r.abs().max() if tol_abs else torch.linalg.norm(r) / beta
        stats = torch.cat([torch.stack([st["res"], res_r, st["jf"].double()]), st["hist"]])
        return x, r, stats

    def _run(self, key, b, x, r, beta, tol, masked=False):
        """One cycle on 0-d device tensors ``beta`` and ``tol``: eagerly it
        stops at the first step whose flag fails on the host; ``masked``
        (for a capture) runs every step, gated by its flag."""
        prec, tol_abs, mi = key
        st = self._start(r, mi)
        for j in range(mi):
            flag = st["res"] >= tol  # and j < mi, by the loop
            if not masked and not bool(flag):
                break
            self._step(st, j, flag, prec, tol_abs, beta)
        return self._end(st, b, x, prec, tol_abs, beta)

    def cycle(self, prec, tol_abs, mi, b, x, r, beta, tol, eager=False):
        """One restart cycle from (x, r): returns (x, r, stats) with stats a
        host array [res_g, res_r, jf, hist...]. On a CUDA device the first
        cycle of a key runs eagerly and is then captured, and later cycles
        replay it; ``eager`` runs the cycle eagerly all the same."""
        key = (prec, bool(tol_abs), int(mi))
        graph = self._graphs.get(key)
        eager = eager or self.stats["graph_gate"] is not None
        self.stats["cycles"] += 1
        if graph is not None and not eager:
            return self._replay(graph, b, x, r, beta, tol)
        dev = b.device
        if dev.type != "cuda":
            x, r, stats = self._run(key, b, x, r, *self._scalars(dev, beta, tol))
            self.stats["host_pulls"] += 1
            return x, r, stats.cpu().numpy()
        stream, main = _capture_stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            x, r, stats = self._run(key, b, x, r, *self._scalars(dev, beta, tol))
            stats = stats.cpu().numpy()  # the cycle's one pull; the stream is idle after it
        self.stats["host_pulls"] += 1
        main.wait_stream(stream)
        if graph is None and not eager:
            self._capture(key, b, x, r)
        return x, r, stats

    @staticmethod
    def _scalars(dev, beta, tol):
        return (to_device(float(beta), dev, torch.float64),
                to_device(float(tol), dev, torch.float64))

    def _capture(self, key, b, x, r):
        with traced_stage("fused_graph_capture"):
            graph = _Graph(b, x, r, key[2])
            with _taken_back() as graph.counts, torch.cuda.graph(
                    graph.graph, stream=_capture_stream(b.device)):
                graph.out = self._run(key, graph.b, graph.x, graph.r, graph.beta, graph.tol,
                                      masked=True)
        self._graphs[key] = graph
        self.stats["graphs"] += 1

    def _replay(self, graph, b, x, r, beta, tol):
        for dst, src in ((graph.b, b), (graph.x, x), (graph.r, r)):
            dst.copy_(src)
        graph.beta.fill_(float(beta))
        graph.tol.fill_(float(tol))
        graph.graph.replay()
        graph.host.copy_(graph.out[2], non_blocking=True)
        graph.done.record()
        graph.done.synchronize()
        stats = graph.host.numpy().copy()
        self.stats["replays"] += 1
        self.stats["host_pulls"] += 1
        self.stats["masked_steps"] += graph.mi - int(stats[2])
        for counts, delta in graph.counts:
            if any(counts is c for c in COUNTS):
                for k, v in delta.items():
                    counts[k] = counts.get(k, 0) + v
        return graph.out[0].clone(), graph.out[1].clone(), stats


def fgmres_fused(
    fs: FusedSystem,
    b,
    prec,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback=None,
    x0=None,
):
    """Restarted FGMRES over device cycles; one host pull per restart.

    The stopping semantics of :func:`.fgmres.fgmres_device`, which stays
    the host loop for systems the gates turn away."""
    tolerance = tolerance or FittingAccuracy()
    tol_abs = tolerance.tolerance_type == FittingAccuracyType.Absolute
    b = b.reshape(-1, 1)
    mi = max_inner_iterations

    if x0 is None:
        # A(0) == 0 exactly (the operator is linear): r0 = b, no matvec
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - fs.matvec(x, prec)
    beta = float(r.abs().max() if tol_abs else torch.linalg.norm(r))
    if beta == 0.0:
        return x

    iteration = 1
    for _outer in range(max_outer_iterations):
        with traced_stage("fgmres_cycle"):
            x, r, stats = fs.cycle(prec, tol_abs, mi, b, x, r, beta, tolerance.tolerance)
        res_g, res_r, jf = float(stats[0]), float(stats[1]), int(stats[2])
        count("fgmres_iters", jf)
        for j in range(jf):
            res = float(stats[3 + j])
            emit(callback, SolverIteration(
                iter=iteration, residual=res,
                progress=progress_from_rel(res, beta, tolerance.tolerance)))
            iteration += 1
        if res_g < tolerance.tolerance or res_r < tolerance.tolerance:
            return x
    return x


def refined_fgmres_fused(
    fs: FusedSystem,
    b,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback=None,
    max_refinements: int = 8,
):
    """Mixed-precision iterative refinement over device cycles.

    The escalation logic of :func:`.fgmres.refined_fgmres_device`: f32
    inner Krylov solves, f64 outer residuals, the inner operator escalated
    to f64 when a round fails to contract, the best iterate kept for stiff
    systems. Like the JAX package's fused path it has no stall exit."""
    tolerance = tolerance or FittingAccuracy()
    tol_abs = tolerance.tolerance_type == FittingAccuracyType.Absolute
    b = b.reshape(-1, 1)
    x = torch.zeros_like(b)

    beta = float(b.abs().max() if tol_abs else torch.linalg.norm(b))
    if beta == 0.0:
        return x

    def residual(x):
        r = b - fs.matvec(x, fs.f64_prec)
        return r, float(r.abs().max()) if tol_abs else float(torch.linalg.norm(r)) / beta

    inner_drop = 1e-5  # what one f32 inner solve reliably achieves
    inner_prec = "f32"
    escalated = False
    prev_res = np.inf
    best_res = np.inf
    best_x = x

    for _refine in range(max_refinements):
        r, res = residual(x)
        if res < best_res:
            best_res = res
            best_x = x
        if res < tolerance.tolerance:
            break
        if res > 0.5 * prev_res:
            if escalated:
                break  # not contracting even with the f64 inner operator
            inner_prec = fs.f64_prec
            escalated = True
            x = best_x  # restart refinement from the best point
            r = b - fs.matvec(x, fs.f64_prec)
            res = best_res
        prev_res = res

        remaining = tolerance.tolerance / max(res, 1e-300)
        if tol_abs:
            remaining = tolerance.tolerance / max(float(torch.linalg.norm(r)), 1e-300)
        inner_tol = max(inner_drop if not escalated else 1e-9, 0.3 * remaining)
        record_event("refine_round", {
            "round": _refine,
            "residual": float(f"{res:.3e}"),
            "inner_tier": "f64" if escalated else "f32",
        })
        dx = fgmres_fused(
            fs, r, prec=inner_prec, max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
            tolerance=FittingAccuracy(inner_tol, FittingAccuracyType.Relative),
            callback=callback,
        )
        x = x + dx

    _, res = residual(x)
    final = min(res, best_res)
    record_event("solve_done", {
        "residual": float(f"{final:.3e}"),
        "tolerance": tolerance.tolerance,
        "converged": bool(final < tolerance.tolerance),
        "escalated": escalated,
    })
    return x if res <= best_res else best_x
