"""Config 5: the 3M-point signed-distance fit and its RMT isosurface.

The port's counterpart of ``bench.py`` ``config5_3m_rmt``: config 4's data
(signed-distance samples in a shell around a bumpy unit sphere, seed 11)
at N points, fitted with LinearRbf under default Params, then isosurfaced
at its zero level over [-1.4, 1.4]^3 with no boundary closure:

    python3 -m ferreus_rbf_tpu_torch.scripts.config5_isosurface
    python3 -m ferreus_rbf_tpu_torch.scripts.config5_isosurface 1000000
    python3 -m ferreus_rbf_tpu_torch.scripts.config5_isosurface 3000 --resolution 0.1 --device cpu

It prints progress lines, then one JSON line: the fit's report, which
``fit_at_scale.py`` prints too (``fit_at_scale.fit_and_report``: the
card's name and power limit, the fit's seconds, stages, residual,
refinement rounds and solver path, whether the P2M/L2P weights were made
per chunk, the fit's peak device memory ``peak_device_gb`` and a dense f64
oracle at 512 sources on the fit's device), the isosurface's seconds split into the evaluator's build, seed projection
(unique seeds, Newton calls and their targets), the lattice evaluations of
the wavefront (calls, points) and the host RMT (the rest), the mesh's
size, the checks below, the near-field kernels' launches during the
isosurface, and the isosurface's own peak device memory
(``peak_isosurface_gb``).

The run fails (a raised error, a non-zero exit) unless: the fit reaches
the solver's 1e-6 residual and the oracle's residual stays below 1e-4 of
max |values|; the mesh is non-empty with finite vertices, closed (every
edge on exactly two facets), one component with V - E + F = 2; every
vertex lies within one lattice step of the bumpy sphere, the data's exact
zero level; the fitted field at 1,024 vertices (``evaluate``) agrees with a
dense f64 sum of the same coefficients within 1e-4 of max |values|; and,
on the card, the value and gradient kernels (H2, H3) launched. There is
no retry and no fallback: without a card and without ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .fit_at_scale import dense_field, fit_and_report

EXTENTS = [-1.4] * 3 + [1.4] * 3
RESIDUAL_BOUND = 1e-6  # the solver's default tolerance
ORACLE_BOUND = 1e-4  # relative to max |values| (bench.py's oracle bound for fits)
VERTEX_SAMPLE = 1024


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bumpy_sphere_deviation(verts):
    """|‖v‖ − r(v/‖v‖)| per vertex, where r(u) = 1 + 0.15 sin(4 u_x) cos(3 u_y)
    is the radius of the data's zero level (``synthetic_sd``)."""
    norm = np.linalg.norm(verts, axis=1)
    u = verts / norm[:, None]
    return np.abs(norm - (1.0 + 0.15 * np.sin(4 * u[:, 0]) * np.cos(3 * u[:, 1])))


def check_mesh(verts, facets, resolution):
    """The mesh's checks: non-empty, finite, closed (every edge on exactly
    two facets), one component with V − E + F = 2, and every vertex within
    one lattice step of the bumpy sphere. Returns what it measured; raises
    ``AssertionError`` on the first check that fails."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if facets.shape[0] == 0:
        raise AssertionError("an empty mesh")
    if not np.isfinite(verts).all() or facets.min() < 0 or facets.max() >= verts.shape[0]:
        raise AssertionError("vertices not finite or facets out of range")
    edges = np.sort(facets[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    edges, uses = np.unique(edges, axis=0, return_counts=True)
    nv = verts.shape[0]
    graph = coo_matrix((np.ones(edges.shape[0]), (edges[:, 0], edges[:, 1])), shape=(nv, nv))
    components = int(connected_components(graph, directed=False)[0])
    dev = bumpy_sphere_deviation(verts)
    out = {"edges": int(edges.shape[0]), "facets_per_edge": [int(uses.min()), int(uses.max())],
           "components": components,
           "euler_characteristic": int(nv - edges.shape[0] + facets.shape[0]),
           "surface_deviation_max": float(dev.max()),
           "surface_deviation_mean": float(dev.mean())}
    if not (uses == 2).all():
        raise AssertionError(f"the mesh is not closed: facets per edge {out['facets_per_edge']}")
    if components != 1 or out["euler_characteristic"] != 2:
        raise AssertionError(f"not one sphere: {components} components, "
                             f"V - E + F = {out['euler_characteristic']}")
    if not out["surface_deviation_max"] <= resolution:
        raise AssertionError(f"a vertex lies {out['surface_deviation_max']:.3e} from the bumpy "
                             f"sphere, more than one lattice step ({resolution})")
    return out


def check_vertex_values(rbfi, verts, scale, n=VERTEX_SAMPLE, seed=5):
    """The fitted field (``evaluate``, f64) at ``n`` vertices against a dense
    f64 sum of the same coefficients; raises ``AssertionError`` unless they
    agree within ``ORACLE_BOUND`` of ``scale`` (max |values|)."""
    idx = np.sort(np.random.default_rng(seed).choice(verts.shape[0], min(n, verts.shape[0]),
                                                      replace=False))
    t0 = time.perf_counter()
    fmm = np.asarray(rbfi.evaluate(verts[idx])).reshape(-1)
    _sync(rbfi.device)
    evaluate_s = time.perf_counter() - t0
    oracle = dense_field(rbfi, verts[idx])
    out = {"n": int(idx.size), "evaluate_s": evaluate_s,
           "evaluate_vs_oracle_rel": float(np.max(np.abs(fmm - oracle))) / scale,
           "oracle_max_abs": float(np.max(np.abs(oracle)))}
    if not out["evaluate_vs_oracle_rel"] < ORACLE_BOUND:
        raise AssertionError(f"evaluate at the vertices is {out['evaluate_vs_oracle_rel']:.3e} "
                             f"of max |values| from the dense oracle")
    return out


def timed_isosurface(rbfi, extents, resolution, isovalue=0.0):
    """``rbfi.build_isosurface`` with its time split: the evaluator's build
    (``build_evaluator``), seed projection (its Newton steps are the
    gradient calls), the lattice evaluations (``evaluate_targets``) and the
    host RMT (the rest). Returns (mesh, split, launches, tracer totals):
    the near-field kernels' launches counted from zero over the call."""
    from ..isosurfacing import BoundaryClosure
    from ..ops.fmm import near_field as nf
    from ..utils import timing

    split = {"newton_targets": [], "newton_call_s": [], "lattice_targets": [],
             "lattice_call_s": []}

    def counted(fn, key):
        def wrapper(targets):
            t0 = time.perf_counter()
            out = fn(targets)  # host arrays: the device work has finished
            split[f"{key}_call_s"].append(time.perf_counter() - t0)
            split[f"{key}_targets"].append(len(targets))
            return out
        return wrapper

    build = rbfi.build_evaluator

    def timed_build(*args):
        t0 = time.perf_counter()
        build(*args)
        _sync(rbfi.device)
        split["build_evaluator_s"] = time.perf_counter() - t0

    rbfi.build_evaluator = timed_build
    rbfi.evaluate_targets = counted(rbfi.evaluate_targets, "lattice")
    rbfi.evaluate_targets_with_gradients = counted(rbfi.evaluate_targets_with_gradients,
                                                   "newton")
    _sync(rbfi.device)
    nf.reset_launches()
    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    try:
        mesh = rbfi.build_isosurface(extents, resolution, isovalue, BoundaryClosure.None_)
        _sync(rbfi.device)
    finally:
        timing.disable_global_tracer()
        del rbfi.evaluate_targets, rbfi.evaluate_targets_with_gradients, rbfi.build_evaluator
    iso_s = time.perf_counter() - t0
    launches = dict(nf.LAUNCHES)
    seed_s = tracer.totals["rmt_seed_projection"]
    lattice_s = sum(split["lattice_call_s"])
    newton = split["newton_targets"]
    split.update(
        isosurface_s=iso_s, seed_projection_s=seed_s, seed_unique=newton[0] if newton else 0,
        newton_calls=len(newton), newton_s=sum(split["newton_call_s"]),
        lattice_calls=len(split["lattice_targets"]),
        lattice_points=sum(split["lattice_targets"]), lattice_s=lattice_s,
        host_rmt_s=iso_s - split["build_evaluator_s"] - seed_s - lattice_s)
    events = tracer.events
    split["evaluator_p2m_per_chunk"] = any(
        not e["p2m_resident"] for e in events if e["event"] == "fmm_tree")
    split["l2p_per_chunk_calls"] = sum(
        not e["l2p_resident"] for e in events if e["event"] == "fmm_targets")
    return mesh, split, launches, tracer.totals


def main(argv=None):
    """Run config 5; print its JSON line and return (record, mesh)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=3_000_000, help="number of points")
    ap.add_argument("--resolution", type=float, default=0.02, help="lattice step")
    ap.add_argument("--seed", type=int, default=11, help="seed of the synthetic data")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass --device cpu to run on the CPU")

    out = {"n": args.n, "resolution": args.resolution, "extents": EXTENTS, "seed": args.seed,
           "kernel": "Linear (biharmonic)", "device": str(dev)}
    rbfi, sd, fit = fit_and_report(args.n, args.seed, dev, tag="config5")
    out.update(fit)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh, split, launches, stages = timed_isosurface(rbfi, EXTENTS, args.resolution)
    out["isosurface_s"] = split.pop("isosurface_s")
    out["isosurface_split"] = split
    out["isosurface_stages_s"] = stages
    out["isosurface_launches"] = launches
    if on_card:
        out["peak_isosurface_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    verts, facets = mesh.vertices, mesh.facets
    out["mesh"] = {"vertices": int(mesh.num_vertices), "facets": int(mesh.num_facets)}
    print(f"[config5] isosurface done in {out['isosurface_s']:.3f} s: {out['mesh']}", flush=True)

    checks = {}
    out["checks"] = checks
    try:
        if "solver_converged" in out and not (
                out["solver_converged"] and out["solver_residual_rel"] <= RESIDUAL_BOUND):
            raise AssertionError(f"the fit did not converge: {out['solver_residual_rel']}")
        res = out["true_residual_rel_max"]
        if not res < ORACLE_BOUND:
            raise AssertionError(f"the oracle's residual {res:.3e} is past {ORACLE_BOUND:.0e}")
        checks["mesh"] = check_mesh(verts, facets, args.resolution)
        checks["vertex_values"] = check_vertex_values(rbfi, verts, float(np.max(np.abs(sd))))
        if on_card and not (launches["near_field_f64"] and launches["near_field_grad_f64"]):
            raise AssertionError(f"H2 or H3 never launched in the isosurface: {launches}")
        checks["passed"] = True
    finally:
        print(json.dumps(out), flush=True)
    return out, mesh


if __name__ == "__main__":
    main()
