"""A closed loop of standalone FMM matvecs: the public
``ferreus_rbf_tpu_torch.bbfmm.FmmTree``, built once over the configuration's
points, then ``set_weights(W)`` and ``evaluate(W, points)`` for every block
of weights, one client, each call started when the last returned.

Set-up builds the tree from the configuration's ``kernel`` and ``fmm``
settings, draws ``pool`` blocks of weights (``points`` x ``rhs``, standard
normal, block j from (seed, j)) and runs one warm step on a block of its
own. Step k takes block k mod ``pool`` and returns the targets it
evaluated (the sources themselves, the same host array every call).

The check: ``value_err``, for every call the largest |evaluate - reference|
over ``check_rows`` rows of its block (drawn from the seed) and every
column, over the largest |reference| of those rows; the largest over the
window. The reference is ``reference/kernel_sum.py``'s float64 sum.
``value_err`` is bounded below by the FMM's truncation, which hides a
float32 run; so ``linearity_err``, read on the timed tree after the window
(in ``release``), cancels the truncation: with E(w) = ``set_weights(w)``
then ``evaluate(w, points)`` for pool block 0 (a), a block of its own (b)
and a + b, max |E(a + b) - E(a) - E(b)| over the largest |E|. The
operators do not depend on the weights, so only rounding is left: about
1e-15 in float64, 1e-7 and above in float32.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmark import inputs
from benchmark.reference import kernel_sum

# the configuration's kernel -> the standalone FMM's kernel type (the kernels
# without parameters)
FMM_KERNELS = {"Linear": "LinearRbf", "ThinPlateSpline": "ThinPlateSplineRbf",
               "Cubic": "CubicRbf"}


def _tree(cell, points):
    bb = importlib.import_module(f"{cell.frt.__name__}.bbfmm")
    k, f = cell.config["kernel"], cell.config["fmm"]
    if k.get("drift", "None") != "None":
        raise ValueError("the standalone FMM sums no drift")
    kernel = bb.KernelParams(bb.FmmKernelType[FMM_KERNELS[k["type"]]])
    params = bb.FmmParams(interpolation_order=f["interpolation_order"],
                          max_points_per_cell=f["max_points_per_cell"],
                          compression_type=bb.M2LCompressionType[f["compression_type"]],
                          epsilon=f["epsilon"])
    return bb.FmmTree(points, f["interpolation_order"], kernel, adaptive_tree=f["adaptive_tree"],
                      sparse=f["sparse"], params=params, device=cell.device)


def _weights(cell, *keys):
    return cell.rng("weights", *keys).standard_normal((cell.config["points"],
                                                       cell.config["rhs"]))


def setup(cell):
    points = inputs.points_and_values(cell, "sources")[0]
    pool, n = cell.workload["pool"], points.shape[0]
    cell.state["points"] = points
    cell.state["weights"] = [_weights(cell, j) for j in range(pool)]
    cell.state["rows"] = [np.sort(cell.rng("check", j).choice(
        n, min(cell.workload["check_rows"], n), replace=False)) for j in range(pool)]
    cell.state["calls"] = []
    cell.state["tree"] = tree = _tree(cell, points)
    warm = _weights(cell, "warm")
    tree.set_weights(warm)
    tree.evaluate(warm, points)
    cell.sync()


def step(cell, k):
    j = k % cell.workload["pool"]
    tree, w, points = cell.state["tree"], cell.state["weights"][j], cell.state["points"]
    tree.set_weights(w)
    values = tree.evaluate(w, points)
    cell.state["calls"].append((j, values[cell.state["rows"][j]].copy()))
    return points.shape[0]


def _linearity(tree, points, a, b):
    out = []
    for w in (a, b, a + b):
        tree.set_weights(w)
        out.append(tree.evaluate(w, points))
    ea, eb, eab = out
    return float(np.max(np.abs(eab - ea - eb))) / max(float(np.max(np.abs(e))) for e in out)


def release(cell):
    tree = cell.state.pop("tree", None)
    if tree is not None:
        cell.state["linearity_err"] = _linearity(tree, cell.state["points"],
                                                 cell.state["weights"][0],
                                                 _weights(cell, "linearity"))


def check(cell):
    kernel, points = inputs.reference_kernel(cell), cell.state["points"]
    want = {}
    for j in sorted({j for j, _ in cell.state["calls"]}):
        want[j] = kernel_sum.kernel_sum(kernel, points, cell.state["weights"][j],
                                        points[cell.state["rows"][j]], device=cell.device)
    errs = [float(np.max(np.abs(got - want[j]))) / float(np.max(np.abs(want[j])))
            for j, got in cell.state["calls"]]
    limit = cell.workload["limits"]["value_err"]
    cell.state["failed_steps"] = sum(not e <= limit for e in errs)
    lin = cell.state.get("linearity_err", float("inf"))
    return {"value_err": max(errs) if all(np.isfinite(errs)) else float("inf"),
            "linearity_err": lin if np.isfinite(lin) else float("inf")}
