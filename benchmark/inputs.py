"""A configuration file read into the port's settings and into inputs made
from the run's seed. Both sides of a run get the arrays made here."""

from __future__ import annotations

import os

import numpy as np

from .reference import data

DRIFT_DEGREE = {"None": -1, "Constant": 0, "Linear": 1, "Quadratic": 2}


def points_and_values(cell, *keys):
    """One input set of the configuration: (points (n, d), values (n,)),
    made by ``generators/<kind>.py`` (``kind`` is the configuration's
    ``data.kind``) from a stream of the seed and ``keys``."""
    kind = cell.config["data"]["kind"]
    if kind not in cell.generators:
        from .harness import load_module

        cell.generators[kind] = load_module(cell.path("generators", f"{kind}.py"),
                                            f"benchmark_generator_{kind}")
    return cell.generators[kind].points_and_values(cell, cell.rng("data", *keys))


def csv_rows(cell):
    """The configuration's CSV rows, read once per run; a configuration with
    fewer ``points`` than rows keeps a fixed subset (seed 0)."""
    if "csv" not in cell.state:
        pts, vals = data.read_points_csv(os.path.join(cell.root, cell.config["data"]["path"]))
        n = cell.config["points"]
        if n > pts.shape[0]:
            raise ValueError(f"{cell.config['data']['path']} has {pts.shape[0]} rows, not {n}")
        if n < pts.shape[0]:
            keep = np.sort(np.random.default_rng(0).choice(pts.shape[0], n, replace=False))
            pts, vals = pts[keep], vals[keep]
        cell.state["csv"] = (pts, vals)
    return cell.state["csv"]


def span(cell) -> float:
    """The widest side of the CSV data set's box (a spheroidal kernel may
    give its range and sill over it)."""
    pts = csv_rows(cell)[0]
    return float(np.max(pts.max(0) - pts.min(0)))


def reference_kernel(cell) -> dict:
    """The kernel as ``reference/field.py`` takes it."""
    k = cell.config["kernel"]
    if k["type"] == "Spheroidal":
        out = {"type": "Spheroidal", "order": k["order"]}
        for key, over in (("base_range", "range_over_span"), ("total_sill", "sill_over_span")):
            out[key] = k[key] if key in k else k[over] * span(cell)
        return out
    return {"type": k["type"]}


def drift_degree(cell) -> int:
    return DRIFT_DEGREE[cell.config["kernel"]["drift"]]


def settings(cell):
    """(InterpolantSettings, Params) of the port: the kernel's default Params."""
    frt = cell.frt
    k = cell.config["kernel"]
    kw = {"kernel_type": frt.RBFKernelType[k["type"]],
          "drift": frt.Drift(k["drift"]),
          "nugget": float(k.get("nugget", 0.0)),
          "fitting_accuracy": frt.FittingAccuracy(
              tolerance=cell.config["fit"]["tolerance"],
              tolerance_type=frt.FittingAccuracyType[cell.config["fit"]["tolerance_type"]])}
    if k["type"] == "Spheroidal":
        ref = reference_kernel(cell)
        kw.update(spheroidal_order=frt.SpheroidalOrder(k["order"]),
                  base_range=ref["base_range"], total_sill=ref["total_sill"])
    settings = frt.InterpolantSettings(**kw)
    return settings, frt.Params.new_defaults(settings.kernel_type)
