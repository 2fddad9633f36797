"""Readings behind each limit of ``workloads/<cell>.json``: the port's judged
numbers over many seeds (the lower reading), its control's and planted
faults' (the upper).

    python3 benchmark/control.py --workload albatite.fit --variant program --seeds 1-12
    python3 benchmark/control.py --workload albatite.fit --variant order5 --seeds 101-103

``--variant`` puts a substitute in the port's place, for the whole process:
``program`` (the cell as it runs); ``order5``, the control, which breaks
the accuracy the configuration states (the FMM at interpolation order 5
where it states 7); ``f32``, the port's own float32 path switched on
(every FMM pass in float32, ``FmmTree.evaluate_device(..., "f32")``: the
solver's refinement residuals and the one-shot ``evaluate`` too), read to
show what float32 does to each judged number; the faults ``unchanged`` (a fit returns zeros, an ``evaluate`` its first
call's values), ``half`` (half of the rows or targets left out, the mean
of the rest in their place) and ``altered`` (one coefficient doubled; a
sixteenth of the targets 1% off). Each seed sets up the cell, measures a
window of ``--seconds`` (one step at least) and judges it; one JSON line
per seed, then one with the largest and smallest reading of each number.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fmm_f32():
    """Every FMM pass of the port in float32."""
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

    device_pass = FmmTree.evaluate_device

    def evaluate_device(self, weights_dev, reuse_key, precision="f64"):
        return device_pass(self, weights_dev, reuse_key, "f32")

    def evaluate(self, weights, target_points, reuse_key=None):
        key = ("f32 control", reuse_key)
        self._bin_targets(target_points, key)
        return device_pass(self, self._as_weights(weights), key, "f32").cpu().numpy()

    return [mock.patch.object(FmmTree, "evaluate_device", evaluate_device),
            mock.patch.object(FmmTree, "evaluate", evaluate)]


def _order5():
    import ferreus_rbf_tpu_torch as frt

    defaults = frt.Params.new_defaults

    def new_defaults(kernel_type):
        params = defaults(kernel_type)
        params.fmm_params.interpolation_order = 5
        return params

    return [mock.patch.object(frt.Params, "new_defaults", new_defaults)]


def _fit_fault(kind):
    """An ``RBFInterpolator`` whose fit comes out wrong."""
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.solver.domain import Coefficients

    base = frt.RBFInterpolator

    class Faulty(base):
        def __init__(self, points, values, settings, params=None, device=None):
            n = len(points) // 2 if kind == "half" else len(points)
            super().__init__(points[:n], values[:n], settings, params, device=device)
            w = self.coefficients.point_coefficients
            if kind == "unchanged":  # the coefficients it started from
                w = np.zeros_like(w)
            elif kind == "half":  # the rows left out get the mean coefficient
                full = np.repeat(w.mean(0, keepdims=True), len(points), 0)
                full[:n] = w
                w, self.points = full, np.asarray(points, np.float64)
            else:  # the largest coefficient doubled
                w = w.copy()
                w[np.argmax(np.abs(w[:, 0])), 0] *= 2.0
            self.coefficients = Coefficients(w, self.coefficients.poly_coefficients)

    return Faulty


def _evaluate_fault(kind):
    """An ``RBFInterpolator.evaluate`` whose values come out wrong."""
    import ferreus_rbf_tpu_torch as frt

    base = frt.RBFInterpolator.evaluate

    def evaluate(self, targets):
        if kind == "unchanged":  # every call returns its first call's values
            if not hasattr(self, "_first_values"):
                self._first_values = base(self, targets)
            return self._first_values
        v = np.array(base(self, targets), copy=True)
        if kind == "half":
            v[1::2] = v[0::2].mean()
        else:  # a sixteenth of the targets, one block, 1% off
            v[: len(v) // 16] *= 1.01
        return v

    return evaluate


FAULTS = ("unchanged", "half", "altered")
VARIANTS = ("program", "f32", "order5") + FAULTS


@contextlib.contextmanager
def substituted(variant, driver):
    """The port with ``variant`` in its place, for a cell of ``driver``."""
    import ferreus_rbf_tpu_torch as frt

    patches = []
    if variant == "f32":
        patches = _fmm_f32()
    elif variant == "order5":
        patches = _order5()
    elif variant in FAULTS and driver == "fit":
        patches = [mock.patch.object(frt, "RBFInterpolator", _fit_fault(variant))]
    elif variant in FAULTS:
        patches = [mock.patch.object(frt.RBFInterpolator, "evaluate", _evaluate_fault(variant))]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


def seeds(text):
    """"1-12" or "5,9,11" -> a list of ints."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="program", choices=VARIANTS)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    readings = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, args.seconds, 0)
        with substituted(args.variant, cell.workload["driver"]):
            run = harness.measure(cell)
        numbers = cell.driver.check(cell)
        for k, v in numbers.items():
            readings.setdefault(k, []).append(v)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "steps": run.steps, "failed": cell.state.get("failed_steps"),
                          "step_s": run.step_s, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "variant": args.variant,
                      "card": harness.card_line(cell.device),
                      **{k: {"max": max(v), "min": min(v), "n": len(v)}
                         for k, v in readings.items()}}), flush=True)


if __name__ == "__main__":
    main()
