"""Readings behind the limits of a ``matvec`` cell (``drivers/matvec.py``):
the port's judged numbers over many seeds (the lower readings), its
control's, float32's and planted faults' (the upper).

    python3 benchmark/control_matvec.py --workload matvec100k --variant program --seeds 1-12
    python3 benchmark/control_matvec.py --workload matvec100k --variant order4 --seeds 101-103

``--variant`` puts a substitute in the standalone ``bbfmm.FmmTree``'s place,
for the whole process: ``program`` (the cell as it runs); ``order4``, the
control, which breaks the accuracy the configuration states (every tree
built at interpolation order one below the configuration's 5), which
``value_err`` has to see; ``f32``, the port's own float32 path (``evaluate``
through ``FmmTree.evaluate_device(..., "f32")``: every pass in float32) and
``reference_f32`` (the plain sum of ``reference/kernel_sum.py`` computed in
float32, the precision below the configuration's, in the port's place),
which ``linearity_err`` has to see; the faults ``unchanged`` (``set_weights`` does nothing once the tree holds
multipoles: ``evaluate`` sums an earlier block's), ``half`` (the odd rows
of every result replaced by the mean of the even ones) and ``altered``
(one weight of each block, the largest of its first column, doubled). Each
seed sets up the cell, measures a window of ``--seconds`` (one step at
least) and judges it; one JSON line per seed, then one with the largest and
smallest reading of each number. The benchmark's own runs never run this.
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

FAULTS = ("unchanged", "half", "altered")
VARIANTS = ("program", "f32", "reference_f32", "order4") + FAULTS


def _plain_sum_f32(kernel, sources, weights, targets, device):
    """``kernel_sum.kernel_sum`` in float32: a float64 host array (m, k)."""
    import torch

    from benchmark.reference import kernel_sum

    src = torch.as_tensor(np.asarray(sources, np.float32), device=device)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device).reshape(len(src), -1)
    tgt = torch.as_tensor(np.asarray(targets, np.float32), device=device)
    rows = max(1, kernel_sum.BLOCK_ELEMENTS // len(src))
    out = [kernel_sum.phi(kernel, torch.cdist(tgt[i:i + rows], src,
                                              compute_mode="donot_use_mm_for_euclid_dist")) @ w
           for i in range(0, len(tgt), rows)]
    return torch.cat(out).double().cpu().numpy()


def _patches(variant, kernel):
    from ferreus_rbf_tpu_torch import bbfmm

    tree_cls = bbfmm.FmmTree
    if variant == "order4":
        init = tree_cls.__init__

        def __init__(self, source_points, interpolation_order, kernel_params, *args,
                     params=None, **kw):
            order = interpolation_order - 1
            if params is not None:
                params = bbfmm.FmmParams(interpolation_order=order,
                                         max_points_per_cell=params.max_points_per_cell,
                                         compression_type=params.compression_type,
                                         epsilon=params.epsilon)
            init(self, source_points, order, kernel_params, *args, params=params, **kw)

        return [mock.patch.object(tree_cls, "__init__", __init__)]
    if variant == "f32":
        def evaluate(self, weights, target_points):
            tree, key = self._tree, "f32 control"
            tree._target_cache.pop(key, None)  # binned anew every call, as evaluate does
            tree._bin_targets(target_points, key)
            return tree.evaluate_device(tree._as_weights(weights), key, "f32").cpu().numpy()

        return [mock.patch.object(tree_cls, "evaluate", evaluate)]
    if variant == "reference_f32":
        def evaluate(self, weights, target_points):
            return _plain_sum_f32(kernel, self.source_points, weights, target_points,
                                  self._tree.device)

        return [mock.patch.object(tree_cls, "evaluate", evaluate)]
    if variant == "unchanged":
        set_weights = tree_cls.set_weights

        def unchanged(self, weights):
            if self._tree._multipole is None:
                set_weights(self, weights)

        return [mock.patch.object(tree_cls, "set_weights", unchanged)]
    if variant == "half":
        evaluate = tree_cls.evaluate

        def half(self, weights, target_points):
            v = np.array(evaluate(self, weights, target_points), copy=True)
            v[1::2] = v[0::2].mean(0)
            return v

        return [mock.patch.object(tree_cls, "evaluate", half)]
    if variant == "altered":
        set_weights = tree_cls.set_weights

        def altered(self, weights):
            w = np.array(weights, np.float64, copy=True).reshape(len(weights), -1)
            w[np.argmax(np.abs(w[:, 0])), 0] *= 2.0
            set_weights(self, w)

        return [mock.patch.object(tree_cls, "set_weights", altered)]
    return []


@contextlib.contextmanager
def substituted(variant, kernel=None):
    """The standalone FMM with ``variant`` in its place; ``reference_f32``
    sums ``kernel`` (``reference/kernel_sum.py``'s form)."""
    with contextlib.ExitStack() as stack:
        for p in _patches(variant, kernel):
            stack.enter_context(p)
        yield


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="program", choices=VARIANTS)
    ap.add_argument("--seeds", required=True, help='"1-12" or "5,9,11"')
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import control, harness, inputs

    readings = {}
    for seed in control.seeds(args.seeds):
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, args.seconds, 0)
        with substituted(args.variant, inputs.reference_kernel(cell)):
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
