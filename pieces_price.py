#!/usr/bin/env python3
"""What the world-size-free pieces of the sharded passes cost one card.

    python3 pieces_price.py

Every pass of ``FmmTree.evaluate_device`` (P2M, M2L, L2P) walks the same
pieces on one rank or many (``parallel.pieces``), so one card pays for the
blocks that several ranks would share. On one CUDA card this script builds
three trees: config 2 (``chip_smoke.py`` phase 3: 100,000 uniform points,
LinearRbf, p = 5, 8 RHS, uniform tree), the albatite fit's tree (phase 4's
points and kernel, default ``FmmParams``, 1 RHS) and config 4's 1M-point
tree (phase 7's points, LinearRbf, default ``FmmParams``, 1 RHS). For each
it times ``evaluate_device`` at f32 and f64, the mean of 20 calls back to
back between two CUDA events after a warm-up, under these block policies
(``parallel.BLOCKS`` and ``ops/fmm/api.py``'s ``_MIN_BLOCK_LEAVES`` and
``_MIN_BLOCK_ROWS``; the M2L always takes ``BLOCKS`` blocks, cut at its
own chunks' bounds):

* ``one``: every pass one block, the matvec with no pieces;
* ``m2l16``: the M2L in 16 blocks, the P2M and L2P whole;
* ``p2m16``, ``l2p16``: that pass in 16 blocks too, the other whole;
* ``sized<M>``: the M2L in 16 blocks, the P2M and L2P in blocks of at
  least M leaves and M rows, at most 16;
* ``package``: the package's own minimums.

It prints the card's name and power limit, then one JSON line per tree:
its pass sizes (leaves, M2L slots, L2P rows) and, per policy, the blocks
of the P2M and the L2P and the f32 and f64 milliseconds. The policies run in turns,
twice over in reverse order the second time, so that a drift of the card
shows as a difference between a policy's two readings.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def policies(api):
    whole = 1 << 40
    out = {"one": (1, (1, 1)), "m2l16": (16, (whole, whole)), "p2m16": (16, (1, whole)),
           "l2p16": (16, (whole, 1))}
    for m in (512, 1024, 2048, 4096):
        out[f"sized{m}"] = (16, (m, m))
    out["package"] = (16, (api._MIN_BLOCK_LEAVES, api._MIN_BLOCK_ROWS))
    return out


def set_policy(sharding, api, blocks, mins):
    sharding.BLOCKS = blocks
    api._MIN_BLOCK_LEAVES, api._MIN_BLOCK_ROWS = mins


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("pieces_price.py needs a CUDA card")
    import chip_smoke as smoke
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import api
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType
    from ferreus_rbf_tpu_torch.parallel import sharding
    from ferreus_rbf_tpu_torch.scripts.fit_at_scale import synthetic_sd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    nf.build()
    dev = torch.device("cuda", 0)
    plan = policies(api)
    saved = (sharding.BLOCKS, (api._MIN_BLOCK_LEAVES, api._MIN_BLOCK_ROWS))

    def config2():
        rng = np.random.default_rng(42)
        pts = rng.random((100_000, 3))
        params = frt.FmmParams(interpolation_order=5, max_points_per_cell=256,
                               compression_type=frt.FmmCompressionType.ACA, epsilon=1e-5)
        tree = FmmTree(pts, 5, KernelParams(KernelType.LinearRbf), adaptive_tree=False,
                       sparse=True, params=params, device=dev)
        return tree, torch.as_tensor(rng.standard_normal((pts.shape[0], 8)), device=dev)

    def fit_tree(pts, settings):
        params = frt.FmmParams.new_defaults(settings.kernel_type)
        tree = FmmTree(pts, params.interpolation_order, settings.kernel_params(),
                       adaptive_tree=True, sparse=True, params=params, device=dev)
        w = np.random.default_rng(5).standard_normal((pts.shape[0], 1))
        return tree, torch.as_tensor(w, device=dev)

    def albatite():
        pts, _, _, settings = smoke.albatite_data(frt)
        return fit_tree(pts, settings)

    def config4():
        pts, _ = synthetic_sd(1_000_000, seed=11)
        return fit_tree(pts, frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear))

    for name, make in (("config2", config2), ("albatite", albatite), ("config4_1M", config4)):
        tree, w = make()
        tree.prepare_targets(tree.source_points, "src")
        rows = tree._target_cache["src"]["tcnt"].shape[0]
        slots = sum(t.shape[1] for t, _, _ in tree._dev["m2l_levels"])
        sizes = {"leaves": tree.nsl, "m2l_slots": slots, "l2p_rows": rows}
        res = {}
        order = list(plan.items())
        for turn in (order, order[::-1]):
            for key, (blocks, mins) in turn:
                set_policy(sharding, api, blocks, mins)
                entry = res.setdefault(key, {"blocks": [
                    sharding.pass_blocks(sizes[k], m) for k, m in zip(("leaves", "l2p_rows"), mins)]})
                for prec in ("f32", "f64"):
                    ms = event_ms(lambda: tree.evaluate_device(w, "src", prec))
                    entry.setdefault(f"{prec}_ms", []).append(round(ms, 4))
        set_policy(sharding, api, *saved)
        print(json.dumps({"tree": name, "card": card, "sizes": sizes, "policies": res}),
              flush=True)
        del tree, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
