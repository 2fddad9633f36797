#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); build the CUDA near-field
   kernels from ``ferreus_rbf_tpu_torch/csrc`` with nvcc and print ptxas'
   registers and spills per kernel;
2. kernel vs plain PyTorch version for all ten kernel types, f32 (H1) and
   f64 (H2), and the f64 gradient kernel (H3), with and without per-row
   counts, with sentinel entries, a row of count 0 and (H3) targets that
   are exact copies of sources; then the cell-node kernels H4 (f32, f64,
   gradients) the same way, with sentinel cells and targets that coincide
   with cell nodes;
3. config-2 matvec: 100k uniform 3-D points, LinearRbf, p = 5, 8 RHS,
   uniform tree, at f32 and f64, against a dense f64 oracle on 1,024
   targets; median of 5 timed matvecs;
4. the fit path: the iterative fit of the albatite dataset (35,801 3-D
   signed-distance points, Spheroidal order 5, base_range = total_sill =
   span / 4, default Params), evaluation at the sources and on a 64^3
   grid, then ``evaluate_with_gradients`` on the same grid, checked
   against the values and against a dense f64 gradient on 1,024 grid
   points, with its peak device memory;
5. config-2 gradients (the JAX bench's gradient cell): 100k uniform points,
   Spheroidal5, p = 5, 2 RHS, adaptive sparse tree, ``evaluate_with_gradients``
   at the sources against value-only ``evaluate`` and a dense f64 oracle;
6. the isosurface path: ``build_isosurface`` of the phase-4 fit at span/100
   (the reference example's settings), checked for a non-empty mesh with
   finite vertices inside the padded extents and no edge on more than two
   facets;
7. config 4, the north-star fit: 1,000,000 signed-distance samples in a
   shell around a bumpy sphere (``bench.py``'s ``_synthetic_sd``, seed 11),
   LinearRbf, default Params, through ``RBFInterpolator``: fit seconds and
   stages, the solver's residual and refinement rounds, the DDM's
   per-level leaf sizes, ``evaluate_at_source`` against the values, a
   dense f64 oracle at 1,024 sources, peak device memory, and whether the
   P2M/L2P weight budget switched;
8. the M2P node-tile gate at 1M: phase 7's weights on one tree with the
   gate at its default and one with ``FERREUS_RBF_TPU_NODETILE_BYTES=0``
   (gated, M2P on H4): f32 and f64 matvecs and gradients at 4,096 sources
   compared between the two, H4 held against its plain version on the
   gated tree's whole M2P and timed against the ungated M2P leg (H1/H2/H3).

Phases 4-8 each zero the kernels' launch counters just before they drive
the port and read them just after. The line before the last is a JSON
object with one entry per kernel: its launches on its path (phase 4 for
H1/H2, phase 6 for H3, phase 8's gated tree for H4), its error and time
against the plain version (the albatite shapes for H1-H3, phase 8's gated
M2P for H4), and its bound; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "ferreus_rbf_tpu_torch/csrc/near_field.cu"
REPLACES = {
    # the Pallas kernel each one replaces on the main path (all of them are
    # listed in PERF.md)
    "near_field_f32": "ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:595",
    "near_field_f64": "ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:698",
    "near_field_grad_f64": "ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:779",
    "near_field_cells_f32": "ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:834",
    # the gated f64 and gradient M2P run on the JAX package's virtual-node
    # XLA scan (_near_field_class), which p2p_rows serves in f32 only
    "near_field_cells_f64": "ferreus_rbf_tpu/ops/fmm/api.py:613",
    "near_field_cells_grad_f64": "ferreus_rbf_tpu/ops/fmm/api.py:613",
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# p = 5 Chebyshev truncation: ~5e-5 relative on the JAX package's error
# budget; the check allows 10x that.
CONFIG2_BOUND = 5e-4
# gradients at p = 5 against a dense oracle: the JAX package's bound
# (tests/test_fmm.py, test_matvec_gradients_match_dense)
CONFIG2_GRAD_BOUND = 1e-2
# albatite (p = 7) gradients against a dense f64 gradient
ALBATITE_GRAD_BOUND = 1e-3
# config 4 (p = 7): evaluate_at_source and the dense oracle, relative to
# max |values| (bench.py's config-4 check)
CONFIG4_BOUND = 1e-4
# gradients of two full FMM pipelines at 1M (p = 7): the card's index_add_
# in M2M and L2L adds in no fixed order; one tree evaluated twice differed
# by 9.1e-13 of max |grad| (PERF.md), and this allows 3x that
GRAD_NOISE = 3e-12

# H100 SXM published peaks (NVIDIA data sheet): non-tensor FLOP/s by type
# and HBM3 bytes/s. A kernel's bound is the larger of its flops over the
# peak and its bytes (each operand read once, each output written once)
# over the memory rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_S = 3.35e12
# Flops per (target, source) pair of phi and of the gradient factor g,
# counting a sqrt, log or divide as ONE flop (they are multi-instruction
# sequences on the card, so the bound is a lower bound) and an FMA as two;
# spheroidal counts its cheaper (near) branch.
PHI_FLOPS = {"LinearRbf": 1, "ThinPlateSplineRbf": 3, "CubicRbf": 2, "Spheroidal3Rbf": 3,
             "Spheroidal5Rbf": 3, "Spheroidal7Rbf": 3, "Spheroidal9Rbf": 3,
             "Laplacian": 2, "OneOverR2": 1, "OneOverR4": 2}
G_FLOPS = {"LinearRbf": 1, "ThinPlateSplineRbf": 2, "CubicRbf": 1, "Spheroidal3Rbf": 1,
           "Spheroidal5Rbf": 1, "Spheroidal7Rbf": 1, "Spheroidal9Rbf": 1,
           "Laplacian": 2, "OneOverR2": 2, "OneOverR4": 3}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10):
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
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


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def kernel_vs_plain(nf, kparams, tgt, src, w, nbr, cnt, grad=False):
    """(relative error, max |diff|) of the kernel against its plain
    version; for H3 the worse of values and gradients."""
    if grad:
        got = nf.near_field_grad(tgt, src, w, nbr, cnt, kparams=kparams)
        want = nf.near_field_grad_plain(tgt, src, w, nbr, cnt, kparams=kparams)
    else:
        got = (nf.near_field(tgt, src, w, nbr, cnt, kparams=kparams),)
        want = (nf.near_field_plain(tgt, src, w, nbr, cnt, kparams=kparams),)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in want):
        raise AssertionError("plain near field is not finite")
    return (max(rel_err(a, b) for a, b in zip(got, want)),
            max(float((a - b).abs().max()) for a, b in zip(got, want)))


def near_field_bound(kparams, ops, tlive, slive, grad, nrhs=None):
    """(bound ms, "operations" or "bytes", flops) of one near-field call:
    the live (target, source) pairs these operands need (real targets of a
    row times the real sources of each tile or cell it lists before its
    count, sentinels excluded) times the flops per pair, against the bytes
    of the operands and outputs. ``ops`` is (tgt, nbr, cnt, *other inputs);
    ``nrhs`` defaults to the weight tiles' (ops[4].shape[1])."""
    tgt, nbr, cnt = ops[:3]
    u = nbr.shape[0]
    idx = nbr.T.long()
    live = torch.ones_like(idx, dtype=torch.bool)
    if cnt is not None:
        live &= torch.arange(u, device=idx.device)[None, :] < cnt[:, None]
    per_row = (slive[idx] * live).sum(1)
    pairs = float((per_row.double() * tlive.double()).sum())
    name = kparams.kernel_type.value
    nrhs = ops[4].shape[1] if nrhs is None else nrhs
    d = tgt.shape[2]
    per_pair = 8 + PHI_FLOPS[name] + 2 * nrhs  # 3 sub + 1 mul + 2 FMA = 8
    if grad:
        per_pair += G_FLOPS[name] + 3 + 2 * d * nrhs  # g * diff, d more FMAs per rhs
    flops = pairs * per_pair
    out_elems = tgt.shape[0] * tgt.shape[1] * nrhs * (1 + (d if grad else 0))
    nbytes = sum(x.numel() * x.element_size() for x in ops if x is not None)
    nbytes += out_elems * tgt.element_size()
    t_ops = flops / PEAK_FLOPS[tgt.dtype]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_kernels(nf, kt_mod, dev):
    """H1/H2: all kernel types x {f32, f64} x {counts, none} x nrhs {1, 8};
    H3: all kernel types x {counts, none} x nrhs {1, 2, 8}, f64, with
    targets that are exact copies of sources."""
    g = torch.Generator(device="cpu").manual_seed(0)
    rows, t, s, u, ntiles = 300, 128, 256, 27, 400
    tgt = torch.rand((rows, t, 3), generator=g, dtype=torch.float64) - 0.5
    src = torch.rand((ntiles + 1, 3, s), generator=g, dtype=torch.float64) - 0.5
    src[:, :, 200:] = 0.0  # padded slots at the centre
    nbr = torch.randint(0, ntiles, (u, rows), generator=g, dtype=torch.int32)
    nbr[20:, ::3] = ntiles  # sentinel entries
    cnt = torch.randint(0, u + 1, (rows,), generator=g, dtype=torch.int32)
    cnt[0] = 0
    worst = {}
    for nrhs in (1, 8):
        w = torch.randn((ntiles + 1, nrhs, s), generator=g, dtype=torch.float64)
        w[:, :, 200:] = 0.0
        w[ntiles] = 0.0  # the sentinel tile
        for kt in kt_mod.KernelType:
            kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in kt.value else {}
            kp = kt_mod.KernelParams(kt, **kw)
            for dtype in (torch.float32, torch.float64):
                ops = [x.to(dev, dtype) for x in (tgt, src, w)] + [nbr.to(dev)]
                for c in (None, cnt.to(dev)):
                    err, _ = kernel_vs_plain(nf, kp, *ops, c)
                    key = (kt.value, str(dtype).split(".")[-1], nrhs, c is not None)
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"kernel vs plain {key}: {err:.3e} > {TOL[dtype]}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    if c is not None:
                        out = nf.near_field(*ops, c, kparams=kp)
                        if float(out[0].abs().max()) != 0.0:
                            raise AssertionError("a row with count 0 must be zero")
    for dtype, err in worst.items():
        log(f"phase 2: 10 kernel types x counts x nrhs {{1,8}}, {dtype}: "
            f"worst relative error {err:.3e} (bound {TOL[dtype]:.0e})")

    # H3: values and gradients, f64; some targets are exact copies of sources
    tgt64 = tgt.clone()
    for r in range(1, rows, 7):
        tile = int(nbr[0, r])
        tgt64[r, :20] = src[tile, :, :20].T
    worst = 0.0
    for nrhs in (1, 2, 8):
        w = torch.randn((ntiles + 1, nrhs, s), generator=g, dtype=torch.float64)
        w[:, :, 200:] = 0.0
        w[ntiles] = 0.0
        ops = [x.to(dev) for x in (tgt64, src, w, nbr)]
        for kt in kt_mod.KernelType:
            kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in kt.value else {}
            kp = kt_mod.KernelParams(kt, **kw)
            for c in (None, cnt.to(dev)):
                err, _ = kernel_vs_plain(nf, kp, *ops, c, grad=True)
                if not err <= TOL[torch.float64]:
                    key = (kt.value, nrhs, c is not None)
                    raise AssertionError(f"H3 vs plain {key}: {err:.3e}")
                worst = max(worst, err)
                if c is not None:
                    v, gr = nf.near_field_grad(*ops, c, kparams=kp)
                    if float(v[0].abs().max()) != 0.0 or float(gr[0].abs().max()) != 0.0:
                        raise AssertionError("H3: a row with count 0 must be zero")
    log(f"phase 2: H3 near_field_grad_f64, 10 kernel types x counts x nrhs {{1,2,8}}, "
        f"coincident targets: worst relative error {worst:.3e} (values and gradients; "
        f"bound 1e-12)")


def cells_vs_plain(nf, kparams, ops, grad=False):
    """(relative error, max |diff|) of H4 against its plain version on the
    operands (tgt, cells, cnt, centers, lengths, nodes, mult); for the
    gradient form the worse of values and gradients."""
    if grad:
        got = nf.near_field_cells_grad(*ops, kparams=kparams)
        want = nf.near_field_cells_grad_plain(*ops, kparams=kparams)
    else:
        got = (nf.near_field_cells(*ops, kparams=kparams),)
        want = (nf.near_field_cells_plain(*ops, kparams=kparams),)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in want + got):
        raise AssertionError("H4 or its plain version is not finite")
    return (max(rel_err(a, b) for a, b in zip(got, want)),
            max(float((a - b).abs().max()) for a, b in zip(got, want)))


def phase_kernels_cells(nf, kt_mod, dev):
    """H4: all kernel types x {f32, f64, gradients} x {counts, none} x nrhs
    {1, 2, 8} on p = 7 cells (343 nodes: three staging blocks, the last
    partial), with sentinel cells, a row of count 0 and targets that
    coincide with nodes of a listed cell."""
    from ferreus_rbf_tpu_torch.ops.fmm import cheb

    g = torch.Generator(device="cpu").manual_seed(5)
    f64 = torch.float64
    p, ncells, rows, t, u = 7, 300, 160, 128, 16
    nodes = torch.as_tensor(cheb.nodes_tensor_product(cheb.chebyshev_nodes(p), 3))
    centers = torch.rand((ncells, 3), generator=g, dtype=f64) - 0.5
    lengths = 0.05 + 0.15 * torch.rand((ncells,), generator=g, dtype=f64)
    cells = torch.randint(0, ncells, (u, rows), generator=g, dtype=torch.int32)
    cells[12:, ::3] = ncells  # sentinel cells
    cnt = torch.randint(0, u + 1, (rows,), generator=g, dtype=torch.int32)
    cnt[0] = 0
    tgt = torch.rand((rows, t, 3), generator=g, dtype=f64) - 0.5
    for r in range(1, rows, 7):  # exact copies of a listed cell's nodes
        c = int(cells[0, r])
        tgt[r, :20] = centers[c] + (lengths[c] * 0.5) * nodes[:20]
    geo = [x.to(dev) for x in (centers, lengths, nodes)]
    worst = {}
    for nrhs in (1, 2, 8):
        mult = torch.randn((ncells, nodes.shape[0], nrhs), generator=g, dtype=f64)
        for kt in kt_mod.KernelType:
            kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in kt.value else {}
            kp = kt_mod.KernelParams(kt, **kw)
            for dtype, grad in ((torch.float32, False), (f64, False), (f64, True)):
                for c in (None, cnt.to(dev)):
                    ops = (tgt.to(dev, dtype), cells.to(dev), c, *geo, mult.to(dev, dtype))
                    err, _ = cells_vs_plain(nf, kp, ops, grad)
                    key = ("grad" if grad else str(dtype).split(".")[-1])
                    if not err <= TOL[dtype]:
                        raise AssertionError(
                            f"H4 vs plain {(kt.value, key, nrhs, c is not None)}: {err:.3e}")
                    worst[key] = max(worst.get(key, 0.0), err)
                    if c is not None:
                        fn = nf.near_field_cells_grad if grad else nf.near_field_cells
                        outs = fn(*ops, kparams=kp)
                        for out in (outs if grad else (outs,)):
                            if float(out[0].abs().max()) != 0.0:
                                raise AssertionError("H4: a row with count 0 must be zero")
    for key, err in worst.items():
        log(f"phase 2: H4 near_field_cells {key}, 10 kernel types x counts x nrhs {{1,2,8}}, "
            f"p = 7 cells, coincident targets: worst relative error {err:.3e} "
            f"(bound {TOL[torch.float32 if key == 'float32' else f64]:.0e})")


def time_near_field(nf, tree, binned, dtype, kparams, nrhs, g, grad=False):
    """Kernel and plain-version times (ms), errors and bounds on a tree's
    own P2P and M2P operands (H3 when ``grad``)."""
    fs = tree._floats(dtype)
    bs = tree._binned_floats(binned, dtype)
    rows, t, _ = bs["tpts"].shape
    tlive = torch.bincount(binned["inv_flat"] // t, minlength=rows)
    slive = {"p2p": tree._dev["src_mask"].sum(1)}
    w = torch.randn((tree.nsl + 1, nrhs, tree.smax), generator=g, dtype=torch.float64)
    w[-1] = 0.0
    w = w.to(tree.device, dtype)
    p2p = (bs["tpts"], fs["src_tiles"], w, binned["nbr"], None)
    out = {"p2p": p2p}
    if binned["wtab"] is not None:
        mt = torch.randn((tree._m2p_nw + 1, nrhs, tree.nnodes), generator=g,
                         dtype=torch.float64)
        mt[-1] = 0.0
        out["m2p"] = (bs["tpts"], fs["node_tiles"], mt.to(tree.device, dtype),
                      binned["wtab"], binned["wcnt"])
        slive["m2p"] = torch.full((tree._m2p_nw + 1,), tree.nnodes, device=tree.device)
        slive["m2p"][-1] = 0
    kernel = nf.near_field_grad if grad else nf.near_field
    plain = nf.near_field_grad_plain if grad else nf.near_field_plain
    res = {}
    for name, ops in out.items():
        tgt, src, _, nbr, cnt = ops
        live = nbr.T.long() != src.shape[0] - 1
        if cnt is not None:
            live &= torch.arange(nbr.shape[0], device=nbr.device)[None, :] < cnt[:, None]
        # (target slot, source slot) pairs the kernel evaluates, pads included
        pairs = int(live.sum()) * tgt.shape[1] * src.shape[2]
        rel, absd = kernel_vs_plain(nf, kparams, *ops, grad=grad)
        if not rel <= TOL[dtype]:
            raise AssertionError(f"{name} kernel vs plain: {rel:.3e} > {TOL[dtype]}")
        ms = cuda_ms(lambda: kernel(*ops, kparams=kparams))
        plain_ms = cuda_ms(lambda: plain(*ops, kparams=kparams), reps=3)
        bound_ms, bound_by, flops = near_field_bound(
            kparams, (tgt, nbr, cnt, src, ops[2]), tlive, slive[name], grad)
        res[name] = {"rel": rel, "abs": absd, "ms": ms, "plain_ms": plain_ms,
                     "gpairs_s": pairs / (ms * 1e-3) / 1e9, "bound_ms": bound_ms,
                     "bound_by": bound_by, "tflops": flops / (ms * 1e-3) / 1e12,
                     "shape": [tuple(x.shape) for x in ops[:4]]}
    return res


def log_near_field(prefix, name, r):
    for part, m in r.items():
        log(f"{prefix} {part} {name} shapes {m['shape']}: kernel {m['ms']:.4f} ms "
            f"({m['gpairs_s']:.1f} Gpair/s, {m['tflops']:.2f} TFLOP/s), bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}), plain {m['plain_ms']:.4f} ms, "
            f"rel err {m['rel']:.3e}")


def synced_median(fn, reps=5):
    """Median host seconds of ``fn`` over ``reps`` calls, each ending in
    ``torch.cuda.synchronize()``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def phase_config2(frt, nf, dev):
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType, make_kernel

    n, nrhs, p = 100_000, 8, 5
    rng = np.random.default_rng(42)
    pts = rng.random((n, 3))
    weights = rng.standard_normal((n, nrhs))
    kp = KernelParams(KernelType.LinearRbf)
    params = frt.FmmParams(interpolation_order=p, max_points_per_cell=256,
                           compression_type=frt.FmmCompressionType.ACA, epsilon=10.0**-p)
    t0 = time.perf_counter()
    tree = FmmTree(pts, p, kp, adaptive_tree=False, sparse=True, params=params, device=dev)
    tree.prepare_targets(pts, "src")
    torch.cuda.synchronize()
    log(f"phase 3: config-2 plan {time.perf_counter() - t0:.2f} s "
        f"(leaves {tree.nsl}, smax {tree.smax}, depth {tree.tree.depth})")
    w = torch.as_tensor(weights, device=dev)
    idx = torch.as_tensor(np.sort(rng.choice(n, 1024, replace=False)), device=dev)
    pts_d = torch.as_tensor(pts, device=dev)
    oracle = dense_matvec(make_kernel(kp), pts_d[idx], pts_d, w)
    vals = {}
    for prec in ("f32", "f64"):
        v = tree.evaluate_device(w, "src", precision=prec)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            v = tree.evaluate_device(w, "src", precision=prec)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[2]
        err = rel_err(v[idx], oracle)
        vals[prec] = v
        log(f"phase 3: config-2 matvec {prec}: median {med * 1e3:.3f} ms, "
            f"{n / med:.6g} pts/s, error vs dense f64 oracle {err:.3e} "
            f"(bound {CONFIG2_BOUND:.0e})")
        if not (torch.isfinite(v).all() and err < CONFIG2_BOUND):
            raise AssertionError(f"config-2 {prec} matvec error {err:.3e}")
    tier = rel_err(vals["f32"], vals["f64"])
    log(f"phase 3: config-2 f32 vs f64 matvec {tier:.3e} (bound 1e-5)")
    if not tier < 1e-5:
        raise AssertionError(f"config-2 f32 tier error {tier:.3e}")
    g = torch.Generator(device="cpu").manual_seed(1)
    for name, dtype in (("near_field_f32", torch.float32), ("near_field_f64", torch.float64)):
        r = time_near_field(nf, tree, tree._target_cache["src"], dtype, kp, nrhs, g)
        log_near_field(f"phase 3: config-2 nrhs {nrhs}", name, r)


def dense_gradients(rbfi, targets, dev, chunk=256):
    """Dense f64 gradient of the fitted interpolant at ``targets`` on the
    card: ``pair_with_grad`` against every source, plus the drift's
    gradient. Returns a host array (n, nrhs * d)."""
    from ferreus_rbf_tpu_torch.ops import polynomials
    from ferreus_rbf_tpu_torch.ops.kernels import make_kernel

    kernel = make_kernel(rbfi.interpolant_settings.kernel_params())
    src = torch.as_tensor(rbfi.points, device=dev)
    coef = torch.as_tensor(rbfi.coefficients.point_coefficients, device=dev)
    tg = torch.as_tensor(targets, device=dev)
    out = []
    for c0 in range(0, tg.shape[0], chunk):
        _, gmat = kernel.pair_with_grad(tg[c0 : c0 + chunk], src)
        out.append(torch.einsum("mnd,nr->mrd", gmat, coef).flatten(1))
    grads = torch.cat(out).cpu().numpy()
    settings = rbfi.interpolant_settings
    if settings.basis_size != 0:
        grads = grads + polynomials.evaluate_monomial_gradients(
            targets, rbfi.coefficients.poly_coefficients, settings.polynomial_degree,
            rbfi.translation_factor, rbfi.scale_factor)
    return grads


def kernel_entry(name, launches, m):
    return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": m["abs"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None}


def phase_albatite(frt, nf, timing, dev):
    """The fit path. Returns the fit, the dataset's extents and span, and
    the H1/H2/H3 kernel-line entries (launches of H3 are filled in by the
    isosurface phase)."""
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

    pts, vals = frt.csv_to_point_arrays(
        os.path.join(HERE, "datasets", "albatite_SD_points.csv"), has_headers=True)
    vals = vals.reshape(-1)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0, total_sill=span / 4.0,
    )
    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize()
    nf.reset_launches()
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator(pts, vals, settings, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    fit_launches = dict(nf.LAUNCHES)
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    eval_s = time.perf_counter() - t0
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    grid = frt.create_evaluation_grid(list(zip(lo, hi)), [64, 64, 64])
    t0 = time.perf_counter()
    grid_vals = rbfi.evaluate(grid)
    grid_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(nf.LAUNCHES)
    grad_tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    gv, gg = rbfi.evaluate_with_gradients(grid)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = dict(nf.LAUNCHES)
    grad_launches = {k: launches[k] - before[k] for k in launches}

    done = [e for e in tracer.events if e["event"] == "solve_done"]
    solver_res = done[-1]["residual"]
    rel = float(np.max(np.abs(pred - vals))) / float(np.max(np.abs(vals)))
    stages = {k: round(v, 3) for k, v in tracer.totals.items()}
    log(f"phase 4: albatite fit {fit_s:.3f} s, n {rbfi.points.shape[0]}, "
        f"solver l2 residual {solver_res:.3e} (bound 1e-6), "
        f"refinement rounds {sum(e['event'] == 'refine_round' for e in tracer.events)}")
    log(f"phase 4: fit stages (s) {json.dumps(stages)}")
    log(f"phase 4: evaluate_at_source {eval_s:.3f} s, max residual / max|vals| {rel:.3e} "
        f"(bound 1e-4); 64^3 grid evaluate {grid_s:.3f} s")
    if not solver_res <= 1e-6:
        raise AssertionError(f"solver residual {solver_res:.3e}")
    if not rel < 1e-4:
        raise AssertionError(f"source residual {rel:.3e}")
    if grid_vals.shape != (64**3,) or not np.isfinite(grid_vals).all():
        raise AssertionError("grid values not finite or of the wrong shape")

    sub = np.sort(np.random.default_rng(4).choice(grid.shape[0], 1024, replace=False))
    dense = dense_gradients(rbfi, grid[sub], dev)
    val_err = rel_err(torch.as_tensor(gv), torch.as_tensor(grid_vals))
    grad_err = float(np.max(np.abs(gg[sub] - dense))) / float(np.max(np.abs(dense)))
    log(f"phase 4: 64^3 grid evaluate_with_gradients {grad_s:.3f} s "
        f"({grid.shape[0] / grad_s:.6g} pts/s, {grad_s / grid_s:.3f}x value-only), "
        f"peak device memory {peak_gb:.3f} GB; values vs evaluate {val_err:.3e} "
        f"(bound 1e-12); gradients vs dense f64 on 1,024 grid points {grad_err:.3e} "
        f"of max |grad| (bound {ALBATITE_GRAD_BOUND:.0e})")
    log(f"phase 4: 64^3 evaluate_with_gradients stages (s) "
        f"{json.dumps({k: round(v, 3) for k, v in grad_tracer.totals.items()})}")
    log(f"phase 4: launches: fit {json.dumps(fit_launches)}; 64^3 evaluate_with_gradients "
        f"{json.dumps(grad_launches)}; whole phase {json.dumps(launches)}")
    if gg.shape != (64**3, 3) or not np.isfinite(gg).all():
        raise AssertionError("grid gradients not finite or of the wrong shape")
    if not (val_err <= 1e-12 and grad_err <= ALBATITE_GRAD_BOUND):
        raise AssertionError(f"albatite gradients: values {val_err:.3e}, grads {grad_err:.3e}")
    if not all(launches[name] > 0 for name in REPLACES if not name.startswith("near_field_cells")):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # kernel vs plain at the fit's own shapes (nrhs 1): its "__all__" tree;
    # the sources are also the seed projection's first gradient targets
    params = rbfi.params
    tree = FmmTree(rbfi.points, params.fmm_params.interpolation_order,
                   settings.kernel_params(), adaptive_tree=True, sparse=True,
                   params=params.fmm_params, device=dev)
    tree.prepare_targets(rbfi.points, "__all__")
    g = torch.Generator(device="cpu").manual_seed(2)
    entries = {}
    for name, dtype, grad in (("near_field_f32", torch.float32, False),
                              ("near_field_f64", torch.float64, False),
                              ("near_field_grad_f64", torch.float64, True)):
        r = time_near_field(nf, tree, tree._target_cache["__all__"], dtype,
                            settings.kernel_params(), 1, g, grad=grad)
        log_near_field("phase 4: albatite", name, r)
        entries[name] = kernel_entry(name, launches[name], r["p2p"])
    return rbfi, pts, span, entries


def phase_config2_gradients(nf, dev):
    """The JAX bench's gradient cell: 100k uniform points, Spheroidal5,
    p = 5, 2 RHS, adaptive sparse tree, gradients at the sources."""
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType, make_kernel

    n, p = 100_000, 5
    rng = np.random.default_rng(7)
    pts = rng.random((n, 3))
    w = rng.standard_normal((n, 2))
    kp = KernelParams(KernelType.Spheroidal5Rbf, base_range=1.2, total_sill=0.9)
    nf.reset_launches()
    t0 = time.perf_counter()
    tree = FmmTree(pts, p, kp, adaptive_tree=True, sparse=True, device=dev)
    tree.set_weights(w)
    torch.cuda.synchronize()
    log(f"phase 5: config-2 gradient tree {time.perf_counter() - t0:.2f} s "
        f"(leaves {tree.nsl}, smax {tree.smax}, depth {tree.tree.depth}, "
        f"w-list tiles {tree._m2p_nw})")
    vg = tree.evaluate_with_gradients(w, pts, reuse_key="src")  # warm
    grad_s = synced_median(lambda: tree.evaluate_with_gradients(w, pts, reuse_key="src"))
    tree.evaluate(w, pts, reuse_key="src")  # warm
    val_s = synced_median(lambda: tree.evaluate(w, pts, reuse_key="src"))
    launches = dict(nf.LAUNCHES)

    idx = np.sort(rng.choice(n, 1024, replace=False))
    kernel = make_kernel(kp)
    src = torch.as_tensor(pts, device=dev)
    wd = torch.as_tensor(w, device=dev)
    want_v = dense_matvec(kernel, src[idx], src, wd).cpu().numpy()
    want_g = torch.cat([
        torch.einsum("mnd,nr->mrd", kernel.pair_with_grad(src[idx[c : c + 256]], src)[1],
                     wd).flatten(1)
        for c in range(0, 1024, 256)]).cpu().numpy()
    v_err = float(np.max(np.abs(vg[0][idx] - want_v)) / np.max(np.abs(want_v)))
    g_err = float(np.max(np.abs(vg[1][idx] - want_g)) / np.max(np.abs(want_g)))
    log(f"phase 5: config-2 evaluate_with_gradients median {grad_s * 1e3:.3f} ms "
        f"({n / grad_s:.6g} pts/s); value-only evaluate {val_s * 1e3:.3f} ms "
        f"({n / val_s:.6g} pts/s); ratio {grad_s / val_s:.3f}")
    log(f"phase 5: vs dense f64 oracle on 1,024 targets: values {v_err:.3e} "
        f"(bound {CONFIG2_BOUND:.0e}), gradients {g_err:.3e} (bound {CONFIG2_GRAD_BOUND:.0e})")
    log(f"phase 5: launches {json.dumps(launches)}")
    if vg[1].shape != (n, 6) or not np.isfinite(vg[1]).all():
        raise AssertionError("config-2 gradients not finite or of the wrong shape")
    if not (v_err < CONFIG2_BOUND and g_err < CONFIG2_GRAD_BOUND):
        raise AssertionError(f"config-2 gradients: values {v_err:.3e}, grads {g_err:.3e}")
    if not launches["near_field_grad_f64"] > 0:
        raise AssertionError(f"H3 never launched in phase 5: {launches}")
    g = torch.Generator(device="cpu").manual_seed(3)
    r = time_near_field(nf, tree, tree._target_cache["src"], torch.float64, kp, 2, g,
                        grad=True)
    log_near_field("phase 5: config-2 nrhs 2", "near_field_grad_f64", r)


def phase_isosurface(frt, nf, timing, rbfi, pts, span):
    """The isosurface path: RMT on the albatite fit at span/100."""
    extents = np.concatenate([pts.min(axis=0), pts.max(axis=0)])
    resolution = span / 100.0
    calls = {"lattice_calls": 0, "lattice_points": 0, "lattice_s": 0.0,
             "gradient_calls": 0, "gradient_points": 0, "gradient_s": 0.0}

    def counted(fn, key):
        def wrapper(targets):
            calls[f"{key}_calls"] += 1
            calls[f"{key}_points"] += len(targets)
            t0 = time.perf_counter()
            out = fn(targets)  # host arrays: the device work has finished
            calls[f"{key}_s"] += time.perf_counter() - t0
            return out
        return wrapper

    build = rbfi.build_evaluator

    def timed_build(*args):
        t0 = time.perf_counter()
        build(*args)
        torch.cuda.synchronize()
        calls["build_evaluator_s"] = time.perf_counter() - t0

    rbfi.build_evaluator = timed_build

    rbfi.evaluate_targets = counted(rbfi.evaluate_targets, "lattice")
    rbfi.evaluate_targets_with_gradients = counted(
        rbfi.evaluate_targets_with_gradients, "gradient")
    torch.cuda.synchronize()
    nf.reset_launches()
    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    mesh = rbfi.build_isosurface(extents, resolution, 0.0, frt.BoundaryClosure.None_)
    torch.cuda.synchronize()
    iso_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    launches = dict(nf.LAUNCHES)
    del rbfi.evaluate_targets, rbfi.evaluate_targets_with_gradients, rbfi.build_evaluator
    calls = {k: round(v, 3) if isinstance(v, float) else v for k, v in calls.items()}

    verts, facets = mesh.vertices, mesh.facets
    pad = resolution * 10.0
    inside = bool(np.all(verts >= extents[:3] - pad) and np.all(verts <= extents[3:] + pad))
    edges = np.sort(facets[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, uses = np.unique(edges, axis=0, return_counts=True)
    log(f"phase 6: albatite isosurface at span/100 ({resolution:.6g}) {iso_s:.3f} s: "
        f"{mesh.num_vertices} vertices, {mesh.num_facets} facets; {json.dumps(calls)}; "
        f"max facets per edge {int(uses.max()) if uses.size else 0}, "
        f"boundary edges {int((uses == 1).sum())}")
    log(f"phase 6: stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    log(f"phase 6: launches {json.dumps(launches)}")
    if mesh.num_facets == 0 or not np.isfinite(verts).all() or not inside:
        raise AssertionError("isosurface empty, not finite, or outside the padded extents")
    if uses.max() > 2:
        raise AssertionError("an edge is used by more than two facets")
    if not (launches["near_field_f64"] > 0 and launches["near_field_grad_f64"] > 0):
        raise AssertionError(f"H2 or H3 never launched in phase 6: {launches}")
    return launches


def synthetic_sd(n, seed=11):
    """Config 4's data, a copy of ``bench.py``'s ``_synthetic_sd``:
    signed-distance samples in a volumetric shell around a bumpy unit
    sphere (zero level = the bumpy sphere), radii continuous in [0.7, 1.3]."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = 0.7 + 0.6 * rng.random(n)
    pts = dirs * (bump * radii)[:, None]
    sd = (radii - 1.0) * bump
    return pts, sd


def dense_oracle(rbfi, idx, dev):
    """The fitted interpolant at sources ``idx`` in dense f64 on the card
    (kernel sum + nugget + drift; ``bench.py``'s oracle): a host array."""
    from ferreus_rbf_tpu_torch.ops import polynomials
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.kernels import make_kernel

    settings = rbfi.interpolant_settings
    src = torch.as_tensor(rbfi.points, device=dev)
    coef = rbfi.coefficients.point_coefficients
    out = dense_matvec(make_kernel(settings.kernel_params()), src[idx], src,
                       torch.as_tensor(coef, device=dev), chunk=64).cpu().numpy()
    out = out + settings.nugget * coef[idx]
    pc = rbfi.coefficients.poly_coefficients
    if pc is not None and pc.size:
        out = out + polynomials.evaluate_monomials(
            rbfi.points[idx], settings.polynomial_degree, pc.shape[0],
            rbfi.translation_factor, rbfi.scale_factor) @ pc
    return out.reshape(-1)


def phase_config4(frt, nf, timing, dev, n=1_000_000):
    """Config 4: the 1M-point LinearRbf signed-distance fit, default Params."""
    pts, sd = synthetic_sd(n, seed=11)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = timing.enable_global_tracer()
    nf.reset_launches()
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator(pts, sd, settings, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    launches = dict(nf.LAUNCHES)
    fit_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    events = tracer.events
    done = [e for e in events if e["event"] == "solve_done"]
    solver_res = done[-1]["residual"]
    rounds = sum(e["event"] == "refine_round" for e in events)
    strip = lambda e: {k: v for k, v in e.items() if k != "event"}  # noqa: E731
    log(f"phase 7: config-4 fit {fit_s:.3f} s, n {rbfi.points.shape[0]} of {n}, solver l2 "
        f"residual {solver_res:.3e} (bound 1e-6), refinement rounds {rounds}, converged "
        f"{done[-1]['converged']}, escalated {done[-1].get('escalated')}")
    log(f"phase 7: refinement {json.dumps([strip(e) for e in events if e['event'] == 'refine_round'])}")
    log(f"phase 7: fit stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    log(f"phase 7: DDM levels {json.dumps([strip(e) for e in events if e['event'] == 'ddm_level'])}")
    log(f"phase 7: FMM trees {json.dumps([strip(e) for e in events if e['event'] == 'fmm_tree'])}")
    log(f"phase 7: target sets {json.dumps([strip(e) for e in events if e['event'] == 'fmm_targets'])}")
    log(f"phase 7: fit launches {json.dumps(launches)}; fit peak device memory {fit_peak_gb:.3f} GB")

    vals = rbfi.point_values[:, 0]
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    eval_s = time.perf_counter() - t0
    scale = float(np.max(np.abs(vals)))
    rel = float(np.max(np.abs(pred - vals))) / scale
    idx = np.sort(np.random.default_rng(3).choice(vals.size, 1024, replace=False))
    t0 = time.perf_counter()
    oracle = dense_oracle(rbfi, idx, dev)
    oracle_s = time.perf_counter() - t0
    value_err = float(np.max(np.abs(pred[idx] - oracle))) / float(np.max(np.abs(oracle)))
    true_res = float(np.max(np.abs(oracle - vals[idx]))) / scale
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"phase 7: evaluate_at_source {eval_s:.3f} s, max residual / max|vals| {rel:.3e} "
        f"(bound {CONFIG4_BOUND:.0e}); dense f64 oracle on 1,024 sources ({oracle_s:.3f} s): "
        f"evaluation vs oracle {value_err:.3e}, oracle residual {true_res:.3e} "
        f"(bound {CONFIG4_BOUND:.0e}); peak device memory {peak_gb:.3f} GB")
    if not solver_res <= 1e-6:
        raise AssertionError(f"config-4 solver residual {solver_res:.3e}")
    if not (pred.shape == vals.shape and np.isfinite(pred).all() and rel < CONFIG4_BOUND):
        raise AssertionError(f"config-4 source residual {rel:.3e}")
    if not (value_err < CONFIG4_BOUND and true_res < CONFIG4_BOUND):
        raise AssertionError(f"config-4 oracle: evaluation {value_err:.3e}, residual {true_res:.3e}")
    if not (launches["near_field_f32"] > 0 and launches["near_field_f64"] > 0):
        raise AssertionError(f"H1 or H2 never launched in the 1M fit: {launches}")
    return rbfi


GATE_ENV = "FERREUS_RBF_TPU_NODETILE_BYTES"


def phase_gate(nf, dev, rbfi):
    """The node-tile gate at 1M: a default tree and a forced-gated one over
    phase 7's points and weights. Returns H4's kernel-line entries."""
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

    pts = rbfi.points
    n = pts.shape[0]
    w = rbfi.coefficients.point_coefficients
    fp = rbfi.params.fmm_params
    kp = rbfi.interpolant_settings.kernel_params()

    def build():
        t0 = time.perf_counter()
        tree = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True,
                       params=fp, device=dev)
        tree.prepare_targets(pts, "src")
        torch.cuda.synchronize()
        return tree, time.perf_counter() - t0

    if GATE_ENV in os.environ:
        raise RuntimeError(f"unset {GATE_ENV}: phase 8 compares the default gate with 0")
    ungated, t_u = build()
    os.environ[GATE_ENV] = "0"
    try:
        gated, t_g = build()
    finally:
        del os.environ[GATE_ENV]
    budget = 1.5e9
    log(f"phase 8: trees built in {t_u:.3f} s (default gate) and {t_g:.3f} s (gate 0); "
        f"w-list cells {ungated.m2p_cells}, node-tile bytes {ungated.nodetile_bytes} "
        f"(saved when gated), default gate fired: {ungated._m2p_tiles_gated}; at this "
        f"density the gate would fire unforced near N = {n * budget / ungated.nodetile_bytes:.4g} "
        f"(linear in N)")
    if ungated._m2p_tiles_gated or not gated._m2p_tiles_gated:
        raise AssertionError("phase 8 needs one ungated and one gated tree")

    wd = torch.as_tensor(w, device=dev)
    idx = np.sort(np.random.default_rng(6).choice(n, 4096, replace=False))
    out, launches = {}, {}
    for key, tree in (("ungated", ungated), ("gated", gated)):
        torch.cuda.synchronize()
        nf.reset_launches()
        v32 = tree.evaluate_device(wd, "src", "f32")
        v64 = tree.evaluate_device(wd, "src", "f64")
        tree.set_local_coefficients(w)
        gv, gg = tree.evaluate_leaves_with_gradients(w, pts[idx])
        torch.cuda.synchronize()
        launches[key] = dict(nf.LAUNCHES)
        out[key] = (v32, v64, torch.as_tensor(gv), torch.as_tensor(gg))
    errs = [rel_err(a, b) for a, b in zip(out["gated"], out["ungated"])]
    # the card's index_add_ (M2M, L2L) adds in no fixed order, so two full
    # pipelines differ in the last bits: the gated leaf pass on the ungated
    # tree's expansions isolates the gate, and the ungated tree after a
    # second upward and downward pass measures that noise
    gated._weight_tiles, gated._multipole, gated._local = (
        ungated._weight_tiles, ungated._multipole, ungated._local)
    shared = [torch.as_tensor(x) for x in gated.evaluate_leaves_with_gradients(w, pts[idx])]
    shared = [rel_err(a, b) for a, b in zip(shared, out["ungated"][2:])]
    ungated._multipole = None
    again = [torch.as_tensor(x) for x in ungated.evaluate_with_gradients(w, pts[idx])]
    noise = [rel_err(a, b) for a, b in zip(again, out["ungated"][2:])]
    log(f"phase 8: gated vs ungated: f32 matvec {errs[0]:.3e} (bound 1e-5), f64 matvec "
        f"{errs[1]:.3e} (bound 1e-12); at 4,096 sources, each tree's own expansions: "
        f"values {errs[2]:.3e} (bound 1e-12), gradients {errs[3]:.3e} (bound "
        f"{GRAD_NOISE:.0e}); on shared expansions: values {shared[0]:.3e}, gradients "
        f"{shared[1]:.3e} (bound 1e-12); the ungated tree against itself after a second "
        f"upward and downward pass: values {noise[0]:.3e}, gradients {noise[1]:.3e} "
        f"(bound {GRAD_NOISE:.0e})")
    log(f"phase 8: launches ungated {json.dumps(launches['ungated'])}; "
        f"gated {json.dumps(launches['gated'])}")
    cells = ("near_field_cells_f32", "near_field_cells_f64", "near_field_cells_grad_f64")
    if not all(launches["gated"][k] > 0 for k in cells):
        raise AssertionError(f"H4 never launched on the gated tree: {launches['gated']}")
    if any(launches["ungated"][k] for k in cells):
        raise AssertionError(f"H4 launched on the ungated tree: {launches['ungated']}")
    if not (errs[0] <= 1e-5 and max(errs[1:3] + shared + noise[:1]) <= 1e-12
            and max(errs[3], noise[1]) <= GRAD_NOISE):
        raise AssertionError(f"gated vs ungated: {errs}, shared {shared}, noise {noise}")

    # H4 on the gated M2P operands, against its plain version on the same
    # operands (all rows, in the plain version's row chunks) and against the
    # ungated M2P leg (H1/H2/H3 on the stored node tiles) on the same tree;
    # the 256 rows with the longest w-lists show how much the tail weighs
    binned, ub = gated._target_cache["src"], ungated._target_cache["src"]
    t = binned[torch.float64]["tpts"].shape[1]
    tlive = torch.bincount(binned["inv_flat"] // t, minlength=binned["wcnt"].shape[0])
    slive = torch.full((gated.tree.num_cells + 1,), gated.nnodes, device=dev)
    slive[-1] = 0
    sel = torch.argsort(binned["wcnt"], descending=True)[:256]
    log(f"phase 8: w-list cells per row: max {int(binned['wcnt'].max())}, mean over rows "
        f"{float(binned['wcnt'].double().mean()):.2f}, rows {binned['wcnt'].shape[0]}")
    entries = {}
    for name, dtype, grad in (("near_field_cells_f32", torch.float32, False),
                              ("near_field_cells_f64", torch.float64, False),
                              ("near_field_cells_grad_f64", torch.float64, True)):
        tpts = gated._binned_floats(binned, dtype)["tpts"]
        mult = gated._multipole.to(dtype)
        ops = (tpts, binned["wtab"], binned["wcnt"], *gated._cell_geometry(), mult)
        leg = (ungated._binned_floats(ub, dtype)["tpts"], ungated._floats(dtype)["node_tiles"],
               ungated._m2p_tiles(ungated._multipole.to(dtype)), ub["wtab"], ub["wcnt"])
        chunk = (tpts[sel].contiguous(), binned["wtab"][:, sel].contiguous(),
                 binned["wcnt"][sel].contiguous(), *ops[3:])
        h4 = nf.near_field_cells_grad if grad else nf.near_field_cells
        h123 = nf.near_field_grad if grad else nf.near_field
        plain = nf.near_field_cells_grad_plain if grad else nf.near_field_cells_plain
        rel, absd = cells_vs_plain(nf, kp, ops, grad)
        held = rel
        if dtype == torch.float32:
            # a row sums (w-list cells x p^d) f32 terms, tens of thousands
            # at 1M, and two summation orders differ in proportion to the
            # sum of |terms|, not to |sum|: the f32 check is held against
            # that scale (phi = -r keeps one sign here, so the plain version
            # on |mult| gives it up to sign)
            held = absd / float(plain(*ops[:-1], mult.abs(), kparams=kp).abs().max())
        if not held <= TOL[dtype]:
            raise AssertionError(f"{name} vs plain on the gated M2P: {held:.3e}")
        ms = cuda_ms(lambda: h4(*ops, kparams=kp))
        leg_ms = cuda_ms(lambda: h123(*leg, kparams=kp))
        chunk_ms = cuda_ms(lambda: h4(*chunk, kparams=kp))
        plain_ms = cuda_ms(lambda: plain(*ops, kparams=kp), reps=1)
        bound_ms, bound_by, flops = near_field_bound(kp, ops, tlive, slive, grad,
                                                     nrhs=mult.shape[2])
        pairs = float((binned["wcnt"].double() * t).sum()) * gated.nnodes
        log(f"phase 8: {name} gated M2P, rows {tpts.shape[0]}: kernel {ms:.4f} ms "
            f"({pairs / (ms * 1e-3) / 1e9:.1f} Gpair/s, {flops / (ms * 1e-3) / 1e12:.2f} "
            f"TFLOP/s), bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"max |diff| {absd:.3e}: {rel:.3e} of max |out|, {held:.3e} of the scale held "
            f"(bound {TOL[dtype]:.0e}); ungated M2P leg "
            f"({'H3' if grad else 'H1' if dtype == torch.float32 else 'H2'}) {leg_ms:.4f} ms, "
            f"gated / ungated {ms / leg_ms:.3f}; the {sel.numel()} longest rows alone: "
            f"kernel {chunk_ms:.4f} ms")
        entries[name] = kernel_entry(name, launches["gated"][name],
                                     {"abs": absd, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound_ms, "bound_by": bound_by})
    return entries


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is false)")
    sys.path.insert(0, HERE)
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops import kernels as kt_mod
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    nf.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
        f"({nf.BUILD_INFO['path']})")
    entry = "?"
    for line in nf.BUILD_INFO["log"].splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            log(f"phase 1: ptxas {entry}: {line.strip()}")

    phase_kernels(nf, kt_mod, dev)
    phase_kernels_cells(nf, kt_mod, dev)
    phase_config2(frt, nf, dev)
    rbfi, pts, span, entries = phase_albatite(frt, nf, timing, dev)
    phase_config2_gradients(nf, dev)
    iso_launches = phase_isosurface(frt, nf, timing, rbfi, pts, span)
    entries["near_field_grad_f64"]["launches"] = iso_launches["near_field_grad_f64"]
    rbfi4 = phase_config4(frt, nf, timing, dev)
    entries.update(phase_gate(nf, dev, rbfi4))

    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
