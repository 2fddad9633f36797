#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); build the CUDA near-field
   kernels from ``ferreus_rbf_tpu_torch/csrc/near_field.cu`` with nvcc,
   print the build seconds and ptxas' registers and spills per kernel (per
   kernel, dtype and rhs block over the ten kernel types);
2. kernel vs plain PyTorch version for all ten kernel types, f32 (H1) and
   f64 (H2), and the f64 gradient kernel (H3), with and without per-row
   counts, with sentinel entries, a row of count 0 and (H3) targets that
   are exact copies of sources; H1/H2 and H3 again with live counts on a
   skewed list (one row of 216 tiles, the rest at most 8), rows of 0, 1, 9
   or 128 live targets and tiles of 0 to S live sources, nrhs {1, 2, 8},
   two launches bitwise equal and dead slots 0; then the cell-node kernels
   H4 (f32, f64, gradients) the same way, with live target counts,
   sentinel cells and targets that coincide with cell nodes; all of it at
   d = 3, and again at d = 2 and d = 1 (points of those dimensions: H1/H2
   nrhs {1, 8} and H3 nrhs {1, 2} with and without counts, coincident
   targets, H4 on cells of p^d nodes; the skewed live-count lists at d = 3
   only);
3. config-2 matvec: 100k uniform 3-D points, LinearRbf, p = 5, 8 RHS,
   uniform tree, at f32 and f64, against a dense f64 oracle on 1,024
   targets; median of 5 timed matvecs;
4. the fit path: the iterative fit of the albatite dataset (35,801 3-D
   signed-distance points, Spheroidal order 5, base_range = total_sill =
   span / 4, default Params), evaluation at the sources and on a 64^3
   grid, then ``evaluate_with_gradients`` on the same grid, checked
   against the values and against a dense f64 gradient on 1,024 grid
   points, with its peak device memory; the fit's near-field calls per leg
   (P2P, M2P, P2L) and precision; H1/H2/H3 timed on the fit's P2P, M2P and
   P2L legs (H3: P2P, M2P) with their live counts, live pair rates and
   live shares; H3's launches in the 64^3 gradients and an estimate of
   their device time (each table's last operands re-timed, times its
   calls) against the evaluation's wall-clock; the fit's solver path: the
   fused FGMRES (``solver/fused.py``) with its cycles replayed from a CUDA
   graph and one host pull per cycle, then a second fused fit bit for bit
   the first, one replayed cycle bit for bit the eager cycle, a whole
   cycle timed both ways, and the host loop (``FERREUS_RBF_TPU_FUSED=0``),
   both converged and agreeing within 1e-2 * (max |c| + 1);
5. config-2 gradients (the JAX bench's gradient cell): 100k uniform points,
   Spheroidal5, p = 5, 2 RHS, adaptive sparse tree, ``evaluate_with_gradients``
   at the sources against value-only ``evaluate`` and a dense f64 oracle;
   H3 timed there as in phase 4;
6. the isosurface path: ``build_isosurface`` of the phase-4 fit at span/100
   (the reference example's settings), checked for a non-empty mesh with
   finite vertices inside the padded extents and no edge on more than two
   facets; the work lists built (``nf_work_items``);
7. config 4, the north-star fit: 1,000,000 signed-distance samples in a
   shell around a bumpy sphere (``bench.py``'s ``_synthetic_sd``, seed 11),
   LinearRbf, default Params, through ``RBFInterpolator``: fit seconds and
   stages, the solver's residual and refinement rounds, the DDM's
   per-level leaf sizes, ``evaluate_at_source`` against the values, a
   dense f64 oracle at 1,024 sources, peak device memory, and whether the
   P2M/L2P weight budget switched; the fit's near-field calls per leg, and
   H1/H2 timed on the fit's own last operands of each neighbour table (P2P
   and M2P of "__all__" and of each DDM level set, P2L) against the plain
   version, with the table's calls in the fit; the fit's solver path and
   the gate that kept the host loop; the interaction lists of the fit's
   octree built by the native builder and by the numpy one, equal, with
   each one's seconds;
8. the M2P node-tile gate at 1M: phase 7's weights on one tree with the
   gate at its default and one with ``FERREUS_RBF_TPU_NODETILE_BYTES=0``
   (gated, M2P on H4): f32 and f64 matvecs and gradients at 4,096 sources,
   bit for bit equal between the two, H4 held against its plain version on
   the gated tree's whole M2P with live target counts and timed against
   the ungated M2P leg (H1/H2/H3), which it must equal bit for bit, with
   the share of its 256 longest rows;
9. global trends, model I/O, the builder and ``bbfmm`` (run after phase 6,
   beside the other albatite phases): (a) the albatite dataset fit under
   the trend of ``examples/isosurface_trend_linear.py`` (LinearRbf,
   ``GlobalTrend.three(30, 45, 0, 2.0, 1.5, 1.0)``) through
   ``RBFInterpolator.builder``: fit seconds, residual, ``evaluate_at_source``
   and the fit's H1/H2 launches and solver path; (b)
   ``evaluate_with_gradients`` on the 64^3 grid against a dense f64
   gradient through the trend's Jacobian on 1,024 grid points, with its
   H3 launches; (c) ``save_model`` and
   ``load_model(..., device="cuda")``: the loaded model's values and
   gradients on the grid bit for bit the fitted model's; (d) its
   isosurface at span/100 with phase 6's checks; (e) ``bbfmm.FmmTree`` with
   the Laplacian over the albatite points, 2 RHS, ``evaluate`` and
   ``evaluate_with_gradients`` at 1,024 grid points against a dense f64
   sum, and ``evaluate_leaves`` after ``set_local_coefficients`` bit for bit
   ``evaluate``;
10. the sharded path (run after phase 9, before phase 7, while this
    process holds little device memory): ranks spawned over
    ``torch.distributed``, two sharing ``cuda:0`` over gloo on a one-card
    machine, ``min(4, cards)`` over NCCL on more, each of them under
    ``parallel.use_mesh``: (a) config 2's matvec at f32 and f64, bit for bit
    a one-rank matvec of the same tree and the same on every rank, timed
    per rank against phase 3; (b) the albatite fit on the fused path and
    on the host loop, converged and bit for bit phase 4's one-rank fits;
    (c) the albatite tree with the gate forced, f32 and f64 bit for bit one
    rank, H4 launched on every rank; with each rank's launches of H1, H2
    and H4, its share of leaves, M2L slots, rows and Schwarz domains, its
    factor bytes and its peak device memory. A rank that fails fails the
    run;
11. the 1-D and 2-D paths and the examples (run after phase 9, before
    phase 10): (a) 2-D: Franke's function at 250,000 random points (seed
    42), ThinPlateSpline, default Params, fitted twice (the second bit for
    bit the first), with its residual, ``evaluate_at_source``, a dense f64
    oracle at 1,024 sources, its stages, DDM levels, peak device memory and
    per-leg launches; a 512^2 grid evaluated, and with gradients against a
    dense f64 gradient at 1,024 grid points (H3 at d = 2); phase 8's gate
    check on its points and coefficients (gated tree: M2P on H4 at d = 2,
    bit for bit the ungated tree); H1, H2 and H3 timed on the legs of a
    tree over its points, with live pair rates; (b) 1-D: sin(12 x) + 0.3
    cos(31 x) at 100,000 random points on [0, 1] (seed 5), LinearRbf,
    default Params, the same fit checks, a 65,536-point evaluation (its
    tree has no w-lists, so no M2P and no gate) and H1/H2 timed on its
    P2P leg; (c) the nine examples of
    ``ferreus_rbf_tpu_torch/examples`` on the card at full size, each in a
    temporary directory, with its seconds and launches: the line its JAX
    counterpart's test expects, ``isosurface_sphere``'s 540 vertices and
    1076 facets, ``boundary_closure``'s lines equal to the JAX example's,
    ``franke_2d``'s errors below 1e-6 and 1e-2, the albatite fits'
    printed residuals below 1e-4 of max |values|, and phase 6's checks on
    every mesh written.

Repeat evaluations on the card are bitwise equal (the M2M adds its octants
in a fixed order), and the script holds them so: phase 4 runs
``evaluate_device`` twice on one tree (f32 and f64) and
``evaluate_with_gradients`` twice on the 64^3 grid, phase 8 compares the
gated and ungated trees and a tree against itself after a second upward
and downward pass, phase 9 a saved and loaded model, phase 10 every
sharded result against one rank and phase 11 each fit against its repeat
and the 2-D gated tree against the ungated one, each bit for bit.

Phases 4-11 each zero the kernels' launch counters just before they drive
the port and read them just after (phase 10 in each rank). The line before the last is a JSON
object with one entry per kernel: its launches on its path (phase 4 for
H1/H2, phase 6 for H3, phase 8's gated tree for H4), its error and time
against the plain version (the albatite shapes for H1-H3, phase 8's gated
M2P for H4), and its bound; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
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
# the Laplacian through bbfmm against a dense sum, relative to max |want|:
# the JAX package's bound (tests/test_api_surface.py)
BBFMM_BOUND = 1e-2

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


def kernel_vs_plain(nf, kparams, tgt, src, w, nbr, cnt, grad=False, counts=None):
    """(relative error, max |diff|) of the kernel against its plain
    version; for H3 the worse of values and gradients. ``counts`` holds the
    live counts (tcnt, scnt)."""
    counts = counts or {}
    if grad:
        got = nf.near_field_grad(tgt, src, w, nbr, cnt, kparams=kparams, **counts)
        want = nf.near_field_grad_plain(tgt, src, w, nbr, cnt, kparams=kparams, **counts)
    else:
        got = (nf.near_field(tgt, src, w, nbr, cnt, kparams=kparams, **counts),)
        want = (nf.near_field_plain(tgt, src, w, nbr, cnt, kparams=kparams, **counts),)
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


def phase_kernels(nf, kt_mod, dev, d=3):
    """H1/H2: all kernel types x {f32, f64} x {counts, none} x nrhs {1, 8};
    H3: all kernel types x {counts, none} x nrhs {1, 2, 8} (d = 3) or {1,
    2} (d = 1, 2), f64, with targets that are exact copies of sources; at
    d = 3 both again with live counts on a skewed list. ``d``: the points'
    dimension."""
    g = torch.Generator(device="cpu").manual_seed(0)
    rows, t, s, u, ntiles = 300, 128, 256, 27, 400
    tgt = torch.rand((rows, t, d), generator=g, dtype=torch.float64) - 0.5
    src = torch.rand((ntiles + 1, d, s), generator=g, dtype=torch.float64) - 0.5
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
        log(f"phase 2: d = {d}, 10 kernel types x counts x nrhs {{1,8}}, {dtype}: "
            f"worst relative error {err:.3e} (bound {TOL[dtype]:.0e})")

    if d == 3:
        # H1/H2 with live counts: one row lists 216 tiles, the rest at most 8;
        # rows of 0, 1, 9 or 128 live targets; tiles of 0 to S live sources
        ntiles = 400
        scnt = torch.randint(0, s + 1, (ntiles + 1,), generator=g, dtype=torch.int32)
        scnt[:2] = torch.tensor([0, s], dtype=torch.int32)
        scnt[ntiles] = 0
        u = 216
        nbr = torch.randint(0, ntiles, (u, rows), generator=g, dtype=torch.int32)
        nbr[u - 1, ::2] = ntiles
        nbr[:, 1] = torch.randperm(ntiles, generator=g)[:u].int()
        cnt = torch.randint(0, 9, (rows,), generator=g, dtype=torch.int32)
        cnt[:2] = torch.tensor([0, u], dtype=torch.int32)
        choice = torch.tensor([0, 1, 9, 128], dtype=torch.int32)
        tcnt = choice[torch.randint(0, 4, (rows,), generator=g)]
        tcnt[1] = 128
        src = torch.rand((ntiles + 1, 3, s), generator=g, dtype=torch.float64) - 0.5
        slot_live = torch.arange(s)[None, None, :] < scnt.long()[:, None, None]
        lists = [nf.work_items(*(x.to(on) for x in (nbr, cnt, tcnt, scnt)), t=t, s=s,
                               l1=ntiles + 1) for on in (dev, torch.device("cpu"))]
        if not (all(torch.equal(a.cpu(), b) for a, b in zip(lists[0][:3], lists[1][:3]))
                and lists[0].nparts == lists[1].nparts):
            raise AssertionError("the work list built on the card is not the CPU's")
        worst = {}
        for nrhs in (1, 2, 8):
            w = torch.randn((ntiles + 1, nrhs, s), generator=g, dtype=torch.float64)
            w = torch.where(slot_live, w, 0.0)
            for kt in kt_mod.KernelType:
                kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in kt.value else {}
                kp = kt_mod.KernelParams(kt, **kw)
                for dtype in (torch.float32, torch.float64):
                    ops = [x.to(dev, dtype) for x in (tgt, src, w)] + [nbr.to(dev), cnt.to(dev)]
                    counts = {"tcnt": tcnt.to(dev), "scnt": scnt.to(dev)}
                    err, _ = kernel_vs_plain(nf, kp, *ops, counts=counts)
                    key = (kt.value, str(dtype).split(".")[-1], nrhs)
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"live counts, kernel vs plain {key}: {err:.3e}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    out = nf.near_field(*ops, kparams=kp, **counts)
                    again = nf.near_field(*ops, kparams=kp, **counts)
                    dead = torch.arange(t, device=dev)[None, :] >= counts["tcnt"][:, None]
                    if not torch.equal(out, again):
                        raise AssertionError(f"live counts {key}: two launches differ")
                    if float(out[dead].abs().max()) != 0.0 or float(out[0].abs().max()) != 0.0:
                        raise AssertionError(f"live counts {key}: a dead slot is not 0")
        for dtype, err in worst.items():
            log(f"phase 2: live counts (a 216-tile row, tcnt in {{0,1,9,128}}, scnt 0..{s}), "
                f"10 kernel types x nrhs {{1,2,8}}, {dtype}: worst relative error {err:.3e} "
                f"(bound {TOL[dtype]:.0e}); two launches bitwise equal, dead slots 0; the work "
                f"list built on the card equals the CPU's")

    # H3: values and gradients, f64; some targets are exact copies of sources
    tgt64 = tgt.clone()
    for r in range(1, rows, 7):
        tile = int(nbr[0, r])
        tgt64[r, :20] = src[tile, :, :20].T
    worst = 0.0
    for nrhs in (1, 2, 8) if d == 3 else (1, 2):
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
    log(f"phase 2: d = {d}, H3 near_field_grad_f64, 10 kernel types x counts x nrhs "
        f"{{1,2{',8' if d == 3 else ''}}}, coincident targets: worst relative error "
        f"{worst:.3e} (values and gradients; bound 1e-12)")
    if d != 3:
        return

    # H3 with live counts on the skewed list: sources past scnt carry random
    # weights, which must weigh nothing
    worst = 0.0
    counts = {"tcnt": tcnt.to(dev), "scnt": scnt.to(dev)}
    dead = torch.arange(t, device=dev)[None, :] >= counts["tcnt"][:, None]
    for nrhs in (1, 2, 8):
        w = torch.randn((ntiles + 1, nrhs, s), generator=g, dtype=torch.float64)
        ops = [x.to(dev) for x in (tgt64, src, w, nbr, cnt)]
        for kt in kt_mod.KernelType:
            kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in kt.value else {}
            kp = kt_mod.KernelParams(kt, **kw)
            err, _ = kernel_vs_plain(nf, kp, *ops, grad=True, counts=counts)
            if not err <= TOL[torch.float64]:
                raise AssertionError(f"H3 live counts vs plain {(kt.value, nrhs)}: {err:.3e}")
            worst = max(worst, err)
            outs = nf.near_field_grad(*ops, kparams=kp, **counts)
            again = nf.near_field_grad(*ops, kparams=kp, **counts)
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                raise AssertionError(f"H3 live counts {(kt.value, nrhs)}: two launches differ")
            if any(float(o[dead].abs().max()) != 0.0 or float(o[0].abs().max()) != 0.0
                   for o in outs):
                raise AssertionError(f"H3 live counts {(kt.value, nrhs)}: a dead slot is not 0")
    log(f"phase 2: H3 with live counts (the 216-tile row, tcnt in {{0,1,9,128}}, scnt "
        f"0..{s}, weights past scnt random), 10 kernel types x nrhs {{1,2,8}}, coincident "
        f"targets: worst relative error {worst:.3e} (bound 1e-12); two launches bitwise "
        f"equal, dead slots 0")


def cells_vs_plain(nf, kparams, ops, grad=False, tcnt=None):
    """(relative error, max |diff|) of H4 against its plain version on the
    operands (tgt, cells, cnt, centers, lengths, nodes, mult) with live
    target counts ``tcnt``; for the gradient form the worse of values and
    gradients."""
    if grad:
        got = nf.near_field_cells_grad(*ops, kparams=kparams, tcnt=tcnt)
        want = nf.near_field_cells_grad_plain(*ops, kparams=kparams, tcnt=tcnt)
    else:
        got = (nf.near_field_cells(*ops, kparams=kparams, tcnt=tcnt),)
        want = (nf.near_field_cells_plain(*ops, kparams=kparams, tcnt=tcnt),)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in want + got):
        raise AssertionError("H4 or its plain version is not finite")
    return (max(rel_err(a, b) for a, b in zip(got, want)),
            max(float((a - b).abs().max()) for a, b in zip(got, want)))


def phase_kernels_cells(nf, kt_mod, dev, d=3):
    """H4: all kernel types x {f32, f64, gradients} x {counts, none} x nrhs
    {1, 2, 8} on p = 7 cells (p^d nodes; at d = 3 343: 11 staging chunks,
    the last partial), with sentinel cells, a row of count 0, rows of 0, 1,
    9, 100 or 128 live targets and targets that coincide with nodes of a
    listed cell; two launches bitwise equal and dead slots 0."""
    from ferreus_rbf_tpu_torch.ops.fmm import cheb

    g = torch.Generator(device="cpu").manual_seed(5)
    f64 = torch.float64
    p, ncells, rows, t, u = 7, 300, 160, 128, 16
    nodes = torch.as_tensor(cheb.nodes_tensor_product(cheb.chebyshev_nodes(p), d))
    centers = torch.rand((ncells, d), generator=g, dtype=f64) - 0.5
    lengths = 0.05 + 0.15 * torch.rand((ncells,), generator=g, dtype=f64)
    cells = torch.randint(0, ncells, (u, rows), generator=g, dtype=torch.int32)
    cells[12:, ::3] = ncells  # sentinel cells
    cnt = torch.randint(0, u + 1, (rows,), generator=g, dtype=torch.int32)
    cnt[0] = 0
    cnt[1] = u
    cells[:, 1] = torch.randperm(ncells, generator=g)[:u].int()  # no sentinel
    choice = torch.tensor([0, 1, 9, 100, 128], dtype=torch.int32)
    tcnt = choice[torch.randint(0, 5, (rows,), generator=g)].to(dev)
    dead = torch.arange(t, device=dev)[None, :] >= tcnt[:, None]
    tgt = torch.rand((rows, t, d), generator=g, dtype=f64) - 0.5
    for r in range(1, rows, 7):  # exact copies of a listed cell's nodes
        c = int(cells[0, r])
        k = min(20, nodes.shape[0])
        tgt[r, :k] = centers[c] + (lengths[c] * 0.5) * nodes[:k]
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
                        # live target counts: the plain version's values,
                        # two launches bitwise equal, dead slots 0
                        err, _ = cells_vs_plain(nf, kp, ops, grad, tcnt=tcnt)
                        if not err <= TOL[dtype]:
                            raise AssertionError(
                                f"H4 with tcnt vs plain {(kt.value, key, nrhs)}: {err:.3e}")
                        worst[key] = max(worst[key], err)
                        outs = fn(*ops, kparams=kp, tcnt=tcnt)
                        again = fn(*ops, kparams=kp, tcnt=tcnt)
                        outs, again = (outs, again) if grad else ((outs,), (again,))
                        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                            raise AssertionError(f"H4 {(kt.value, key, nrhs)}: two launches "
                                                 f"differ")
                        if any(float(o[dead].abs().max()) != 0.0 for o in outs):
                            raise AssertionError(f"H4 {(kt.value, key, nrhs)}: a dead slot is "
                                                 f"not 0")
    for key, err in worst.items():
        log(f"phase 2: d = {d}, H4 near_field_cells {key}, 10 kernel types x counts x nrhs "
            f"{{1,2,8}}, with and without live target counts, p = 7 cells ({p ** d} nodes), "
            f"coincident targets: worst "
            f"relative error {err:.3e} (bound {TOL[torch.float32 if key == 'float32' else f64]:.0e}); "
            f"two launches bitwise equal, dead slots 0")


def tree_legs(tree, key, dtype, nrhs, g, with_p2l=True):
    """A tree's own near-field legs at its binned target set ``key``, with
    random weights: {leg: (operands, live counts)}. P2P and M2P at the set,
    P2L at the tree's cells. The counts (live target slots per row, live
    source slots per tile) are derived from the binning and the source
    mask, which every version of ``FmmTree`` keeps (``near_field_legs.py``
    runs this on another tree of the package too)."""
    binned = tree._target_cache[key]
    fs = tree._floats(dtype)
    tpts = tree._binned_floats(binned, dtype)["tpts"]
    dev = tree.device
    mask = tree._dev["src_mask"]
    tcnt = torch.bincount(binned["inv_flat"] // tpts.shape[1], minlength=tpts.shape[0]).int()
    scnt = mask.sum(1).int()
    w = torch.randn((tree.nsl + 1, nrhs, tree.smax), generator=g, dtype=torch.float64)
    w = torch.where(mask[:, None, :].cpu(), w, 0.0).to(dev, dtype)
    legs = {"p2p": ((tpts, fs["src_tiles"], w, binned["nbr"], None),
                    {"tcnt": tcnt, "scnt": scnt})}
    if binned["wtab"] is not None:
        mt = torch.randn((tree._m2p_nw + 1, nrhs, tree.nnodes), generator=g,
                         dtype=torch.float64)
        mt[-1] = 0.0
        legs["m2p"] = ((tpts, fs["node_tiles"], mt.to(dev, dtype), binned["wtab"],
                        binned["wcnt"]), {"tcnt": tcnt})
    if with_p2l and tree._dev["p2l_cells"].numel():
        legs["p2l"] = ((fs["p2l_nodes"], fs["src_tiles"], w, tree._dev["p2l_nbr"],
                        tree._dev["p2l_cnt"]), {"scnt": scnt})
    return legs


def live_slots(ops, counts):
    """(live targets per row, live sources per tile) of a leg: its counts,
    else every slot, the sentinel tile (the last) excluded."""
    tgt, src = ops[:2]
    tlive = counts.get("tcnt")
    if tlive is None:
        tlive = torch.full((tgt.shape[0],), tgt.shape[1], device=tgt.device)
    slive = counts.get("scnt")
    if slive is None:
        slive = torch.full((src.shape[0],), src.shape[2], device=src.device)
        slive[-1] = 0
    return tlive, slive


def timed(fn):
    """(result, device ms) of one call of ``fn`` (CUDA events, no warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def time_leg(nf, kparams, dtype, ops, counts, grad=False, f32_scale=False, plain_reps=3):
    """Kernel and plain-version times (ms), errors, bound and pair rates of
    one leg; the bound counts the live pairs of ``counts``, which the
    kernels also take. Two launches must be bitwise equal.
    ``f32_scale`` holds the error against the largest sum of |terms| (the
    plain version on |w|; phi keeps one sign for LinearRbf), the scale of
    rounding in a long f32 sum, instead of max |out|. ``plain_reps`` 0
    times the plain version's one checking call instead of a warm mean."""
    tgt, src, w, nbr, cnt = ops
    tlive, slive = live_slots(ops, counts)
    kernel = nf.near_field_grad if grad else nf.near_field
    plain = nf.near_field_grad_plain if grad else nf.near_field_plain
    call = lambda fn, wt=w: fn(tgt, src, wt, nbr, cnt, kparams=kparams, **counts)  # noqa: E731
    want, plain_ms = timed(lambda: call(plain))
    got = call(kernel)
    got, want = (got, want) if grad else ((got,), (want,))
    if not all(torch.isfinite(x).all() for x in want + got):
        raise AssertionError("the kernel or its plain version is not finite")
    rel = max(rel_err(a, b) for a, b in zip(got, want))
    absd = max(float((a - b).abs().max()) for a, b in zip(got, want))
    held = rel
    if f32_scale:
        held = absd / float(call(plain, w.abs()).abs().max())
    if not held <= TOL[dtype]:
        raise AssertionError(f"kernel vs plain: {held:.3e} > {TOL[dtype]}")
    again = call(kernel)
    if not all(torch.equal(a, b) for a, b in zip(got, again if grad else (again,))):
        raise AssertionError("two launches on the same operands differ")
    ms = cuda_ms(lambda: call(kernel))
    if plain_reps:
        plain_ms = cuda_ms(lambda: call(plain), reps=plain_reps)
    bound_ms, bound_by, flops = near_field_bound(kparams, (tgt, nbr, cnt, src, w), tlive,
                                                 slive, grad)
    listed = nbr.T.long() != src.shape[0] - 1
    if cnt is not None:
        listed &= torch.arange(nbr.shape[0], device=nbr.device)[None, :] < cnt[:, None]
    # (target slot, source slot) pairs a one-block-per-row loop ran, pads
    # included, against the live pairs the bound counts
    slot_pairs = int(listed.sum()) * tgt.shape[1] * src.shape[2]
    live_src = (slive[nbr.T.long()] * listed).sum(1).double()
    live_pairs = float((live_src * tlive.double()).sum())
    src_share = float(live_src.sum()) / max(int(listed.sum()) * src.shape[2], 1)
    return {"rel": rel, "abs": absd, "held": held, "ms": ms, "plain_ms": plain_ms,
            "gpairs_s": slot_pairs / (ms * 1e-3) / 1e9,
            "live_gpairs_s": live_pairs / (ms * 1e-3) / 1e9, "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": flops / (ms * 1e-3) / 1e12,
            "tlive": float(tlive.sum()) / (tgt.shape[0] * tgt.shape[1]), "slive": src_share,
            "shape": [tuple(x.shape) for x in ops[:4]]}


def time_near_field(nf, tree, key, dtype, kparams, nrhs, g, grad=False):
    """:func:`time_leg` on each of a tree's own legs at its binned set
    ``key`` (H3 when ``grad``: P2P and M2P)."""
    legs = tree_legs(tree, key, dtype, nrhs, g, with_p2l=not grad)
    return {name: time_leg(nf, kparams, dtype, *leg, grad=grad) for name, leg in legs.items()}


def log_near_field(prefix, name, r):
    for part, m in r.items():
        log(f"{prefix} {part} {name} shapes {m['shape']}: kernel {m['ms']:.4f} ms "
            f"({m['live_gpairs_s']:.2f} live Gpair/s; {m['gpairs_s']:.1f} Gpair/s counting "
            f"pads; {m['tflops']:.2f} TFLOP/s), bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}), plain {m['plain_ms']:.4f} ms, rel err {m['rel']:.3e} "
            f"(held {m['held']:.3e}); live share of target slots {m['tlive']:.4f}, of "
            f"listed source slots {m['slive']:.4f}")


class LegCounter:
    """While installed, wraps ``api.near_field`` (H1/H2, which ``FmmTree``
    calls once per leg: P2L without tcnt, M2P with a count table, P2P
    without one), or ``api.near_field_grad`` (H3: P2P and M2P) when ``name``
    says so, to count its calls per (leg, dtype) and per neighbour table,
    and keep each table's last operands; ``LAUNCHES`` still counts the
    launches themselves. Its per-leg counts sit in ``fused.COUNTS`` while
    it is installed, so that a replayed solver cycle adds its calls."""

    def __init__(self, api, name="near_field"):
        self.api, self.name, self.real = api, name, getattr(api, name)
        self.calls, self.last = {}, {}

    def __enter__(self):
        from ferreus_rbf_tpu_torch.solver import fused

        fused.COUNTS.append(self.calls)  # a graph replay adds its calls too

        def counted(tgt, src, w, nbr, cnt=None, **kw):
            leg = "p2l" if kw.get("tcnt") is None else "m2p" if cnt is not None else "p2p"
            key = f"{leg}_{str(tgt.dtype).split('.')[-1]}"
            self.calls[key] = self.calls.get(key, 0) + 1
            counts = {k: v for k, v in kw.items() if k in ("tcnt", "scnt")}
            calls = self.last.get((key, id(nbr)), (None, None, 0))[2]
            self.last[(key, id(nbr))] = ((tgt, src, w, nbr, cnt), counts, calls + 1)
            return self.real(tgt, src, w, nbr, cnt, **kw)

        setattr(self.api, self.name, counted)
        return self

    def __exit__(self, *exc):
        from ferreus_rbf_tpu_torch.solver import fused

        setattr(self.api, self.name, self.real)
        fused.COUNTS[:] = [c for c in fused.COUNTS if c is not self.calls]


def h3_launch_time(nf, kparams, legs, wall_s, prefix):
    """H3's launches in a gradient evaluation (a :class:`LegCounter` on
    ``near_field_grad``) and an estimate of their device time: each table's
    last operands relaunched (CUDA events, mean of 3) times the table's
    calls, per leg, against the evaluation's wall-clock."""
    per_leg = {}
    for (key, _), (ops, counts, calls) in legs.last.items():
        ms = cuda_ms(lambda: nf.near_field_grad(*ops, kparams=kparams, **counts), reps=3)
        n, total = per_leg.get(key, (0, 0.0))
        per_leg[key] = (n + calls, total + calls * ms)
    total_ms = sum(v[1] for v in per_leg.values())
    legs_txt = ", ".join(f"{k.split('_')[0]} {n} launches, {ms:.3f} ms"
                         for k, (n, ms) in sorted(per_leg.items()))
    log(f"{prefix}: H3 estimate, calls x re-timed ms on each table's last operands "
        f"({legs_txt}): {total_ms:.3f} ms, {total_ms / (wall_s * 1e3):.2%} of the "
        f"{wall_s:.3f} s wall-clock")



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
    vals, medians = {}, {}
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
        vals[prec], medians[prec] = v, med * 1e3
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
        r = time_near_field(nf, tree, "src", dtype, kp, nrhs, g)
        log_near_field(f"phase 3: config-2 nrhs {nrhs}", name, r)
    return medians


def dense_gradients(rbfi, targets, dev, chunk=256):
    """Dense f64 gradient of the fitted interpolant at ``targets`` on the
    card: ``pair_with_grad`` against every source, plus the drift's
    gradient. Under a trend the kernel sees transformed points (x' = x B +
    b), and its gradient comes back through the Jacobian as g B^T. Returns
    a host array (n, nrhs * d)."""
    from ferreus_rbf_tpu_torch.ops import polynomials
    from ferreus_rbf_tpu_torch.ops.kernels import make_kernel

    kernel = make_kernel(rbfi.interpolant_settings.kernel_params())
    trend = rbfi.global_trend
    move = (lambda x: x) if trend is None else trend.transform_points  # noqa: E731
    src = torch.as_tensor(move(rbfi.points), device=dev)
    coef = torch.as_tensor(rbfi.coefficients.point_coefficients, device=dev)
    tg = torch.as_tensor(move(targets), device=dev)
    out = []
    for c0 in range(0, tg.shape[0], chunk):
        _, gmat = kernel.pair_with_grad(tg[c0 : c0 + chunk], src)
        out.append(torch.einsum("mnd,nr->mrd", gmat, coef))
    grads = torch.cat(out)
    if trend is not None:
        bt = torch.as_tensor(trend.linear_part(grads.shape[2]).T, device=dev)
        grads = torch.einsum("mrj,jk->mrk", grads, bt)
    grads = grads.flatten(1).cpu().numpy()
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


FUSED_ENV = "FERREUS_RBF_TPU_FUSED"


def solver_path(tracer, fit_s, peak_gb, messages=None):
    """Which solver path a fit took, the gate that decided it and the
    fused path's numbers, from the fit's tracer; ``messages`` are the fit's
    progress messages (one ``SolverIteration`` per inner iteration)."""
    from ferreus_rbf_tpu_torch.progress import SolverIteration

    ev = {e["event"]: e for e in tracer.events}
    built, stats = ev.get("fused_system"), ev.get("fused_solve")
    rec = {"fused": bool(built and built["ok"]),
           "gate": f"{FUSED_ENV}=0" if built is None else built["gate"],
           "factor_mb": None if built is None else round(built["factor_bytes"] / 2**20, 3)}
    if stats:
        rec.update({k: v for k, v in stats.items() if k != "event"},
                   capture_s=round(stats["capture_s"], 4),
                   host_pulls_per_cycle=stats["host_pulls"] / stats["cycles"])
    if messages is not None:
        rec["inner_iterations"] = sum(isinstance(m, SolverIteration) for m in messages)
    rec.update(refinement_rounds=sum(e["event"] == "refine_round" for e in tracer.events),
               residual=ev["solve_done"]["residual"],
               solve_column_s=round(tracer.totals.get("solve_column", 0.0), 4),
               fit_s=round(fit_s, 4), peak_gb=round(peak_gb, 4))
    return rec


def fused_vs_host_loop(frt, timing, dev, pts, vals, settings, rbfi, fused_fit):
    """Phase 4's solver paths: the fit (``fused_fit``) on the fused path
    with its cycles replayed from graphs and one host pull per cycle; a
    second fused fit, timed, bit for bit the first, whose system then
    replays one cycle that must be bit for bit the same cycle run eagerly
    (and times a whole cycle both ways); and the host loop
    (``FERREUS_RBF_TPU_FUSED=0``) on the same data, converged and within
    1e-2 * (max |c| + 1) of the fused coefficients."""
    from ferreus_rbf_tpu_torch.solver import fused

    kept = []
    init = fused.FusedSystem.__init__

    def keep(self, system):
        init(self, system)
        kept.append(self)

    fused.FusedSystem.__init__ = keep
    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    inner = []
    t0 = time.perf_counter()
    try:
        again = frt.RBFInterpolator(pts, vals, settings, device=dev,
                                    progress_callback=frt.Progress(inner.append))
        torch.cuda.synchronize()
    finally:
        fused.FusedSystem.__init__ = init
        timing.disable_global_tracer()
    warm_fit = solver_path(tracer, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated(dev) / 1e9, inner)
    fs = kept[0]
    same = [np.array_equal(getattr(again.coefficients, k), getattr(rbfi.coefficients, k))
            for k in ("point_coefficients", "poly_coefficients")]
    # one cycle of the fit's f32 graph, replayed and run eagerly
    b = torch.zeros((fs.n + fs.m, 1), dtype=torch.float64, device=dev)
    b[: fs.n, 0] = torch.as_tensor(rbfi.point_values[:, 0], device=dev)
    args = ("f32", False, 5, b, torch.zeros_like(b), b, float(torch.linalg.norm(b)), 1e-5)
    replays = fs.stats["replays"]
    replay = fs.cycle(*args)
    eager = fs.cycle(*args, eager=True)
    cycle_same = (fs.stats["replays"] == replays + 1 and torch.equal(replay[0], eager[0])
                  and torch.equal(replay[1], eager[1]) and np.array_equal(replay[2], eager[2]))
    # a whole cycle (all 5 steps: tol 1e-14), replayed and eager; each call
    # ends in its host pull
    cycle_ms = {}
    for name, eager_run in (("replayed", False), ("eager", True)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fs.cycle(*args[:-1], 1e-14, eager=eager_run)
            times.append(time.perf_counter() - t0)
        cycle_ms[name] = round(sorted(times)[1] * 1e3, 3)
    del fs, kept, again, replay, eager

    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if FUSED_ENV in os.environ:
        raise RuntimeError(f"unset {FUSED_ENV}: phase 4 compares the fused path with 0")
    os.environ[FUSED_ENV] = "0"
    inner = []
    t0 = time.perf_counter()
    try:
        host = frt.RBFInterpolator(pts, vals, settings, device=dev,
                                   progress_callback=frt.Progress(inner.append))
        torch.cuda.synchronize()
    finally:
        del os.environ[FUSED_ENV]
        timing.disable_global_tracer()
    host_fit = solver_path(tracer, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated(dev) / 1e9, inner)
    cf, ch = rbfi.coefficients.point_coefficients, host.coefficients.point_coefficients
    apart = float(np.max(np.abs(cf - ch)))
    bound = 1e-2 * (float(np.max(np.abs(ch))) + 1.0)
    log(f"phase 4: fused fit {json.dumps(fused_fit)}")
    log(f"phase 4: fused fit again (same process, warm) {json.dumps(warm_fit)}")
    log(f"phase 4: host-loop fit ({FUSED_ENV}=0) {json.dumps(host_fit)}")
    log(f"phase 4: one whole f32 cycle (5 inner steps), host clock, median of 3 (ms): "
        f"{json.dumps(cycle_ms)}")
    log(f"phase 4: fused vs host-loop point coefficients {apart:.3e} apart (bound "
        f"{bound:.3e}); a second fused fit bitwise equal (point, poly): {same}; one f32 cycle "
        f"replayed from the graph bitwise equal to the same cycle run eagerly: {cycle_same}")
    if not (fused_fit["fused"] and fused_fit["replays"] > 0
            and fused_fit["host_pulls_per_cycle"] == 1.0):
        raise AssertionError(f"the albatite fit did not replay its cycles: {fused_fit}")
    if host_fit["fused"] or not max(fused_fit["residual"], host_fit["residual"]) <= 1e-6:
        raise AssertionError(f"fused {fused_fit['residual']}, host loop {host_fit['residual']}")
    if not (apart <= bound and all(same) and cycle_same):
        raise AssertionError(f"fused vs host loop {apart:.3e}, repeat {same}, cycle {cycle_same}")
    return host


def phase_albatite(frt, nf, timing, dev):
    """The fit path. Returns the fit, the dataset's extents and span, the
    H1/H2/H3 kernel-line entries (launches of H3 are filled in by the
    isosurface phase) and the host-loop fit."""
    from ferreus_rbf_tpu_torch.ops.fmm import api
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

    pts, vals, span, settings = albatite_data(frt)
    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nf.reset_launches()
    inner = []
    t0 = time.perf_counter()
    with LegCounter(api) as legs:
        rbfi = frt.RBFInterpolator(pts, vals, settings, device=dev,
                                   progress_callback=frt.Progress(inner.append))
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    fit_launches = dict(nf.LAUNCHES)
    fused_fit = solver_path(tracer, fit_s, torch.cuda.max_memory_allocated(dev) / 1e9, inner)
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
    with LegCounter(api, "near_field_grad") as grad_legs:
        gv, gg = rbfi.evaluate_with_gradients(grid)
        torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = dict(nf.LAUNCHES)
    grad_launches = {k: launches[k] - before[k] for k in launches}
    # P1: the same evaluation again gives the same bits
    gv2, gg2 = rbfi.evaluate_with_gradients(grid)
    if not (np.array_equal(gv2, gv) and np.array_equal(gg2, gg)):
        raise AssertionError(
            f"64^3 evaluate_with_gradients twice: values {np.max(np.abs(gv2 - gv)):.3e}, "
            f"gradients {np.max(np.abs(gg2 - gg)):.3e} apart, not bitwise equal")
    del gv2, gg2
    host = fused_vs_host_loop(frt, timing, dev, pts, vals, settings, rbfi, fused_fit)

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
    log(f"phase 4: launches: fit {json.dumps(fit_launches)} (per leg {json.dumps(legs.calls)}); "
        f"64^3 evaluate_with_gradients {json.dumps(grad_launches)}; whole phase "
        f"{json.dumps(launches)}")
    if gg.shape != (64**3, 3) or not np.isfinite(gg).all():
        raise AssertionError("grid gradients not finite or of the wrong shape")
    if not (val_err <= 1e-12 and grad_err <= ALBATITE_GRAD_BOUND):
        raise AssertionError(f"albatite gradients: values {val_err:.3e}, grads {grad_err:.3e}")
    if not all(launches[name] > 0 for name in REPLACES if not name.startswith("near_field_cells")):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    h3_launch_time(nf, settings.kernel_params(), grad_legs, grad_s,
                   "phase 4: 64^3 evaluate_with_gradients")
    del grad_legs

    # kernel vs plain at the fit's own shapes (nrhs 1): its "__all__" tree;
    # the sources are also the seed projection's first gradient targets
    params = rbfi.params
    tree = FmmTree(rbfi.points, params.fmm_params.interpolation_order,
                   settings.kernel_params(), adaptive_tree=True, sparse=True,
                   params=params.fmm_params, device=dev)
    tree.prepare_targets(rbfi.points, "__all__")
    wd = torch.as_tensor(rbfi.coefficients.point_coefficients, device=dev)
    for prec in ("f32", "f64"):
        first = tree.evaluate_device(wd, "__all__", prec)
        again = tree.evaluate_device(wd, "__all__", prec)
        if not torch.equal(first, again):
            raise AssertionError(f"evaluate_device {prec} twice on one tree: "
                                 f"{float((first - again).abs().max()):.3e} apart")
    log("phase 4: repeats bitwise equal: evaluate_device twice on the fit's tree (f32, "
        "f64); evaluate_with_gradients twice on the 64^3 grid (values, gradients)")
    g = torch.Generator(device="cpu").manual_seed(2)
    entries = {}
    for name, dtype, grad in (("near_field_f32", torch.float32, False),
                              ("near_field_f64", torch.float64, False),
                              ("near_field_grad_f64", torch.float64, True)):
        r = time_near_field(nf, tree, "__all__", dtype,
                            settings.kernel_params(), 1, g, grad=grad)
        log_near_field("phase 4: albatite", name, r)
        entries[name] = kernel_entry(name, launches[name], r["p2p"])
    return rbfi, pts, span, entries, host


def phase_config2_gradients(nf, dev):
    """The JAX bench's gradient cell: 100k uniform points, Spheroidal5,
    p = 5, 2 RHS, adaptive sparse tree, gradients at the sources."""
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.fmm import api
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
    with LegCounter(api, "near_field_grad") as grad_legs:
        tree.evaluate_with_gradients(w, pts, reuse_key="src")
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
    h3_launch_time(nf, kp, grad_legs, grad_s, "phase 5: config-2 evaluate_with_gradients "
                   "(median)")
    g = torch.Generator(device="cpu").manual_seed(3)
    r = time_near_field(nf, tree, "src", torch.float64, kp, 2, g,
                        grad=True)
    log_near_field("phase 5: config-2 nrhs 2", "near_field_grad_f64", r)


def mesh_checks(verts, facets, nonempty=True):
    """The mesh checks of phases 6, 9 and 11: non-empty (where asked),
    finite vertices, facet indices in range, no edge on more than two
    facets. Returns (max facets per edge, boundary edges) or raises."""
    edges = np.sort(facets[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, uses = np.unique(edges, axis=0, return_counts=True)
    if nonempty and facets.shape[0] == 0:
        raise AssertionError("an empty mesh")
    if not np.isfinite(verts).all() or (facets.size and facets.max() >= verts.shape[0]):
        raise AssertionError("vertices not finite or facets out of range")
    if uses.size and uses.max() > 2:
        raise AssertionError("an edge is used by more than two facets")
    return (int(uses.max()) if uses.size else 0), int((uses == 1).sum())


def phase_isosurface(frt, nf, timing, rbfi, pts, span, label="phase 6"):
    """The isosurface path: RMT on an albatite fit at span/100 (phase 6;
    phase 9 under the trend). Returns the launches."""
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
    builds = []
    work_items = nf.work_items

    def counted_lists(*args, **kw):
        builds.append(1)
        return work_items(*args, **kw)

    torch.cuda.synchronize()
    nf.reset_launches()
    nf.work_items = counted_lists
    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    try:
        mesh = rbfi.build_isosurface(extents, resolution, 0.0, frt.BoundaryClosure.None_)
        torch.cuda.synchronize()
    finally:
        nf.work_items = work_items
    iso_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    launches = dict(nf.LAUNCHES)
    del rbfi.evaluate_targets, rbfi.evaluate_targets_with_gradients, rbfi.build_evaluator
    calls = {k: round(v, 3) if isinstance(v, float) else v for k, v in calls.items()}

    verts, facets = mesh.vertices, mesh.facets
    pad = resolution * 10.0
    inside = bool(np.all(verts >= extents[:3] - pad) and np.all(verts <= extents[3:] + pad))
    most, boundary = mesh_checks(verts, facets)
    log(f"{label}: albatite isosurface at span/100 ({resolution:.6g}) {iso_s:.3f} s: "
        f"{mesh.num_vertices} vertices, {mesh.num_facets} facets; {json.dumps(calls)}; "
        f"max facets per edge {most}, boundary edges {boundary}")
    log(f"{label}: stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    log(f"{label}: nf_work_items {tracer.totals.get('nf_work_items', 0.0):.3f} s over "
        f"{len(builds)} work lists built")
    log(f"{label}: launches {json.dumps(launches)}")
    if not inside:
        raise AssertionError("isosurface outside the padded extents")
    if not (launches["near_field_f64"] > 0 and launches["near_field_grad_f64"] > 0):
        raise AssertionError(f"H2 or H3 never launched in {label}: {launches}")
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


def time_fit_legs(nf, kparams, legs):
    """H1/H2 on the 1M fit's own last operands of every neighbour table (P2P
    and M2P per target set, P2L), against the plain version (one call each;
    f32 held against the sum of |terms|), with the table's calls in the fit
    and the live share of its target slots: launches x time per leg."""
    for (key, _), (ops, counts, calls) in sorted(
            legs.last.items(), key=lambda kv: (kv[0][0], -kv[1][0][0].shape[0])):
        tgt = ops[0]
        m = time_leg(nf, kparams, tgt.dtype, ops, counts, f32_scale=tgt.dtype == torch.float32,
                     plain_reps=0)
        kernel = "near_field_f32" if tgt.dtype == torch.float32 else "near_field_f64"
        log_near_field("phase 7: 1M fit", kernel,
                       {f"{key.split('_')[0]} rows {tgt.shape[0]}, {calls} calls": m})


def list_builders(rbfi):
    """Phase 7: the interaction lists of the fit's octree built both ways,
    the native builder (``csrc/treebuild.cpp``) and the numpy one, with
    their host seconds; u and w must come out equal and v equal as a set
    once the numpy list drops sources without points (as the FMM plan
    does)."""
    import copy

    from ferreus_rbf_tpu_torch.ops.fmm import tree as tree_mod

    pts = rbfi.points
    center, radius = tree_mod.calculate_tree_center_and_radius(
        np.concatenate([pts.min(axis=0), pts.max(axis=0)]))
    octree = tree_mod.build_tree(pts, center, radius,
                                 rbfi.params.fmm_params.max_points_per_cell, False, 3, True)
    ref = copy.copy(octree)
    t0 = time.perf_counter()
    tree_mod._build_interaction_lists(octree)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_mod._build_interaction_lists_numpy(ref)
    numpy_s = time.perf_counter() - t0
    ref_v = ref.v_pairs[ref.has_points[ref.v_pairs[:, 1]]]
    rows = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    same = (np.array_equal(octree.u_pairs, ref.u_pairs)
            and np.array_equal(octree.w_pairs, ref.w_pairs)
            and np.array_equal(rows(octree.v_pairs), rows(ref_v)))
    log(f"phase 7: interaction lists of the fit's octree ({octree.num_cells} cells; u "
        f"{octree.u_pairs.shape[0]}, v {octree.v_pairs.shape[0]}, w {octree.w_pairs.shape[0]} "
        f"pairs): native {native_s:.3f} s, numpy {numpy_s:.3f} s; equal: {same}")
    if not same:
        raise AssertionError("the native and numpy interaction lists differ")


def phase_config4(frt, nf, timing, dev, n=1_000_000):
    """Config 4: the 1M-point LinearRbf signed-distance fit, default Params."""
    from ferreus_rbf_tpu_torch.ops.fmm import api

    pts, sd = synthetic_sd(n, seed=11)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = timing.enable_global_tracer()
    nf.reset_launches()
    t0 = time.perf_counter()
    with LegCounter(api) as legs:
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
    log(f"phase 7: fit launches {json.dumps(launches)} (per leg {json.dumps(legs.calls)}); "
        f"fit peak device memory {fit_peak_gb:.3f} GB")
    log(f"phase 7: solver path {json.dumps(solver_path(tracer, fit_s, fit_peak_gb))}")
    time_fit_legs(nf, rbfi.interpolant_settings.kernel_params(), legs)
    del legs
    list_builders(rbfi)

    vals = rbfi.point_values[:, 0]
    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    eval_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    log(f"phase 7: evaluate_at_source stages (s) "
        f"{json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
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


def phase_gate(nf, dev, rbfi, label="phase 8"):
    """The node-tile gate: a default tree and a forced-gated one over a fit's
    points and weights (phase 7's at 1M; phase 11's 2-D fit). Returns H4's
    kernel-line entries."""
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
        raise RuntimeError(f"unset {GATE_ENV}: {label} compares the default gate with 0")
    ungated, t_u = build()
    os.environ[GATE_ENV] = "0"
    try:
        gated, t_g = build()
    finally:
        del os.environ[GATE_ENV]
    budget = 1.5e9
    log(f"{label}: trees built in {t_u:.3f} s (default gate) and {t_g:.3f} s (gate 0); "
        f"w-list cells {ungated.m2p_cells}, node-tile bytes {ungated.nodetile_bytes} "
        f"(saved when gated), default gate fired: {ungated._m2p_tiles_gated}; at this "
        f"density the gate would fire unforced near N = {n * budget / ungated.nodetile_bytes:.4g} "
        f"(linear in N)")
    if ungated._m2p_tiles_gated or not gated._m2p_tiles_gated:
        raise AssertionError(f"{label} needs one ungated and one gated tree")

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
    same = [torch.equal(a, b) for a, b in zip(out["gated"], out["ungated"])]
    # the ungated tree against itself after a second upward and downward pass
    ungated._multipole = None
    again = [torch.as_tensor(x) for x in ungated.evaluate_with_gradients(w, pts[idx])]
    noise = [rel_err(a, b) for a, b in zip(again, out["ungated"][2:])]
    repeat = all(torch.equal(a, b) for a, b in zip(again, out["ungated"][2:]))
    log(f"{label}: gated vs ungated, bitwise equal (f32 matvec, f64 matvec, values and "
        f"gradients at 4,096 sources): {same}, apart by {[f'{e:.3e}' for e in errs]}; the "
        f"ungated tree against itself after a second upward and downward pass, bitwise "
        f"equal: {repeat} (values {noise[0]:.3e}, gradients {noise[1]:.3e})")
    log(f"{label}: gated vs ungated f64 matvec bitwise equal: {same[1]}")
    log(f"{label}: launches ungated {json.dumps(launches['ungated'])}; "
        f"gated {json.dumps(launches['gated'])}")
    cells = ("near_field_cells_f32", "near_field_cells_f64", "near_field_cells_grad_f64")
    if not all(launches["gated"][k] > 0 for k in cells):
        raise AssertionError(f"H4 never launched on the gated tree: {launches['gated']}")
    if any(launches["ungated"][k] for k in cells):
        raise AssertionError(f"H4 launched on the ungated tree: {launches['ungated']}")
    if not (all(same) and repeat):
        raise AssertionError(f"gated vs ungated not bitwise equal: {errs}; repeat {noise}")

    # H4 on the gated M2P operands, against its plain version on the same
    # operands (all rows, in the plain version's row chunks) and against the
    # ungated M2P leg (H1/H2/H3 on the stored node tiles) on the same tree;
    # the 256 rows with the longest w-lists show how much the tail weighs
    binned, ub = gated._target_cache["src"], ungated._target_cache["src"]
    t = binned[torch.float64]["tpts"].shape[1]
    tlive = binned["tcnt"]
    slive = torch.full((gated.tree.num_cells + 1,), gated.nnodes, device=dev)
    slive[-1] = 0
    sel = torch.argsort(binned["wcnt"], descending=True)[:256]
    log(f"{label}: w-list cells per row: max {int(binned['wcnt'].max())}, mean over rows "
        f"{float(binned['wcnt'].double().mean()):.2f}, rows {binned['wcnt'].shape[0]}")
    entries = {}
    for name, dtype, grad in (("near_field_cells_f32", torch.float32, False),
                              ("near_field_cells_f64", torch.float64, False),
                              ("near_field_cells_grad_f64", torch.float64, True)):
        tpts = gated._binned_floats(binned, dtype)["tpts"]
        # the gated tree's expansions, bit for bit the ungated tree's (above)
        mult = gated._multipole.to(dtype)
        ops = (tpts, binned["wtab"], binned["wcnt"], *gated._cell_geometry(), mult)
        leg = (ungated._binned_floats(ub, dtype)["tpts"], ungated._floats(dtype)["node_tiles"],
               ungated._m2p_tiles(mult), ub["wtab"], ub["wcnt"])
        chunk = (tpts[sel].contiguous(), binned["wtab"][:, sel].contiguous(),
                 binned["wcnt"][sel].contiguous(), *ops[3:])
        tc = {"tcnt": binned["tcnt"]}
        chunk_tc = {"tcnt": binned["tcnt"][sel].contiguous()}
        h4 = nf.near_field_cells_grad if grad else nf.near_field_cells
        h123 = nf.near_field_grad if grad else nf.near_field
        plain = nf.near_field_cells_grad_plain if grad else nf.near_field_cells_plain
        rel, absd = cells_vs_plain(nf, kp, ops, grad, **tc)
        held = rel
        if dtype == torch.float32:
            # a row sums (w-list cells x p^d) f32 terms, tens of thousands
            # at 1M, and two summation orders differ in proportion to the
            # sum of |terms|, not to |sum|: the f32 check is held against
            # that scale (phi = -r keeps one sign here, so the plain version
            # on |mult| gives it up to sign)
            held = absd / float(plain(*ops[:-1], mult.abs(), kparams=kp, **tc).abs().max())
        if not held <= TOL[dtype]:
            raise AssertionError(f"{name} vs plain on the gated M2P: {held:.3e}")
        ms = cuda_ms(lambda: h4(*ops, kparams=kp, **tc))
        leg_ms = cuda_ms(lambda: h123(*leg, kparams=kp, tcnt=ub["tcnt"]))
        # the same items in the same order with the same arithmetic: H4 on
        # the cell table gives the ungated leg's sums bit for bit
        got, other = h4(*ops, kparams=kp, **tc), h123(*leg, kparams=kp, tcnt=ub["tcnt"])
        bitwise = all(torch.equal(a, b) for a, b in
                      (zip(got, other) if grad else ((got, other),)))
        chunk_ms = cuda_ms(lambda: h4(*chunk, kparams=kp, **chunk_tc))
        plain_ms = cuda_ms(lambda: plain(*ops, kparams=kp, **tc), reps=1)
        bound_ms, bound_by, flops = near_field_bound(kp, ops, tlive, slive, grad,
                                                     nrhs=mult.shape[2])
        pairs = float((binned["wcnt"].double() * tlive.double()).sum()) * gated.nnodes
        log(f"{label}: {name} gated M2P with live target counts, rows {tpts.shape[0]}: "
            f"kernel {ms:.4f} ms ({pairs / (ms * 1e-3) / 1e9:.1f} live Gpair/s, "
            f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {bound_ms:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.4f} ms, max |diff| {absd:.3e}: {rel:.3e} of max |out|, "
            f"{held:.3e} of the scale held (bound {TOL[dtype]:.0e}); ungated M2P leg "
            f"({'H3' if grad else 'H1' if dtype == torch.float32 else 'H2'}) {leg_ms:.4f} ms, "
            f"gated / ungated {ms / leg_ms:.3f}, bitwise equal to it: {bitwise}; the "
            f"{sel.numel()} longest rows alone: kernel {chunk_ms:.4f} ms, {chunk_ms / ms:.2%} "
            f"of the whole")
        if not bitwise:
            raise AssertionError(f"{name} on the gated M2P is not bitwise the ungated leg")
        entries[name] = kernel_entry(name, launches["gated"][name],
                                     {"abs": absd, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound_ms, "bound_by": bound_by})
    return entries


def phase_trend(frt, nf, timing, dev):
    """Phase 9: global trends, model I/O, the builder and ``bbfmm`` on the
    albatite dataset (the steps are listed in the module's docstring)."""
    from ferreus_rbf_tpu_torch import bbfmm
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType, make_kernel

    pts, vals = frt.csv_to_point_arrays(
        os.path.join(HERE, "datasets", "albatite_SD_points.csv"), has_headers=True)
    vals = vals.reshape(-1)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = float(np.max(hi - lo))
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    trend = frt.GlobalTrend.three(dip=30.0, dip_direction=45.0, pitch=0.0, major_ratio=2.0,
                                  semi_major_ratio=1.5, minor_ratio=1.0)

    # (a) the fit through the builder
    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nf.reset_launches()
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator.builder(pts, vals, settings, device=dev).global_trend(trend).build()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    fit_launches = dict(nf.LAUNCHES)
    done = [e for e in tracer.events if e["event"] == "solve_done"]
    solver_res = done[-1]["residual"]
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    eval_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(pred - vals))) / float(np.max(np.abs(vals)))
    log(f"phase 9a: albatite fit under GlobalTrend.three(30, 45, 0, 2.0, 1.5, 1.0), "
        f"LinearRbf, through the builder: {fit_s:.3f} s, n {rbfi.points.shape[0]}, solver "
        f"l2 residual {solver_res:.3e} (bound 1e-6), refinement rounds "
        f"{sum(e['event'] == 'refine_round' for e in tracer.events)}; evaluate_at_source "
        f"{eval_s:.3f} s, max residual / max|vals| {rel:.3e} (bound 1e-4)")
    log(f"phase 9a: fit stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    log(f"phase 9a: fit launches {json.dumps(fit_launches)}")
    path = solver_path(tracer, fit_s, torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"phase 9a: solver path {json.dumps(path)}")
    if not solver_res <= 1e-6:
        raise AssertionError(f"trend fit solver residual {solver_res:.3e}")
    if not (pred.shape == vals.shape and rel < 1e-4):
        raise AssertionError(f"trend fit source residual {rel:.3e}")
    if not (fit_launches["near_field_f32"] > 0 and fit_launches["near_field_f64"] > 0):
        raise AssertionError(f"H1 or H2 never launched in the trend fit: {fit_launches}")

    # (b) gradients on the 64^3 grid against a dense f64 gradient
    grid = frt.create_evaluation_grid(list(zip(lo, hi)), [64, 64, 64])
    torch.cuda.synchronize()
    nf.reset_launches()
    t0 = time.perf_counter()
    gv, gg = rbfi.evaluate_with_gradients(grid)
    grad_s = time.perf_counter() - t0
    grad_launches = dict(nf.LAUNCHES)
    sub = np.sort(np.random.default_rng(4).choice(grid.shape[0], 1024, replace=False))
    dense = dense_gradients(rbfi, grid[sub], dev)
    grad_err = float(np.max(np.abs(gg[sub] - dense))) / float(np.max(np.abs(dense)))
    log(f"phase 9b: 64^3 grid evaluate_with_gradients under the trend {grad_s:.3f} s; "
        f"gradients vs dense f64 through the trend's Jacobian on 1,024 grid points "
        f"{grad_err:.3e} of max |grad| (bound {ALBATITE_GRAD_BOUND:.0e}); launches "
        f"{json.dumps(grad_launches)}")
    if gg.shape != (64**3, 3) or not (np.isfinite(gg).all() and np.isfinite(gv).all()):
        raise AssertionError("trend grid gradients not finite or of the wrong shape")
    if not grad_err <= ALBATITE_GRAD_BOUND:
        raise AssertionError(f"trend gradients vs dense: {grad_err:.3e}")
    if not grad_launches["near_field_grad_f64"] > 0:
        raise AssertionError(f"H3 never launched in the trend gradients: {grad_launches}")

    # (c) save, load on the card, and evaluate bit for bit
    values = rbfi.evaluate(grid)
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "albatite_trend.json")
        t0 = time.perf_counter()
        rbfi.save_model(path)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        loaded = frt.RBFInterpolator.load_model(path, device=dev)
        load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv = loaded.evaluate(grid)
    lv_s = time.perf_counter() - t0
    lgv, lgg = loaded.evaluate_with_gradients(grid)
    same = [np.array_equal(lv, values), np.array_equal(lgv, gv), np.array_equal(lgg, gg)]
    log(f"phase 9c: save_model {save_s:.3f} s ({size_mb:.3f} MB), load_model {load_s:.3f} s; "
        f"the loaded model's 64^3 evaluate {lv_s:.3f} s; bitwise equal to the fitted "
        f"model's (values, gradient-pass values, gradients): {same}")
    if not all(same):
        raise AssertionError(
            f"the loaded model differs: values {np.max(np.abs(lv - values)):.3e}, gradients "
            f"{np.max(np.abs(lgg - gg)):.3e}")
    del loaded, lv, lgv, lgg

    # (d) the isosurface under the trend
    phase_isosurface(frt, nf, timing, rbfi, pts, span, label="phase 9d")

    # (e) the standalone bbfmm module: the Laplacian over the albatite points
    rng = np.random.default_rng(9)
    w = rng.standard_normal((pts.shape[0], 2))
    targets = grid[np.sort(rng.choice(grid.shape[0], 1024, replace=False))]
    torch.cuda.synchronize()
    nf.reset_launches()
    t0 = time.perf_counter()
    tree = bbfmm.FmmTree(pts, 5, bbfmm.KernelParams(bbfmm.FmmKernelType.Laplacian),
                         adaptive_tree=True, sparse=False, device=dev)
    tree.set_weights(w)
    got_v = tree.evaluate(w, targets)
    got_gv, got_g = tree.evaluate_with_gradients(w, targets)
    tree.set_local_coefficients(w)
    leaves = tree.evaluate_leaves(w, targets)
    torch.cuda.synchronize()
    bb_s = time.perf_counter() - t0
    bb_launches = dict(nf.LAUNCHES)
    kernel = make_kernel(KernelParams(KernelType.Laplacian))
    src = torch.as_tensor(pts, device=dev)
    tg = torch.as_tensor(targets, device=dev)
    wd = torch.as_tensor(w, device=dev)
    want_v = dense_matvec(kernel, tg, src, wd).cpu().numpy()
    want_g = torch.cat([
        torch.einsum("mnd,nr->mrd", kernel.pair_with_grad(tg[c : c + 256], src)[1],
                     wd).flatten(1)
        for c in range(0, tg.shape[0], 256)]).cpu().numpy()
    v_err = float(np.max(np.abs(got_v - want_v)) / np.max(np.abs(want_v)))
    gv_err = float(np.max(np.abs(got_gv - want_v)) / np.max(np.abs(want_v)))
    g_err = float(np.max(np.abs(got_g - want_g)) / np.max(np.abs(want_g)))
    leaves_same = np.array_equal(leaves, got_v)
    log(f"phase 9e: bbfmm Laplacian, p = 5, 2 RHS over {pts.shape[0]} albatite points, "
        f"1,024 grid targets, {bb_s:.3f} s: evaluate vs dense f64 {v_err:.3e}, "
        f"evaluate_with_gradients values {gv_err:.3e}, gradients {g_err:.3e} of max |want| "
        f"(bound {BBFMM_BOUND:.0e}); evaluate_leaves after set_local_coefficients bitwise "
        f"equal to evaluate: {leaves_same}; launches {json.dumps(bb_launches)}")
    if got_v.shape != (1024, 2) or got_g.shape != (1024, 6):
        raise AssertionError("bbfmm results of the wrong shape")
    if not max(v_err, gv_err, g_err) < BBFMM_BOUND:
        raise AssertionError(f"bbfmm Laplacian vs dense: {v_err:.3e}, {gv_err:.3e}, {g_err:.3e}")
    if not leaves_same:
        raise AssertionError("bbfmm evaluate_leaves is not bitwise evaluate")
    if not (bb_launches["near_field_f64"] > 0 and bb_launches["near_field_grad_f64"] > 0):
        raise AssertionError(f"H2 or H3 never launched in bbfmm: {bb_launches}")


SHARD_DIR = os.path.join(HERE, "build", "phase10")
# a rank that waits this long on a collective fails; the phase's own limit
SHARD_TIMEOUT_S = 300


def same_on_every_rank(t, group):
    """True on every rank when ``t`` has the same values on every rank
    (elementwise max and min over the ranks agree; -0.0 equals 0.0)."""
    import torch.distributed as dist

    hi, lo = t.detach().cpu().clone(), t.detach().cpu().clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))


def coefficient_array(c, part):
    """A fit's point or poly coefficients as an array (empty without a
    drift)."""
    a = getattr(c, f"{part}_coefficients")
    return np.zeros(0) if a is None else np.asarray(a)


def albatite_data(frt):
    """Phase 4's data and settings: (points, values, span, settings)."""
    pts, vals = frt.csv_to_point_arrays(
        os.path.join(HERE, "datasets", "albatite_SD_points.csv"), has_headers=True)
    vals = vals.reshape(-1)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0, total_sill=span / 4.0,
    )
    return pts, vals, span, settings


def shard_rank(rank, world, backend, refs_path):
    """One rank of phase 10 (its steps are in :func:`phase_sharded`); writes
    ``rank<r>.json`` beside ``refs_path``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch import parallel
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod
    from ferreus_rbf_tpu_torch.utils import timing

    dist.init_process_group(backend, init_method=f"file://{SHARD_DIR}/init", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    mesh = parallel.make_mesh(world, device_type="cuda", backend=backend)
    dev = mesh.device
    host_group = dist.new_group(backend="gloo")  # the checks' own collectives
    rec = {"rank": rank, "device": str(dev), "card": torch.cuda.get_device_name(dev)}

    def matvecs(one, sharded, weights, key, tag):
        """f32 and f64: bit for bit one rank, the same on every rank; the
        kernels' launches of the sharded pair."""
        nf.reset_launches()
        got = {prec: sharded.evaluate_device(weights, key, prec) for prec in ("f32", "f64")}
        torch.cuda.synchronize(dev)
        rec[f"{tag}_launches"] = {k: v for k, v in nf.LAUNCHES.items() if v}
        for prec, v in got.items():
            want = one.evaluate_device(weights, key, prec)
            rec[f"{tag}_{prec}"] = {"one_rank": bool(torch.equal(v, want)),
                                    "every_rank": same_on_every_rank(v, host_group),
                                    "finite": bool(torch.isfinite(v).all())}
        rec[f"{tag}_shares"] = sharded.shares(key)

    # (a) config 2's matvec (phase 3's tree)
    torch.cuda.reset_peak_memory_stats(dev)
    n, nrhs, p = 100_000, 8, 5
    rng = np.random.default_rng(42)
    pts = rng.random((n, 3))
    w = torch.as_tensor(rng.standard_normal((n, nrhs)), device=dev)
    params = frt.FmmParams(interpolation_order=p, max_points_per_cell=256,
                           compression_type=frt.FmmCompressionType.ACA, epsilon=10.0**-p)
    kp = KernelParams(KernelType.LinearRbf)
    trees = []
    for mesh_or_none in (None, mesh):
        with parallel.use_mesh(mesh_or_none) if mesh_or_none else contextlib.nullcontext():
            tree = FmmTree(pts, p, kp, adaptive_tree=False, sparse=True, params=params,
                           device=dev)
        tree.prepare_targets(pts, "src")
        trees.append(tree)
    matvecs(*trees, w, "src", "config2")
    rec["config2_ms"] = {prec: synced_median(lambda: trees[1].evaluate_device(w, "src", prec))
                         * 1e3 for prec in ("f32", "f64")}
    rec["config2_peak_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9, 4)
    del trees, w

    # (b) the albatite fit under the mesh, fused and on the host loop
    pts, vals, _, settings = albatite_data(frt)
    refs = np.load(refs_path)
    kept = []
    init = ddm_mod.DDMTree.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        kept.append(self)

    fits = {}
    for path in ("fused", "host"):
        if path == "host":
            os.environ[FUSED_ENV] = "0"
        tracer = timing.enable_global_tracer()
        ddm_mod.DDMTree.__init__ = keep
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        nf.reset_launches()
        t0 = time.perf_counter()
        try:
            with parallel.use_mesh(mesh):
                fit = frt.RBFInterpolator(pts, vals, settings)
            torch.cuda.synchronize(dev)
        finally:
            os.environ.pop(FUSED_ENV, None)
            ddm_mod.DDMTree.__init__ = init
            timing.disable_global_tracer()
        fit_s = time.perf_counter() - t0
        tree = kept.pop()
        c = fit.coefficients
        ev = {e["event"]: e for e in tracer.events}  # rank 0 only
        fits[path] = {
            "fit_s": round(fit_s, 4),
            "solve_column_s": round(tracer.totals.get("solve_column", 0.0), 4),
            "stages_s": {k: round(v, 3) for k, v in tracer.totals.items()},
            "one_rank": [bool(np.array_equal(coefficient_array(c, part), refs[f"{path}_{part}"]))
                         for part in ("point", "poly")],
            "residual": ev["solve_done"]["residual"] if "solve_done" in ev else None,
            "fused_solve": ev.get("fused_solve"),
            "fused_system": ev.get("fused_system"),
            "factor_mb_rank": round(tree.factor_bytes_rank / 2**20, 3),
            "factor_mb_all": round(tree.factor_bytes / 2**20, 3),
            "domains": [tree.domains_rank, tree.domains],
            "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 4),
            "launches": {k: v for k, v in nf.LAUNCHES.items() if v},
        }
        del tree
    rec["albatite"] = fits

    # (c) the gate forced on the albatite tree (M2P on H4)
    torch.cuda.reset_peak_memory_stats(dev)
    gate = os.environ.get(GATE_ENV)
    os.environ[GATE_ENV] = "0"
    try:
        trees = []
        for mesh_or_none in (None, mesh):
            with parallel.use_mesh(mesh_or_none) if mesh_or_none else contextlib.nullcontext():
                tree = FmmTree(fit.points, fit.params.fmm_params.interpolation_order,
                               settings.kernel_params(), adaptive_tree=True, sparse=True,
                               params=fit.params.fmm_params, device=dev)
            tree.prepare_targets(fit.points, "__all__")
            trees.append(tree)
    finally:
        if gate is None:
            os.environ.pop(GATE_ENV)
        else:
            os.environ[GATE_ENV] = gate
    rec["gated"] = [t._m2p_tiles_gated for t in trees]
    wd = torch.as_tensor(fit.coefficients.point_coefficients, device=dev)
    matvecs(*trees, wd, "__all__", "albatite_gated")
    rec["peak_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9, 4)
    with open(os.path.join(SHARD_DIR, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    dist.barrier(group=host_group)
    dist.destroy_process_group()


def run_ranks(fn, world, args, limit_s):
    """Start ``world`` ranks of ``fn(rank, world, *args)`` with the spawn
    method and wait for them; a rank that fails or runs past ``limit_s``
    fails the run, and no rank outlives it."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + limit_s
    try:
        while not ctx.join(timeout=1):  # raises when a rank fails
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran past {limit_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def phase_sharded(dev, refs, config2_ms=None):
    """Phase 10, the sharded path on the card: ``min(4, cards)`` ranks over
    NCCL with two or more cards, else two ranks sharing ``cuda:0`` over
    gloo. Under ``parallel.use_mesh`` they drive (a) config 2's matvec
    (phase 3's tree) at f32 and f64, bit for bit a one-rank matvec of the
    same tree and the same on every rank, timed per rank (median of 5);
    (b) the albatite fit on the fused path and with
    ``FERREUS_RBF_TPU_FUSED=0``, each converged with coefficients bit for
    bit ``refs`` (the one-rank fits on the same paths: phase 4's); (c) the
    albatite tree with the gate forced: f32 and f64 bit for bit one rank,
    H4 launched on every rank. Logs each rank's launches of H1, H2 and H4,
    its share of leaves, M2L slots, rows and Schwarz domains, its factor
    bytes and its peak device memory."""
    cards = torch.cuda.device_count()
    world, backend = (min(4, cards), "nccl") if cards >= 2 else (2, "gloo")
    t0 = time.perf_counter()
    os.makedirs(SHARD_DIR, exist_ok=True)
    for name in os.listdir(SHARD_DIR):
        os.remove(os.path.join(SHARD_DIR, name))
    refs_path = os.path.join(SHARD_DIR, "refs.npz")
    np.savez(refs_path, **{f"{k}_{part}": coefficient_array(c, part)
                           for k, c in refs.items() for part in ("point", "poly")})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 10: {world} ranks over {backend} on {cards} card(s) "
        f"({'one card per rank' if backend == 'nccl' else 'every rank on cuda:0'})")
    run_ranks(shard_rank, world, (backend, refs_path), 2 * SHARD_TIMEOUT_S)
    recs = []
    for r in range(world):
        with open(os.path.join(SHARD_DIR, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    for rec in recs:
        rank = rec["rank"]
        log(f"phase 10 rank {rank} ({rec['device']}, {rec['card']}): config 2 f32 "
            f"{json.dumps(rec['config2_f32'])}, f64 {json.dumps(rec['config2_f64'])}; median "
            f"matvec (ms) {json.dumps({k: round(v, 3) for k, v in rec['config2_ms'].items()})}; "
            f"launches {json.dumps(rec['config2_launches'])}; shares (owned, total) "
            f"{json.dumps(rec['config2_shares'])}; peak device memory "
            f"{rec['config2_peak_gb']} GB")
        for path, fit in rec["albatite"].items():
            log(f"phase 10 rank {rank}: albatite fit, {path} path {json.dumps(fit)}")
        log(f"phase 10 rank {rank}: albatite tree gated {rec['gated']}: f32 "
            f"{json.dumps(rec['albatite_gated_f32'])}, f64 "
            f"{json.dumps(rec['albatite_gated_f64'])}; launches "
            f"{json.dumps(rec['albatite_gated_launches'])}; shares "
            f"{json.dumps(rec['albatite_gated_shares'])}; peak device memory "
            f"{rec['peak_gb']} GB")
    if config2_ms is not None:
        worst = {prec: max(rec["config2_ms"][prec] for rec in recs) for prec in ("f32", "f64")}
        log(f"phase 10: config-2 sharded matvec, slowest rank's median (ms) "
            f"{json.dumps({k: round(v, 3) for k, v in worst.items()})} against one rank in "
            f"phase 3 {json.dumps({k: round(v, 3) for k, v in config2_ms.items()})}"
            + ("; ranks that share one card cannot be faster than one rank, and gloo moves "
               "each pass's shares through the host" if backend == "gloo" else ""))
    checks = [rec[f"{tag}_{prec}"][k] for rec in recs
              for tag in ("config2", "albatite_gated") for prec in ("f32", "f64")
              for k in ("one_rank", "every_rank", "finite")]
    if not all(checks):
        raise AssertionError("a sharded matvec is not bit for bit one rank's on every rank")
    for rec in recs:
        if not (rec["gated"] == [True, True]
                and rec["albatite_gated_launches"].get("near_field_cells_f32", 0) > 0
                and rec["albatite_gated_launches"].get("near_field_cells_f64", 0) > 0):
            raise AssertionError(f"rank {rec['rank']}: H4 did not launch on the gated tree")
        for path, fit in rec["albatite"].items():
            if not all(fit["one_rank"]):
                raise AssertionError(f"rank {rec['rank']}: the sharded {path} fit is not bit "
                                     f"for bit the one-rank fit")
    lead = recs[0]["albatite"]
    if not all(lead[path]["residual"] is not None and lead[path]["residual"] <= 1e-6
               for path in ("fused", "host")):
        raise AssertionError(f"a sharded albatite fit did not converge: {lead}")
    if lead["fused"]["fused_system"] is None or not lead["fused"]["fused_system"]["ok"]:
        raise AssertionError("the sharded fused fit did not take the fused path")
    for part in ("leaves", "m2l_slots", "rows"):
        if sum(rec["config2_shares"][part][0] for rec in recs) != recs[0]["config2_shares"][part][1]:
            raise AssertionError(f"config-2 {part}: the ranks' shares do not cover the pass")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")


# the mangled name of near_field_work_items_kernel<KT, T, NR, GRAD, CELLS>
# phase 11: the 2-D and 1-D cells, and the examples
DIMS_BOUND = 1e-4  # evaluate_at_source and the dense oracle, relative to max |values|
DIMS_GRAD_BOUND = 1e-3  # gradients (p >= 7) against a dense f64 gradient
# The JAX example's lines (examples/boundary_closure.py on the CPU): its RMT
# is host numpy in both packages, so the port must print them exactly. Its
# seed, (1, 0, 0), lies outside the clip box (x <= 0.6), so every mode
# extracts an empty mesh.
BOUNDARY_CLOSURE_LINES = [
    "          None: V=   0 F=   0 watertight=True volume=  0.0000",
    " ClosePositive: V=   0 F=   0 watertight=True volume=  0.0000",
    " CloseNegative: V=   0 F=   0 watertight=True volume=  0.0000",
]
# franke_2d's two errors; the JAX example printed 3.501e-08 and 4.038e-03
# on the CPU
FRANKE_BOUNDS = (1e-6, 1e-2)
# (example, a line its JAX counterpart prints; tests/test_examples.py)
EXAMPLES = (
    ("isosurface_sphere", "sphere mesh: 540 vertices, 1076 facets"),
    ("boundary_closure", "V="),
    ("franke_2d", "max residual at sources"),
    ("isosurface_linear", "vertices"),
    ("isosurface_linear_rmt", "vertices"),
    ("isosurface_linear_topo", "clipped below topography"),
    ("isosurface_spheroidal", "vertices"),
    ("isosurface_spheroidal_drift", "poly coefficients"),
    ("isosurface_trend_linear", "vertices"),
)


def dims_fit(frt, nf, timing, dev, label, pts, vals, settings):
    """One fit of phase 11, twice in this process: the second must repeat
    the first's bits. Checks the solver's residual, ``evaluate_at_source``
    and a dense f64 oracle at 1,024 sources; logs seconds, stages, DDM
    levels, FMM trees, per-leg launches and peak device memory. Returns
    the fit and its tracer."""
    from ferreus_rbf_tpu_torch.ops.fmm import api

    fits = []
    for run in ("first", "again"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        tracer = timing.enable_global_tracer()
        nf.reset_launches()
        t0 = time.perf_counter()
        try:
            with LegCounter(api) as legs:
                rbfi = frt.RBFInterpolator(pts, vals, settings, device=dev)
                torch.cuda.synchronize()
        finally:
            timing.disable_global_tracer()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"{label}: fit ({run}) {json.dumps(solver_path(tracer, fit_s, peak))}")
        log(f"{label}: fit ({run}) launches {json.dumps(dict(nf.LAUNCHES))} (per leg "
            f"{json.dumps(legs.calls)})")
        fits.append((rbfi, tracer))
        del legs
    (rbfi, tracer), (again, _) = fits
    same = [np.array_equal(coefficient_array(again.coefficients, k),
                           coefficient_array(rbfi.coefficients, k)) for k in ("point", "poly")]
    del again, fits
    strip = lambda e: {k: v for k, v in e.items() if k != "event"}  # noqa: E731
    events = tracer.events
    done = [e for e in events if e["event"] == "solve_done"][-1]
    log(f"{label}: fit stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    for name in ("ddm_level", "fmm_tree"):
        log(f"{label}: {name} {json.dumps([strip(e) for e in events if e['event'] == name])}")
    log(f"{label}: the second fit repeats the first's bits (point, poly): {same}")

    vals = rbfi.point_values[:, 0]
    t0 = time.perf_counter()
    pred = rbfi.evaluate_at_source(add_nugget=True)
    eval_s = time.perf_counter() - t0
    scale = float(np.max(np.abs(vals)))
    rel = float(np.max(np.abs(pred - vals))) / scale
    idx = np.sort(np.random.default_rng(3).choice(vals.size, 1024, replace=False))
    oracle = dense_oracle(rbfi, idx, dev)
    value_err = float(np.max(np.abs(pred[idx] - oracle))) / float(np.max(np.abs(oracle)))
    true_res = float(np.max(np.abs(oracle - vals[idx]))) / scale
    log(f"{label}: evaluate_at_source {eval_s:.3f} s, max residual / max|vals| {rel:.3e}; "
        f"dense f64 oracle on 1,024 sources: evaluation vs oracle {value_err:.3e}, oracle "
        f"residual {true_res:.3e} (bounds {DIMS_BOUND:.0e})")
    if not (done["converged"] and done["residual"] <= 1e-6):
        raise AssertionError(f"{label}: solver residual {done['residual']:.3e}, converged "
                             f"{done['converged']}")
    if not all(same):
        raise AssertionError(f"{label}: a second fit does not repeat the first's bits")
    if not (pred.shape == vals.shape and np.isfinite(pred).all() and rel < DIMS_BOUND):
        raise AssertionError(f"{label}: source residual {rel:.3e}")
    if not (value_err < DIMS_BOUND and true_res < DIMS_BOUND):
        raise AssertionError(f"{label}: oracle: evaluation {value_err:.3e}, residual {true_res:.3e}")
    return rbfi, tracer


def time_dims_legs(nf, rbfi, dev, label, grad):
    """H1 and H2 (and H3 when ``grad``) timed on the legs of a tree over a
    phase-11 fit's points (the fit's FMM parameters, its sources as the
    targets, 1 RHS), against the plain version (one checking call each;
    f32 held against the sum of |terms|), with live pair rates to set
    beside phase 4's 3-D albatite legs."""
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

    fp = rbfi.params.fmm_params
    kp = rbfi.interpolant_settings.kernel_params()
    tree = FmmTree(rbfi.points, fp.interpolation_order, kp, adaptive_tree=True, sparse=True,
                   params=fp, device=dev)
    tree.prepare_targets(rbfi.points, "__all__")
    g = torch.Generator(device="cpu").manual_seed(2)
    kernels = [("near_field_f32", torch.float32, False), ("near_field_f64", torch.float64, False)]
    for name, dtype, as_grad in kernels + ([("near_field_grad_f64", torch.float64, True)]
                                           if grad else []):
        legs = tree_legs(tree, "__all__", dtype, 1, g, with_p2l=not as_grad)
        log_near_field(label, name, {
            leg: time_leg(nf, kp, dtype, *ops, grad=as_grad, f32_scale=dtype == torch.float32,
                          plain_reps=0)
            for leg, ops in legs.items()})


def phase_dims(frt, nf, timing, dev):
    """Phase 11 (a, b): the 2-D fit with its 512^2 grid, gradients and
    gated tree, and the 1-D fit with its 65,536-point evaluation."""
    from ferreus_rbf_tpu_torch.ops.fmm import api

    # (a) 2-D: Franke's function, ThinPlateSpline, default Params
    pts = frt.generate_random_points(250_000, 2, seed=42)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    label = "phase 11: 2-D"
    rbfi, _ = dims_fit(frt, nf, timing, dev, label, pts, vals, settings)
    side = 512
    grid = frt.create_evaluation_grid([(0.0, 1.0), (0.0, 1.0)], [side, side])
    t0 = time.perf_counter()
    grid_vals = rbfi.evaluate(grid)
    grid_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nf.reset_launches()
    t0 = time.perf_counter()
    with LegCounter(api, "near_field_grad") as grad_legs:
        gv, gg = rbfi.evaluate_with_gradients(grid)
        torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = dict(nf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    sub = np.sort(np.random.default_rng(4).choice(grid.shape[0], 1024, replace=False))
    dense = dense_gradients(rbfi, grid[sub], dev)
    val_err = rel_err(torch.as_tensor(gv), torch.as_tensor(grid_vals))
    grad_err = float(np.max(np.abs(gg[sub] - dense))) / float(np.max(np.abs(dense)))
    franke = float(np.max(np.abs(grid_vals - frt.RBFTestFunctions.franke_2d(grid))))
    log(f"{label}: {side}^2 grid evaluate {grid_s:.3f} s (max error vs Franke's function "
        f"{franke:.3e}); evaluate_with_gradients {grad_s:.3f} s ({grad_s / grid_s:.3f}x "
        f"value-only), peak device memory {peak:.3f} GB; values vs evaluate {val_err:.3e} "
        f"(bound 1e-12); gradients vs dense f64 on 1,024 grid points {grad_err:.3e} of max "
        f"|grad| (bound {DIMS_GRAD_BOUND:.0e}); launches {json.dumps(grad_launches)} (per leg "
        f"{json.dumps(grad_legs.calls)})")
    h3_launch_time(nf, settings.kernel_params(), grad_legs, grad_s,
                   f"{label}: {side}^2 evaluate_with_gradients")
    del grad_legs
    if not (grid_vals.shape == (side * side,) and np.isfinite(grid_vals).all()
            and gg.shape == (side * side, 2) and np.isfinite(gg).all()):
        raise AssertionError(f"{label}: grid values or gradients not finite or misshapen")
    if not (val_err <= 1e-12 and grad_err <= DIMS_GRAD_BOUND):
        raise AssertionError(f"{label}: gradients: values {val_err:.3e}, grads {grad_err:.3e}")
    if not grad_launches["near_field_grad_f64"] > 0:
        raise AssertionError(f"{label}: H3 never launched in the gradients: {grad_launches}")
    phase_gate(nf, dev, rbfi, label=f"{label} gate")
    time_dims_legs(nf, rbfi, dev, label, grad=True)
    del rbfi, gv, gg
    torch.cuda.empty_cache()

    # (b) 1-D: sin(12 x) + 0.3 cos(31 x) on [0, 1], LinearRbf, default Params
    x = np.random.default_rng(5).random((100_000, 1))
    f = np.sin(12 * x[:, 0]) + 0.3 * np.cos(31 * x[:, 0])
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    label = "phase 11: 1-D"
    rbfi, tracer = dims_fit(frt, nf, timing, dev, label, x, f, settings)
    m1 = 65_536
    grid = frt.create_evaluation_grid([(0.0, 1.0)], [m1])
    nf.reset_launches()
    t0 = time.perf_counter()
    grid_vals = rbfi.evaluate(grid)
    grid_s = time.perf_counter() - t0
    want = np.sin(12 * grid[:, 0]) + 0.3 * np.cos(31 * grid[:, 0])
    m2p_cells = [e["m2p_cells"] for e in tracer.events if e["event"] == "fmm_tree"]
    log(f"{label}: {m1}-point evaluate {grid_s:.3f} s, launches "
        f"{json.dumps(dict(nf.LAUNCHES))}, max error vs f {np.max(np.abs(grid_vals - want)):.3e}; "
        f"w-list cells of the fit's trees {m2p_cells}: without w-lists there is no M2P, and "
        f"the node-tile gate has nothing to gate (H4 at d = 1 is held in phase 2)")
    if not (grid_vals.shape == (m1,) and np.isfinite(grid_vals).all()):
        raise AssertionError(f"{label}: grid values not finite or misshapen")
    time_dims_legs(nf, rbfi, dev, label, grad=False)
    del rbfi
    torch.cuda.empty_cache()


def read_obj(path):
    """(vertices, facets) of an OBJ file written by ``Mesh.save_obj``."""
    verts, facets = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                facets.append([int(t) - 1 for t in line.split()[1:4]])
    return np.array(verts, np.float64).reshape(-1, 3), np.array(facets, np.int64).reshape(-1, 3)


def phase_examples(nf, dev):
    """Phase 11 (c): the nine examples on the card, at full size, each in
    this process in a temporary directory, with its printed lines, seconds,
    launches and the checks of every mesh it wrote."""
    import contextlib
    import importlib
    import io

    from ferreus_rbf_tpu_torch.examples.common import load_albatite

    scale = float(np.max(np.abs(load_albatite()[1])))  # the fit residuals' bound: 1e-4 of it
    cwd = os.getcwd()
    for name, expect in EXAMPLES:
        module = importlib.import_module(f"ferreus_rbf_tpu_torch.examples.{name}")
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            buf = io.StringIO()
            torch.cuda.synchronize()
            nf.reset_launches()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    module.main(["--device", str(dev)])
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in nf.LAUNCHES.items() if v}
            out = buf.getvalue()
            meshes = {}
            for fname in sorted(os.listdir(tmp)):
                if fname.endswith(".obj"):
                    verts, facets = read_obj(os.path.join(tmp, fname))
                    meshes[fname] = (verts.shape[0], facets.shape[0],
                                     *mesh_checks(verts, facets, name != "boundary_closure"))
        log(f"phase 11: example {name} {seconds:.3f} s, launches {json.dumps(launches)}; "
            f"meshes (vertices, facets, max facets per edge, boundary edges) "
            f"{json.dumps(meshes)}; printed: {json.dumps(out.rstrip().splitlines()[-4:])}")
        if expect not in out:
            raise AssertionError(f"example {name} did not print {expect!r}:\n{out}")
        if name == "boundary_closure" and out.splitlines() != BOUNDARY_CLOSURE_LINES:
            raise AssertionError(f"boundary_closure printed other lines than the JAX "
                                 f"example:\n{out}")
        if name == "franke_2d":
            errs = [float(re.search(pat + r": (\S+)", out).group(1))
                    for pat in ("max residual at sources", "max grid error vs analytic Franke")]
            if not all(e < b for e, b in zip(errs, FRANKE_BOUNDS)):
                raise AssertionError(f"franke_2d errors {errs}, bounds {FRANKE_BOUNDS}")
        if name.startswith("isosurface_") and name != "isosurface_sphere" and not meshes:
            raise AssertionError(f"example {name} wrote no mesh")
        if name in ("isosurface_linear", "isosurface_spheroidal"):
            resid = float(re.search(r"fit residual: (\S+)", out).group(1))
            if not resid < DIMS_BOUND * scale:
                raise AssertionError(f"example {name}: fit residual {resid:.3e}, bound "
                                     f"{DIMS_BOUND * scale:.3e}")


_ITEM_KERNEL = r"near_field_work_items_kernelILi(\d+)E([fd])Li(\d+)ELb([01])ELb([01])E"
_ITEM_LABELS = {("0", "0"): "H1/H2", ("1", "0"): "H3 grad", ("0", "1"): "H4 cells",
                ("1", "1"): "H4 cells grad"}


def log_ptxas(report):
    """nvcc's ``-Xptxas -v`` report: registers and spill bytes per kernel;
    the work-item kernels' instantiations (kernel type x dtype x NR) summed
    up per (kernel, dtype, NR) over the ten kernel types."""
    stats, entry = {}, "?"
    for line in report.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            stats.setdefault(entry, {})["spill"] = sum(
                int(tok) for tok in re.findall(r"(\d+) bytes spill", line))
        elif "registers" in line:
            stats.setdefault(entry, {})["regs"] = int(re.search(r"Used (\d+) registers",
                                                                line).group(1))
    groups = {}
    for name, st in stats.items():
        m = re.search(_ITEM_KERNEL, name)
        if m is None:
            log(f"phase 1: ptxas {name}: {st.get('regs')} registers, "
                f"{st.get('spill', 0)} bytes of spills")
            continue
        key = (_ITEM_LABELS[(m.group(4), m.group(5))], "f32" if m.group(2) == "f" else "f64", int(m.group(3)))
        groups.setdefault(key, []).append((st.get("regs", 0), st.get("spill", 0)))
    for (label, dtype, nr), vals in sorted(groups.items()):
        regs = [v[0] for v in vals]
        log(f"phase 1: ptxas {label} {dtype} NR={nr}, {len(vals)} kernel "
            f"types: {min(regs)}-{max(regs)} registers, at most {max(v[1] for v in vals)} "
            f"bytes of spills")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is false)")
    sys.path.insert(0, HERE)
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops import kernels as kt_mod
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; CUDA graph conditional nodes in this torch "
        f"(CUDAGraph.begin_capture_to_if_node): "
        f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    nf.build()
    log(f"phase 1: kernels built in {nf.BUILD_INFO['seconds']:.2f} s "
        f"({nf.BUILD_INFO['path']})")
    log_ptxas(nf.BUILD_INFO["log"])

    for d in (3, 2, 1):
        phase_kernels(nf, kt_mod, dev, d)
        phase_kernels_cells(nf, kt_mod, dev, d)
    config2_ms = phase_config2(frt, nf, dev)
    rbfi, pts, span, entries, host = phase_albatite(frt, nf, timing, dev)
    phase_config2_gradients(nf, dev)
    iso_launches = phase_isosurface(frt, nf, timing, rbfi, pts, span)
    entries["near_field_grad_f64"]["launches"] = iso_launches["near_field_grad_f64"]
    phase_trend(frt, nf, timing, dev)
    t11 = time.perf_counter()
    phase_dims(frt, nf, timing, dev)
    phase_examples(nf, dev)
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    phase_sharded(dev, {"fused": rbfi.coefficients, "host": host.coefficients}, config2_ms)
    del rbfi, host
    rbfi4 = phase_config4(frt, nf, timing, dev)
    entries.update(phase_gate(nf, dev, rbfi4))
    log(f"all eleven phases in {time.perf_counter() - t_start:.1f} s (kernel build "
        f"{nf.BUILD_INFO['seconds']:.2f} s)")

    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
