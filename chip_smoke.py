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
   sentinel cells and targets that coincide with cell nodes;
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
   calls) against the evaluation's wall-clock;
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
   version, with the table's calls in the fit;
8. the M2P node-tile gate at 1M: phase 7's weights on one tree with the
   gate at its default and one with ``FERREUS_RBF_TPU_NODETILE_BYTES=0``
   (gated, M2P on H4): f32 and f64 matvecs and gradients at 4,096 sources
   compared between the two, H4 held against its plain version on the
   gated tree's whole M2P with live target counts and timed against the
   ungated M2P leg (H1/H2/H3), which it must equal bit for bit on one set
   of expansions, with the share of its 256 longest rows.

Phases 4-8 each zero the kernels' launch counters just before they drive
the port and read them just after. The line before the last is a JSON
object with one entry per kernel: its launches on its path (phase 4 for
H1/H2, phase 6 for H3, phase 8's gated tree for H4), its error and time
against the plain version (the albatite shapes for H1-H3, phase 8's gated
M2P for H4), and its bound; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
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
    lists = [nf.work_items(*(x.to(d) for x in (nbr, cnt, tcnt, scnt)), t=t, s=s, l1=ntiles + 1)
             for d in (dev, torch.device("cpu"))]
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


def phase_kernels_cells(nf, kt_mod, dev):
    """H4: all kernel types x {f32, f64, gradients} x {counts, none} x nrhs
    {1, 2, 8} on p = 7 cells (343 nodes: 11 staging chunks, the last
    partial), with sentinel cells, a row of count 0, rows of 0, 1, 9, 100
    or 128 live targets and targets that coincide with nodes of a listed
    cell; two launches bitwise equal and dead slots 0."""
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
    cnt[1] = u
    cells[:, 1] = torch.randperm(ncells, generator=g)[:u].int()  # no sentinel
    choice = torch.tensor([0, 1, 9, 100, 128], dtype=torch.int32)
    tcnt = choice[torch.randint(0, 5, (rows,), generator=g)].to(dev)
    dead = torch.arange(t, device=dev)[None, :] >= tcnt[:, None]
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
        log(f"phase 2: H4 near_field_cells {key}, 10 kernel types x counts x nrhs {{1,2,8}}, "
            f"with and without live target counts, p = 7 cells, coincident targets: worst "
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
    launches themselves."""

    def __init__(self, api, name="near_field"):
        self.api, self.name, self.real = api, name, getattr(api, name)
        self.calls, self.last = {}, {}

    def __enter__(self):
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
        setattr(self.api, self.name, self.real)


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
        r = time_near_field(nf, tree, "src", dtype, kp, nrhs, g)
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
    from ferreus_rbf_tpu_torch.ops.fmm import api
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
    with LegCounter(api) as legs:
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
    with LegCounter(api, "near_field_grad") as grad_legs:
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
    g = torch.Generator(device="cpu").manual_seed(2)
    entries = {}
    for name, dtype, grad in (("near_field_f32", torch.float32, False),
                              ("near_field_f64", torch.float64, False),
                              ("near_field_grad_f64", torch.float64, True)):
        r = time_near_field(nf, tree, "__all__", dtype,
                            settings.kernel_params(), 1, g, grad=grad)
        log_near_field("phase 4: albatite", name, r)
        entries[name] = kernel_entry(name, launches[name], r["p2p"])
    return rbfi, pts, span, entries


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
    edges = np.sort(facets[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, uses = np.unique(edges, axis=0, return_counts=True)
    log(f"phase 6: albatite isosurface at span/100 ({resolution:.6g}) {iso_s:.3f} s: "
        f"{mesh.num_vertices} vertices, {mesh.num_facets} facets; {json.dumps(calls)}; "
        f"max facets per edge {int(uses.max()) if uses.size else 0}, "
        f"boundary edges {int((uses == 1).sum())}")
    log(f"phase 6: stages (s) {json.dumps({k: round(v, 3) for k, v in tracer.totals.items()})}")
    log(f"phase 6: nf_work_items {tracer.totals.get('nf_work_items', 0.0):.3f} s over "
        f"{len(builds)} work lists built")
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
    time_fit_legs(nf, rbfi.interpolant_settings.kernel_params(), legs)
    del legs

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
    log(f"phase 8: gated vs ungated f64 matvec bitwise equal: "
        f"{torch.equal(out['gated'][1], out['ungated'][1])}")
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
    tlive = binned["tcnt"]
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
        # one set of expansions for both trees (the two differ in the last
        # bits, above), so the legs can be compared bit for bit
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
        log(f"phase 8: {name} gated M2P with live target counts, rows {tpts.shape[0]}: "
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


# the mangled name of near_field_work_items_kernel<KT, T, NR, GRAD, CELLS>
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
        f"{torch.cuda.get_device_name(0)}")
    nf.build()
    log(f"phase 1: kernels built in {nf.BUILD_INFO['seconds']:.2f} s "
        f"({nf.BUILD_INFO['path']})")
    log_ptxas(nf.BUILD_INFO["log"])

    phase_kernels(nf, kt_mod, dev)
    phase_kernels_cells(nf, kt_mod, dev)
    phase_config2(frt, nf, dev)
    rbfi, pts, span, entries = phase_albatite(frt, nf, timing, dev)
    phase_config2_gradients(nf, dev)
    iso_launches = phase_isosurface(frt, nf, timing, rbfi, pts, span)
    entries["near_field_grad_f64"]["launches"] = iso_launches["near_field_grad_f64"]
    rbfi4 = phase_config4(frt, nf, timing, dev)
    entries.update(phase_gate(nf, dev, rbfi4))
    log(f"all eight phases in {time.perf_counter() - t_start:.1f} s (kernel build "
        f"{nf.BUILD_INFO['seconds']:.2f} s)")

    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
