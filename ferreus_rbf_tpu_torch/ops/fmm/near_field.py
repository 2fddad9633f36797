"""Near field of the FMM: P2P over u-lists, M2P over w-lists, P2L over x-lists.

Counterpart of ``ferreus_rbf_tpu/ops/fmm/p2p_pallas.py``. One function,

    out[r, t, k] = sum_{u < n(r)} sum_s phi(|x[r, t] - y[nbr[u, r], s]|^2)
                                         * w[nbr[u, r], k, s],

over bucketed tiles: ``tgt`` (R, T, d) target rows, ``src`` (L+1, ds, S)
source-coordinate tiles (ds >= d; only the first d rows are read), ``w``
(L+1, nrhs, S) weight tiles, ``nbr`` (U, R) int32 neighbour table and
optional ``cnt`` (R,) int32 per-row neighbour counts (n(r) = cnt[r], else
U). Tile L, the last one, is the sentinel: entries pointing at it add
nothing (its weights are zero by construction), and padded slots of real
tiles carry zero weights. For P2P the tiles are leaf buckets of source
points; for M2P they are w-list cells' Chebyshev nodes, weighted by the
cells' multipole coefficients; for P2L the target rows are cells'
Chebyshev nodes and the tiles their x-list source leaves.

:func:`near_field_grad` computes, on the same operands in float64, the
values and their target gradients

    grad[r, t, k, i] = sum_{u, s} g(r2) * (x[r, t, i] - y[l, i, s]) * w[l, k, s],

grad phi at displacement x - y being (x - y) * g(|x - y|^2)
(``Kernel.grad_scale_r2``).

:func:`near_field_cells` and :func:`near_field_cells_grad` compute the M2P
of a tree whose node tiles are not stored (the node-tile gate): ``cells``
(U, R) int32 holds global cell ids (sentinel ``ncells``) and each listed
cell's sources are its p^d Chebyshev nodes, ``centers[c] + (lengths[c] *
0.5) * nodes_nd[j]`` computed in float64 and rounded to the targets' type
(bitwise the stored node tiles), weighted by its multipole coefficients
``mult[c, j, k]`` (ncells, p^d, nrhs). Nothing is gathered per matvec.

Every form takes live counts: ``tcnt`` (R,) int32, the live target slots
of each row (the leading ones), and, where the sources are tiles, ``scnt``
(L+1,) int32, the live source slots of each tile (the leading ones; 0 for
the sentinel; a listed cell has all its nodes live). No pair with a dead
target or a dead source slot is computed, and dead target slots come out
0 (values and gradients). Without them every slot is live.

On a CUDA tensor each form launches its hand-written Hopper kernel
(``csrc/near_field.cu``): :func:`near_field` ``near_field_f32`` (H1) or
``near_field_f64`` (H2), :func:`near_field_grad` ``near_field_grad_f64``
(H3), :func:`near_field_cells` ``near_field_cells_f32`` or
``near_field_cells_f64`` and :func:`near_field_cells_grad`
``near_field_cells_grad_f64`` (H4). All of them run over the call's work
items (:func:`work_items`: each a row, a span of its live targets and a
stretch of its live neighbour tiles or cells of at most ``_ITEM_SOURCES``
live sources), built once per neighbour table and kept on it. Each
launches its kernel or raises. On a
CPU tensor they run the ``*_plain`` versions, the gather + chunked einsum
forms of the same functions, which the tests hold against the Pallas
kernels and the chip smoke test holds against the CUDA kernels.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import NamedTuple

import torch

from ...utils.timing import traced_stage
from ..kernels import KernelParams, kernel_code, make_kernel

__all__ = ["LAUNCHES", "WorkItems", "build", "near_field", "near_field_cells",
           "near_field_cells_grad", "near_field_cells_grad_plain", "near_field_cells_plain",
           "near_field_grad", "near_field_grad_plain", "near_field_plain", "reset_launches",
           "work_items"]

# Launches of each CUDA kernel (incremented by the wrapper, nowhere else;
# one per wrapper call, whatever the passes inside it).
LAUNCHES = {"near_field_f32": 0, "near_field_f64": 0, "near_field_grad_f64": 0,
            "near_field_cells_f32": 0, "near_field_cells_f64": 0,
            "near_field_cells_grad_f64": 0}

# C signature of each symbol: (input pointers, output pointers, ints,
# doubles), then the spheroidal power and the stream. Tile kernels take
# (tgt, src, w, items, entries, segtab, tcnt) and (R, Tn, d, ds, S, nitems,
# nspan, nrhs, code); cell kernels (tgt, centers, lengths, nodes, mult,
# items, entries, segtab, tcnt) and (R, Tn, d, P, nitems, nspan, nrhs,
# code). Outputs: (out, part), or (out, gout, part, gpart) for gradients,
# which also take far_grad.
_SIGNATURES = {"near_field_f32": (7, 2, 9, 5), "near_field_f64": (7, 2, 9, 5),
               "near_field_grad_f64": (7, 4, 9, 6),
               "near_field_cells_f32": (9, 2, 8, 5), "near_field_cells_f64": (9, 2, 8, 5),
               "near_field_cells_grad_f64": (9, 4, 8, 6)}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_PKG_DIR, "csrc", "near_field.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PLAIN_BUDGET = 1 << 22
# Target slots of one work item: the kernels' kSpan (32 lanes x 4).
_SPAN = 128
# Live source slots of one work item (a tile or cell that alone holds
# more is an item of its own), for every kernel. Set on the H100 from
# near_field_legs.py (PERF.md).
_ITEM_SOURCES = 256
_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """Compile ``csrc/near_field.cu`` with nvcc (once per source content)
    into the repository's ``build/`` directory and load it.

    ``BUILD_INFO`` records the library path, the build seconds (0 when the
    library was already built) and nvcc's ``-Xptxas -v`` report.
    """
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(_BUILD_DIR, f"near_field_{digest}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [os.path.join(CUDA_HOME, "bin", "nvcc"), *_NVCC_FLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True, check=False,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        ptr = ctypes.c_void_p
        for name, (n_in, n_out, n_int, n_dbl) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ptr] * (n_in + n_out) + [ctypes.c_int] * n_int
                           + [ctypes.c_double] * n_dbl + [ctypes.c_int, ptr])
        lib.near_field_error_string.restype = ctypes.c_char_p
        lib.near_field_error_string.argtypes = [ctypes.c_int]
        BUILD_INFO.update(path=path, seconds=time.perf_counter() - t0, log=log)
        _LIB = lib
        return lib


def _check_common(tgt, nbr, cnt, tensors):
    if tgt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"near_field takes float32 or float64 tensors, got {tgt.dtype}")
    if nbr.dtype != torch.int32 or (cnt is not None and cnt.dtype != torch.int32):
        raise TypeError("nbr and cnt must be int32")
    if tgt.dim() != 3 or nbr.dim() != 2:
        raise ValueError("expected tgt (R,T,d) and nbr (U,R)")
    r, _, d = tgt.shape
    if not 1 <= d <= 3:
        raise ValueError(f"need 1 <= d <= 3, got d={d}")
    if nbr.shape[1] != r or (cnt is not None and tuple(cnt.shape) != (r,)):
        raise ValueError("nbr must be (U, R) and cnt (R,)")
    tensors = tensors + (nbr,) + (() if cnt is None else (cnt,))
    if any(x.device != tgt.device for x in tensors):
        raise ValueError("all near_field operands must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("near_field operands must be contiguous")


def _check(tgt, src, w, nbr, cnt, tcnt=None, scnt=None):
    counts = tuple(x for x in (tcnt, scnt) if x is not None)
    _check_common(tgt, nbr, cnt, (tgt, src, w) + counts)
    if src.dtype != tgt.dtype or w.dtype != tgt.dtype:
        raise TypeError("tgt, src and w must share one dtype")
    if src.dim() != 3 or w.dim() != 3:
        raise ValueError("expected src (L+1,ds,S) and w (L+1,nrhs,S)")
    l1, ds, s = src.shape
    if ds < tgt.shape[2]:
        raise ValueError(f"need ds >= d, got d={tgt.shape[2]}, ds={ds}")
    if w.shape[0] != l1 or w.shape[2] != s:
        raise ValueError(f"w {tuple(w.shape)} does not match src {tuple(src.shape)}")
    _check_counts(tgt, tcnt, scnt, l1)


def _check_counts(tgt, tcnt, scnt, l1):
    counts = tuple(x for x in (tcnt, scnt) if x is not None)
    if any(x.dtype != torch.int32 for x in counts):
        raise TypeError("tcnt and scnt must be int32")
    if ((tcnt is not None and tuple(tcnt.shape) != (tgt.shape[0],))
            or (scnt is not None and tuple(scnt.shape) != (l1,))):
        raise ValueError("tcnt must be (R,) and scnt (L+1,)")


class WorkItems(NamedTuple):
    """The work list of one near-field call (int32 tensors).

    ``entries`` (E, 2): each row's live neighbour entries in list order
    (entries past the row's count, sentinels and tiles with no live source
    dropped) as (tile or cell, live sources). ``items`` (n, 6): (row, t0, tlen,
    e0, e1, dst), one warp each: target slots [t0, t0 + tlen) of the row
    (tlen <= ``_SPAN``, live slots only) against entries [e0, e1), in order
    of decreasing work; dst = -1 writes the output, else the item writes
    partial block dst. ``segtab`` (R, nspan, 2): per (row, span of
    ``_SPAN`` slots), (first partial block, number of items): 1 item wrote
    the output itself, 0 items means zeros, k >= 2 items wrote partial
    blocks first .. first + k - 1, which the second pass adds in that order.
    """

    items: torch.Tensor
    entries: torch.Tensor
    segtab: torch.Tensor
    nparts: int


def work_items(nbr, cnt=None, tcnt=None, scnt=None, *, t, s, l1) -> WorkItems:
    """Build the work list of a near-field call with torch ops on ``nbr``'s
    device: ``nbr`` (U, R) with sentinel ``l1 - 1`` (ids outside [0, l1 - 1)
    are dropped), optional counts as in :func:`near_field`, ``t`` target
    slots per row and ``s`` source slots per tile or cell. Each row's live
    entries are cut greedily, in list order, into runs of at most
    ``_ITEM_SOURCES`` live sources (an entry with more is a run alone); each
    run meets each span of the row's live targets in one item. Integer ops
    and a stable sort only: every device builds the same list."""
    dev = nbr.device
    nbr = nbr.long().T  # (R, U)
    r, u = nbr.shape
    listed = (nbr >= 0) & (nbr < l1 - 1)
    if scnt is None:
        size = torch.full_like(nbr, s)
    else:
        size = scnt.long().clamp(0, s)[torch.where(listed, nbr, l1 - 1)]
    live = listed & (size > 0)
    if cnt is not None:
        live &= torch.arange(u, device=dev)[None, :] < cnt.long()[:, None]
    rr, uu = live.nonzero(as_tuple=True)  # row-major: each row's list in order
    esize = size[rr, uu]
    entries = torch.stack([nbr[rr, uu], esize], 1)

    # The greedy cut without a loop over the list: a run starting at entry i
    # ends before nxt[i], so the run starts are the orbit of each row's first
    # entry under nxt. Binary lifting finds, for every entry, the last orbit
    # point at or before it (nxt^(2^k) for k < bits covers any row).
    n = esize.numel()
    idx = torch.arange(n, device=dev)
    cum = esize.cumsum(0)  # strictly increasing: live entries hold sources
    rlen = torch.bincount(rr, minlength=r)
    rend = rlen.cumsum(0)
    nxt = torch.searchsorted(cum, cum - esize + _ITEM_SOURCES, right=True)
    nxt = torch.minimum(torch.maximum(nxt, idx + 1), rend[rr])
    jumps = [torch.cat([nxt, idx.new_tensor([n])])]
    for _ in range(max(u, 1).bit_length() - 1):
        jumps.append(jumps[-1][jumps[-1]])
    pos = (rend - rlen)[rr]
    for jump in reversed(jumps):
        step = jump[pos]
        pos = torch.where(step <= idx, step, pos)
    e0 = (pos == idx).nonzero().flatten()
    e1 = torch.cat([e0[1:], idx.new_tensor([n])])[:e0.numel()]
    grow = rr[e0]
    runs = torch.bincount(grow, minlength=r)  # items of each segment of the row
    grun = torch.arange(e0.numel(), device=dev) - (runs.cumsum(0) - runs)[grow]
    gsrc = cum[e1 - 1] - (cum - esize)[e0]

    tl = torch.full((r,), t, device=dev) if tcnt is None else tcnt.long().clamp(0, t)
    nspan = -(-t // _SPAN)
    spans = torch.where(runs > 0, -(-tl // _SPAN), 0)
    reps = spans[grow]
    g = torch.repeat_interleave(torch.arange(grow.numel(), device=dev), reps)
    span = torch.arange(g.numel(), device=dev)
    span -= torch.repeat_interleave(reps.cumsum(0) - reps, reps)
    row = grow[g]
    t0 = span * _SPAN
    tlen = (tl[row] - t0).clamp(max=_SPAN)
    k = runs[row]
    segk = torch.zeros(r * nspan, dtype=torch.long, device=dev)
    segk[row * nspan + span] = k
    split = torch.where(segk >= 2, segk, 0)
    first = split.cumsum(0) - split
    dst = torch.where(k >= 2, first[row * nspan + span] + grun[g], -1)
    items = torch.stack([row, t0, tlen, e0[g], e1[g], dst], 1)
    order = torch.sort(gsrc[g] * tlen, descending=True, stable=True).indices
    return WorkItems(items[order].int().contiguous(), entries.int().contiguous(),
                     torch.stack([first, segk], 1).view(r, nspan, 2).int(), int(split.sum()))


def _work_items_on(nbr, cnt, tcnt, scnt, t, s, l1) -> WorkItems:
    """:func:`work_items`, kept on ``nbr`` itself for the next call with the
    same count tensors (the tables of a binned target set are built once
    and never changed in place): the value and gradient kernels on one
    table share it."""
    counts, dims = (cnt, tcnt, scnt), (t, s, l1, _ITEM_SOURCES)
    kept = getattr(nbr, "_work_items", None)
    if kept is not None and kept[1] == dims and all(a is b for a, b in zip(kept[0], counts)):
        return kept[2]
    with traced_stage("nf_work_items"):
        wl = work_items(nbr, cnt, tcnt, scnt, t=t, s=s, l1=l1)
    nbr._work_items = (counts, dims, wl)
    return wl


def _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult, tcnt=None):
    counts = () if tcnt is None else (tcnt,)
    _check_common(tgt, cells, cnt, (tgt, centers, lengths, nodes_nd, mult) + counts)
    _check_counts(tgt, tcnt, None, None)
    if mult.dtype != tgt.dtype:
        raise TypeError("tgt and mult must share one dtype")
    if not all(x.dtype == torch.float64 for x in (centers, lengths, nodes_nd)):
        raise TypeError("centers, lengths and nodes_nd must be float64")
    d = tgt.shape[2]
    ncells = centers.shape[0]
    if (centers.dim() != 2 or centers.shape[1] != d or tuple(lengths.shape) != (ncells,)
            or nodes_nd.dim() != 2 or nodes_nd.shape[1] != d or mult.dim() != 3
            or mult.shape[:2] != (ncells, nodes_nd.shape[0])):
        raise ValueError("expected centers (ncells,d), lengths (ncells,), nodes_nd (P,d) "
                         "and mult (ncells,P,nrhs)")


def _route(tgt, name):
    """True for a CPU tensor (the plain version); False for a CUDA tensor
    (the kernel); raises on any other device."""
    if tgt.device.type == "cpu":
        return True
    if tgt.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {tgt.device}")
    return False


def near_field(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams, tcnt=None, scnt=None):
    """The near field; see the module docstring. Returns (R, T, nrhs)."""
    _check(tgt, src, w, nbr, cnt, tcnt, scnt)
    if _route(tgt, "near_field"):
        return near_field_plain(tgt, src, w, nbr, cnt, kparams=kparams, tcnt=tcnt, scnt=scnt)
    l1, ds, s = src.shape
    r, t, _ = tgt.shape
    nrhs = w.shape[1]
    wl = _work_items_on(nbr, cnt, tcnt, scnt, t, s, l1)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    part = torch.empty((wl.nparts, _SPAN, nrhs), dtype=tgt.dtype, device=tgt.device)
    name = "near_field_f32" if tgt.dtype == torch.float32 else "near_field_f64"
    _launch(name, tgt, (src, w, wl.items, wl.entries, wl.segtab, tcnt), (out, part),
            (ds, s, wl.items.shape[0], wl.segtab.shape[1], nrhs), kparams)
    return out


def near_field_grad(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams, tcnt=None,
                    scnt=None):
    """Values and target gradients of the near field; float64 only.
    Returns ((R, T, nrhs), (R, T, nrhs, d))."""
    _check(tgt, src, w, nbr, cnt, tcnt, scnt)
    if tgt.dtype != torch.float64:
        raise TypeError(f"near_field_grad takes float64 tensors, got {tgt.dtype}")
    if _route(tgt, "near_field_grad"):
        return near_field_grad_plain(tgt, src, w, nbr, cnt, kparams=kparams, tcnt=tcnt,
                                     scnt=scnt)
    l1, ds, s = src.shape
    nrhs = w.shape[1]
    wl = _work_items_on(nbr, cnt, tcnt, scnt, tgt.shape[1], s, l1)
    outs = _grad_outs(tgt, nrhs, wl.nparts)
    _launch("near_field_grad_f64", tgt, (src, w, wl.items, wl.entries, wl.segtab, tcnt), outs,
            (ds, s, wl.items.shape[0], wl.segtab.shape[1], nrhs), kparams, grad=True)
    return outs[:2]


def near_field_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                     kparams: KernelParams, tcnt=None):
    """M2P over virtual cell nodes; see the module docstring. Returns
    (R, T, nrhs) in the targets' dtype."""
    _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult, tcnt)
    if _route(tgt, "near_field_cells"):
        return near_field_cells_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult,
                                      kparams=kparams, tcnt=tcnt)
    r, t, _ = tgt.shape
    nrhs = mult.shape[2]
    wl = _cell_items(tgt, cells, cnt, centers, nodes_nd, tcnt)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    part = torch.empty((wl.nparts, _SPAN, nrhs), dtype=tgt.dtype, device=tgt.device)
    name = "near_field_cells_f32" if tgt.dtype == torch.float32 else "near_field_cells_f64"
    _launch(name, tgt, (centers, lengths, nodes_nd, mult, wl.items, wl.entries, wl.segtab,
                        tcnt), (out, part),
            (nodes_nd.shape[0], wl.items.shape[0], wl.segtab.shape[1], nrhs), kparams)
    return out


def near_field_cells_grad(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                          kparams: KernelParams, tcnt=None):
    """Values and target gradients of :func:`near_field_cells`; float64
    only. Returns ((R, T, nrhs), (R, T, nrhs, d))."""
    _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult, tcnt)
    if tgt.dtype != torch.float64:
        raise TypeError(f"near_field_cells_grad takes float64 tensors, got {tgt.dtype}")
    if _route(tgt, "near_field_cells_grad"):
        return near_field_cells_grad_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult,
                                           kparams=kparams, tcnt=tcnt)
    nrhs = mult.shape[2]
    wl = _cell_items(tgt, cells, cnt, centers, nodes_nd, tcnt)
    outs = _grad_outs(tgt, nrhs, wl.nparts)
    _launch("near_field_cells_grad_f64", tgt, (centers, lengths, nodes_nd, mult, wl.items,
                                               wl.entries, wl.segtab, tcnt), outs,
            (nodes_nd.shape[0], wl.items.shape[0], wl.segtab.shape[1], nrhs), kparams,
            grad=True)
    return outs[:2]


def _cell_items(tgt, cells, cnt, centers, nodes_nd, tcnt):
    """The work list of a cell table: every listed cell has all its p^d
    nodes live, and the sentinel is ``ncells``."""
    return _work_items_on(cells, cnt, tcnt, None, tgt.shape[1], nodes_nd.shape[0],
                          centers.shape[0] + 1)


def _grad_outs(tgt, nrhs, nparts):
    """Values (R, T, nrhs), gradients (R, T, nrhs, d) and their partial
    blocks."""
    r, t, d = tgt.shape
    new = lambda *shape: torch.empty(shape, dtype=tgt.dtype, device=tgt.device)  # noqa: E731
    return new(r, t, nrhs), new(r, t, nrhs, d), new(nparts, _SPAN, nrhs), new(nparts, _SPAN,
                                                                                nrhs, d)


def _launch(name, tgt, inputs, outs, sizes, kparams, grad=False):
    """Launch kernel ``name``: ``inputs`` are the input tensors after
    ``tgt`` (None for absent counts), ``outs`` the outputs the caller
    allocated and ``sizes`` the ints between (R, Tn, d) and the kernel code
    in the symbol's signature (``_SIGNATURES``)."""
    lib = build()
    r, t, d = tgt.shape
    code, c = kernel_code(kparams)
    consts = (c["s2"], c["ip2"], c["near_slope"], c["far_coef"], c["total_sill"])
    if grad:
        consts += (c["far_grad"],)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = getattr(lib, name)(
            tgt.data_ptr(), *(None if x is None else x.data_ptr() for x in inputs),
            *(o.data_ptr() for o in outs), r, t, d, *sizes, code, *consts, c["pw"], stream,
        )
    if rc != 0:
        msg = lib.near_field_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def _plain_chunks(tgt, n_src, gather):
    """Yield (row slice, r2, diffs, weights) for the plain versions: each
    row's ``n_src`` source slots, ``gather(rows)`` -> coordinates (c, d,
    n_src) and weights (c, nrhs, n_src), chunked over rows so that the
    d + 3 (rows, T, n_src) blocks live at once (r2, the d differences, phi
    or g, a product) stay below ``_PLAIN_BUDGET`` elements."""
    r, t, d = tgt.shape
    step = max(1, _PLAIN_BUDGET // max((d + 3) * t * n_src, 1))
    for r0 in range(0, r, step):
        rows = slice(r0, r0 + step)
        sp, wv = gather(rows)
        diffs = [tgt[rows, :, i, None] - sp[:, None, i, :] for i in range(d)]
        r2 = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            r2 = r2 + diff * diff
        yield rows, r2, diffs, wv


def _tile_gather(tgt, src, w, nbr, cnt):
    """Each row's neighbour tiles as one (U * S)-wide source block; sentinel
    entries and entries past a row's count get zero weights."""
    d = tgt.shape[2]
    l1, _, s = src.shape
    nrhs = w.shape[1]
    u = nbr.shape[0]
    idx = nbr.T.long()  # (R, U)
    keep = idx != l1 - 1
    if cnt is not None:
        keep &= torch.arange(u, device=idx.device)[None, :] < cnt[:, None]

    def gather(rows):
        ii = idx[rows]
        c = ii.shape[0]
        sp = src[ii, :d].permute(0, 2, 1, 3).reshape(c, d, u * s)
        wv = (w[ii] * keep[rows, :, None, None]).permute(0, 2, 1, 3).reshape(c, nrhs, u * s)
        return sp, wv

    return u * s, gather


def _cell_gather(tgt, cells, cnt, centers, lengths, nodes_nd, mult):
    """Each row's listed cells' virtual nodes (center + (length * 0.5) *
    node in float64, rounded to the targets' type) and multipole weights as
    one (U * P)-wide source block; sentinel entries and entries past a
    row's count get zero weights."""
    ncells = centers.shape[0]
    p, d = nodes_nd.shape
    nrhs = mult.shape[2]
    u = cells.shape[0]
    idx = cells.T.long()  # (R, U)
    keep = (idx >= 0) & (idx < ncells)
    if cnt is not None:
        keep &= torch.arange(u, device=idx.device)[None, :] < cnt[:, None]
    idx = torch.where(keep, idx, 0)

    def gather(rows):
        ii = idx[rows]
        c = ii.shape[0]
        y = centers[ii][:, :, None, :] + (lengths[ii][:, :, None, None] * 0.5) * nodes_nd
        sp = y.to(tgt.dtype).permute(0, 3, 1, 2).reshape(c, d, u * p)
        wv = (mult[ii] * keep[rows, :, None, None]).permute(0, 3, 1, 2).reshape(c, nrhs, u * p)
        return sp, wv

    return u * p, gather


def _plain_values(tgt, n_src, gather, nrhs, kparams):
    r, t, _ = tgt.shape
    kernel = make_kernel(kparams, dtype=tgt.dtype)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    for rows, r2, _, wv in _plain_chunks(tgt, n_src, gather):
        out[rows] = torch.einsum("cts,crs->ctr", kernel.phi_r2(r2), wv)
    return out


def _plain_grads(tgt, n_src, gather, nrhs, kparams):
    r, t, d = tgt.shape
    kernel = make_kernel(kparams, dtype=tgt.dtype)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    grad = torch.empty((r, t, nrhs, d), dtype=tgt.dtype, device=tgt.device)
    for rows, r2, diffs, wv in _plain_chunks(tgt, n_src, gather):
        out[rows] = torch.einsum("cts,crs->ctr", kernel.phi_r2(r2), wv)
        g = kernel.grad_scale_r2(r2)
        for i, diff in enumerate(diffs):
            grad[rows, :, :, i] = torch.einsum("cts,crs->ctr", g * diff, wv)
    return out, grad


def _live_weights(w, scnt):
    """Weight tiles with the source slots past ``scnt`` zeroed."""
    if scnt is None:
        return w
    slots = torch.arange(w.shape[2], device=w.device)
    return torch.where((slots[None, :] < scnt[:, None])[:, None, :], w, 0.0)


def _zero_dead(outs, tcnt):
    """Write 0 to the target slots past ``tcnt`` of each output (R, T, ...)."""
    if tcnt is not None:
        dead = torch.arange(outs[0].shape[1], device=outs[0].device)[None, :] >= tcnt[:, None]
        for out in outs:
            out[dead] = 0.0
    return outs


def near_field_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams, tcnt=None,
                     scnt=None):
    """Plain PyTorch version of :func:`near_field`: gather each row's
    neighbour tiles and contract in one einsum per row chunk; source slots
    past ``scnt`` weigh nothing and target slots past ``tcnt`` are 0."""
    w = _live_weights(w, scnt)
    out = _plain_values(tgt, *_tile_gather(tgt, src, w, nbr, cnt), w.shape[1], kparams)
    return _zero_dead((out,), tcnt)[0]


def near_field_grad_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams, tcnt=None,
                          scnt=None):
    """Plain PyTorch version of :func:`near_field_grad`, with the counts of
    :func:`near_field_plain`."""
    w = _live_weights(w, scnt)
    outs = _plain_grads(tgt, *_tile_gather(tgt, src, w, nbr, cnt), w.shape[1], kparams)
    return _zero_dead(outs, tcnt)


def near_field_cells_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                           kparams: KernelParams, tcnt=None):
    """Plain PyTorch version of :func:`near_field_cells`: gather each row's
    virtual nodes and multipole weights and contract in one einsum per row
    chunk (the JAX package's ``_near_field_class`` with virtual nodes);
    target slots past ``tcnt`` are 0."""
    gathered = _cell_gather(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    return _zero_dead((_plain_values(tgt, *gathered, mult.shape[2], kparams),), tcnt)[0]


def near_field_cells_grad_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                                kparams: KernelParams, tcnt=None):
    """Plain PyTorch version of :func:`near_field_cells_grad`."""
    gathered = _cell_gather(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    return _zero_dead(_plain_grads(tgt, *gathered, mult.shape[2], kparams), tcnt)
