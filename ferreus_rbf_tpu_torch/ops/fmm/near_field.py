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

On a CUDA tensor :func:`near_field` launches the hand-written Hopper kernel
(``csrc/near_field.cu``): ``near_field_f32`` (H1) or ``near_field_f64`` (H2);
:func:`near_field_grad` launches ``near_field_grad_f64`` (H3);
:func:`near_field_cells` launches ``near_field_cells_f32`` or
``near_field_cells_f64`` and :func:`near_field_cells_grad`
``near_field_cells_grad_f64`` (H4). Each launches its kernel or raises. On a
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

import torch

from ..kernels import KernelParams, kernel_code, make_kernel

__all__ = ["LAUNCHES", "build", "near_field", "near_field_cells", "near_field_cells_grad",
           "near_field_cells_grad_plain", "near_field_cells_plain", "near_field_grad",
           "near_field_grad_plain", "near_field_plain", "reset_launches"]

# Launches of each CUDA kernel (incremented by the wrapper, nowhere else).
LAUNCHES = {"near_field_f32": 0, "near_field_f64": 0, "near_field_grad_f64": 0,
            "near_field_cells_f32": 0, "near_field_cells_f64": 0,
            "near_field_cells_grad_f64": 0}

# C signature of each symbol: (input pointers, output pointers, ints,
# doubles), then the spheroidal power and the stream. Tile kernels take
# (tgt, src, w, nbr, cnt) and (R, Tn, d, ds, S, L1, U, nrhs, code); cell
# kernels (tgt, cells, cnt, centers, lengths, nodes, mult) and
# (R, Tn, d, P, ncells, U, nrhs, code). Gradient kernels add gout and far_grad.
_SIGNATURES = {"near_field_f32": (5, 1, 9, 5), "near_field_f64": (5, 1, 9, 5),
               "near_field_grad_f64": (5, 2, 9, 6),
               "near_field_cells_f32": (7, 1, 8, 5), "near_field_cells_f64": (7, 1, 8, 5),
               "near_field_cells_grad_f64": (7, 2, 8, 6)}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_PKG_DIR, "csrc", "near_field.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PLAIN_BUDGET = 1 << 22
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


def _check(tgt, src, w, nbr, cnt):
    _check_common(tgt, nbr, cnt, (tgt, src, w))
    if src.dtype != tgt.dtype or w.dtype != tgt.dtype:
        raise TypeError("tgt, src and w must share one dtype")
    if src.dim() != 3 or w.dim() != 3:
        raise ValueError("expected src (L+1,ds,S) and w (L+1,nrhs,S)")
    l1, ds, s = src.shape
    if ds < tgt.shape[2]:
        raise ValueError(f"need ds >= d, got d={tgt.shape[2]}, ds={ds}")
    if w.shape[0] != l1 or w.shape[2] != s:
        raise ValueError(f"w {tuple(w.shape)} does not match src {tuple(src.shape)}")


def _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult):
    _check_common(tgt, cells, cnt, (tgt, centers, lengths, nodes_nd, mult))
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


def near_field(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """The near field; see the module docstring. Returns (R, T, nrhs)."""
    _check(tgt, src, w, nbr, cnt)
    if _route(tgt, "near_field"):
        return near_field_plain(tgt, src, w, nbr, cnt, kparams=kparams)
    l1, ds, s = src.shape
    return _launch(tgt, (src, w, nbr, cnt), (ds, s, l1, nbr.shape[0]), w.shape[1], kparams)


def near_field_grad(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Values and target gradients of the near field; float64 only.
    Returns ((R, T, nrhs), (R, T, nrhs, d))."""
    _check(tgt, src, w, nbr, cnt)
    if tgt.dtype != torch.float64:
        raise TypeError(f"near_field_grad takes float64 tensors, got {tgt.dtype}")
    if _route(tgt, "near_field_grad"):
        return near_field_grad_plain(tgt, src, w, nbr, cnt, kparams=kparams)
    l1, ds, s = src.shape
    return _launch(tgt, (src, w, nbr, cnt), (ds, s, l1, nbr.shape[0]), w.shape[1], kparams,
                   grad=True)


def near_field_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                     kparams: KernelParams):
    """M2P over virtual cell nodes; see the module docstring. Returns
    (R, T, nrhs) in the targets' dtype."""
    _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    if _route(tgt, "near_field_cells"):
        return near_field_cells_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult,
                                      kparams=kparams)
    return _launch(tgt, (cells, cnt, centers, lengths, nodes_nd, mult),
                   (nodes_nd.shape[0], centers.shape[0], cells.shape[0]), mult.shape[2],
                   kparams, cells=True)


def near_field_cells_grad(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                          kparams: KernelParams):
    """Values and target gradients of :func:`near_field_cells`; float64
    only. Returns ((R, T, nrhs), (R, T, nrhs, d))."""
    _check_cells(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    if tgt.dtype != torch.float64:
        raise TypeError(f"near_field_cells_grad takes float64 tensors, got {tgt.dtype}")
    if _route(tgt, "near_field_cells_grad"):
        return near_field_cells_grad_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult,
                                           kparams=kparams)
    return _launch(tgt, (cells, cnt, centers, lengths, nodes_nd, mult),
                   (nodes_nd.shape[0], centers.shape[0], cells.shape[0]), mult.shape[2],
                   kparams, grad=True, cells=True)


def _launch(tgt, operands, sizes, nrhs, kparams, grad=False, cells=False):
    """Launch one kernel: ``operands`` are the input tensors after ``tgt``
    (None for absent counts) and ``sizes`` the ints between (R, Tn, d) and
    nrhs in the symbol's signature (``_SIGNATURES``)."""
    lib = build()
    prefix = "near_field_cells" if cells else "near_field"
    if grad:
        name = f"{prefix}_grad_f64"
    else:
        name = f"{prefix}_f32" if tgt.dtype == torch.float32 else f"{prefix}_f64"
    r, t, d = tgt.shape
    code, c = kernel_code(kparams)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    outs = (out,)
    consts = (c["s2"], c["ip2"], c["near_slope"], c["far_coef"], c["total_sill"])
    if grad:
        outs += (torch.empty((r, t, nrhs, d), dtype=tgt.dtype, device=tgt.device),)
        consts += (c["far_grad"],)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = getattr(lib, name)(
            tgt.data_ptr(), *(None if x is None else x.data_ptr() for x in operands),
            *(o.data_ptr() for o in outs), r, t, d, *sizes, nrhs, code, *consts, c["pw"],
            stream,
        )
    if rc != 0:
        msg = lib.near_field_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1
    return outs if grad else out


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


def near_field_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field`: gather each row's
    neighbour tiles and contract in one einsum per row chunk."""
    return _plain_values(tgt, *_tile_gather(tgt, src, w, nbr, cnt), w.shape[1], kparams)


def near_field_grad_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field_grad`."""
    return _plain_grads(tgt, *_tile_gather(tgt, src, w, nbr, cnt), w.shape[1], kparams)


def near_field_cells_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                           kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field_cells`: gather each row's
    virtual nodes and multipole weights and contract in one einsum per row
    chunk (the JAX package's ``_near_field_class`` with virtual nodes)."""
    gathered = _cell_gather(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    return _plain_values(tgt, *gathered, mult.shape[2], kparams)


def near_field_cells_grad_plain(tgt, cells, cnt, centers, lengths, nodes_nd, mult, *,
                                kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field_cells_grad`."""
    gathered = _cell_gather(tgt, cells, cnt, centers, lengths, nodes_nd, mult)
    return _plain_grads(tgt, *gathered, mult.shape[2], kparams)
