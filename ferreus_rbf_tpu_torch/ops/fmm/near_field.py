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

On a CUDA tensor :func:`near_field` launches the hand-written Hopper kernel
(``csrc/near_field.cu``): ``near_field_f32`` (H1) or ``near_field_f64`` (H2);
:func:`near_field_grad` launches ``near_field_grad_f64`` (H3). Each launches
its kernel or raises. On a CPU tensor they run :func:`near_field_plain` and
:func:`near_field_grad_plain`, the gather + chunked einsum versions of the
same functions, which the tests hold against the Pallas kernels and the
chip smoke test holds against the CUDA kernels. ``LAUNCHES`` counts kernel
launches per kernel.
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

__all__ = ["LAUNCHES", "build", "near_field", "near_field_grad", "near_field_grad_plain",
           "near_field_plain", "reset_launches"]

# Launches of each CUDA kernel (incremented by the wrapper, nowhere else).
LAUNCHES = {"near_field_f32": 0, "near_field_f64": 0, "near_field_grad_f64": 0}

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
        for name in LAUNCHES:
            grad = name == "near_field_grad_f64"  # + gout pointer, + far_grad
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ptr] * (7 if grad else 6) + [ctypes.c_int] * 9
                           + [ctypes.c_double] * (6 if grad else 5) + [ctypes.c_int, ptr])
        lib.near_field_error_string.restype = ctypes.c_char_p
        lib.near_field_error_string.argtypes = [ctypes.c_int]
        BUILD_INFO.update(path=path, seconds=time.perf_counter() - t0, log=log)
        _LIB = lib
        return lib


def _check(tgt, src, w, nbr, cnt):
    if tgt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"near_field takes float32 or float64 tensors, got {tgt.dtype}")
    if src.dtype != tgt.dtype or w.dtype != tgt.dtype:
        raise TypeError("tgt, src and w must share one dtype")
    if nbr.dtype != torch.int32 or (cnt is not None and cnt.dtype != torch.int32):
        raise TypeError("nbr and cnt must be int32")
    if tgt.dim() != 3 or src.dim() != 3 or w.dim() != 3 or nbr.dim() != 2:
        raise ValueError("expected tgt (R,T,d), src (L+1,ds,S), w (L+1,nrhs,S), nbr (U,R)")
    r, _, d = tgt.shape
    l1, ds, s = src.shape
    if not 1 <= d <= 3 or ds < d:
        raise ValueError(f"need 1 <= d <= 3 and ds >= d, got d={d}, ds={ds}")
    if w.shape[0] != l1 or w.shape[2] != s:
        raise ValueError(f"w {tuple(w.shape)} does not match src {tuple(src.shape)}")
    if nbr.shape[1] != r or (cnt is not None and tuple(cnt.shape) != (r,)):
        raise ValueError("nbr must be (U, R) and cnt (R,)")
    tensors = (tgt, src, w, nbr) + (() if cnt is None else (cnt,))
    if any(x.device != tgt.device for x in tensors):
        raise ValueError("all near_field operands must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("near_field operands must be contiguous")


def near_field(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """The near field; see the module docstring. Returns (R, T, nrhs)."""
    _check(tgt, src, w, nbr, cnt)
    if tgt.device.type == "cpu":
        return near_field_plain(tgt, src, w, nbr, cnt, kparams=kparams)
    if tgt.device.type != "cuda":
        raise ValueError(f"near_field runs on CPU or CUDA tensors, got {tgt.device}")
    return _launch(tgt, src, w, nbr, cnt, kparams)


def near_field_grad(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Values and target gradients of the near field; float64 only.
    Returns ((R, T, nrhs), (R, T, nrhs, d))."""
    _check(tgt, src, w, nbr, cnt)
    if tgt.dtype != torch.float64:
        raise TypeError(f"near_field_grad takes float64 tensors, got {tgt.dtype}")
    if tgt.device.type == "cpu":
        return near_field_grad_plain(tgt, src, w, nbr, cnt, kparams=kparams)
    if tgt.device.type != "cuda":
        raise ValueError(f"near_field_grad runs on CPU or CUDA tensors, got {tgt.device}")
    return _launch(tgt, src, w, nbr, cnt, kparams, grad=True)


def _launch(tgt, src, w, nbr, cnt, kparams, grad=False):
    lib = build()
    if grad:
        name = "near_field_grad_f64"
    else:
        name = "near_field_f32" if tgt.dtype == torch.float32 else "near_field_f64"
    r, t, d = tgt.shape
    l1, ds, s = src.shape
    nrhs = w.shape[1]
    u = nbr.shape[0]
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
            tgt.data_ptr(), src.data_ptr(), w.data_ptr(), nbr.data_ptr(),
            None if cnt is None else cnt.data_ptr(), *(o.data_ptr() for o in outs),
            r, t, d, ds, s, l1, u, nrhs, code, *consts, c["pw"], stream,
        )
    if rc != 0:
        msg = lib.near_field_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1
    return outs if grad else out


def _plain_chunks(tgt, src, w, nbr, cnt):
    """Yield (row slice, r2, diffs, weights) for the plain versions: each
    row's neighbour tiles gathered into one (rows, T, U*S) block, chunked
    over rows so that the d + 3 such blocks live at once (r2, the d
    differences, phi or g, a product) stay below ``_PLAIN_BUDGET`` elements.
    Sentinel entries and entries past a row's count get zero weights."""
    r, t, d = tgt.shape
    l1, _, s = src.shape
    nrhs = w.shape[1]
    u = nbr.shape[0]
    idx = nbr.T.long()  # (R, U)
    keep = idx != l1 - 1
    if cnt is not None:
        keep &= torch.arange(u, device=idx.device)[None, :] < cnt[:, None]
    step = max(1, _PLAIN_BUDGET // max((d + 3) * t * u * s, 1))
    for r0 in range(0, r, step):
        rows = slice(r0, r0 + step)
        ii = idx[rows]
        c = ii.shape[0]
        sp = src[ii, :d].permute(0, 2, 1, 3).reshape(c, d, u * s)
        wv = (w[ii] * keep[rows, :, None, None]).permute(0, 2, 1, 3).reshape(c, nrhs, u * s)
        diffs = [tgt[rows, :, i, None] - sp[:, None, i, :] for i in range(d)]
        r2 = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            r2 = r2 + diff * diff
        yield rows, r2, diffs, wv


def near_field_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field`: gather each row's
    neighbour tiles and contract in one einsum per row chunk."""
    r, t, _ = tgt.shape
    kernel = make_kernel(kparams, dtype=tgt.dtype)
    out = torch.empty((r, t, w.shape[1]), dtype=tgt.dtype, device=tgt.device)
    for rows, r2, _, wv in _plain_chunks(tgt, src, w, nbr, cnt):
        out[rows] = torch.einsum("cts,crs->ctr", kernel.phi_r2(r2), wv)
    return out


def near_field_grad_plain(tgt, src, w, nbr, cnt=None, *, kparams: KernelParams):
    """Plain PyTorch version of :func:`near_field_grad`."""
    r, t, d = tgt.shape
    nrhs = w.shape[1]
    kernel = make_kernel(kparams, dtype=tgt.dtype)
    out = torch.empty((r, t, nrhs), dtype=tgt.dtype, device=tgt.device)
    grad = torch.empty((r, t, nrhs, d), dtype=tgt.dtype, device=tgt.device)
    for rows, r2, diffs, wv in _plain_chunks(tgt, src, w, nbr, cnt):
        out[rows] = torch.einsum("cts,crs->ctr", kernel.phi_r2(r2), wv)
        g = kernel.grad_scale_r2(r2)
        for i, diff in enumerate(diffs):
            grad[rows, :, :, i] = torch.einsum("cts,crs->ctr", g * diff, wv)
    return out, grad
