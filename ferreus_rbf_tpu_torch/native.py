"""The native (C++) interaction-list builder of the FMM tree.

The port's counterpart of ``ferreus_rbf_tpu/native/__init__.py``:
``csrc/treebuild.cpp`` is compiled with g++ at first use into the
repository's ``build/`` directory, under a name that holds the digest of
the source and the flags, and loaded through ctypes. Unlike the JAX
package's loader, a compile or load failure raises: there is no quiet
fallback. ``FERREUS_RBF_TPU_NATIVE=0`` (the JAX package's knob) chooses the
numpy builder, ``ops/fmm/tree.py`` ``_build_interaction_lists_numpy``,
explicitly; it is read on every tree build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["build", "build_interaction_lists", "enabled"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "treebuild.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
_CXX = "g++"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


def enabled() -> bool:
    """Whether tree builds take the native lists (``FERREUS_RBF_TPU_NATIVE``
    is not ``0``)."""
    return os.environ.get("FERREUS_RBF_TPU_NATIVE", "1") != "0"


def build() -> ctypes.CDLL:
    """Compile ``csrc/treebuild.cpp`` (once per source content) and load
    it; raises ``RuntimeError`` when g++ fails or is missing."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(_BUILD_DIR, f"treebuild_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run([_CXX, *_FLAGS, _SRC, "-o", tmp],
                                      capture_output=True, text=True, check=False)
            except OSError as exc:
                raise RuntimeError(f"cannot run {_CXX} to build {_SRC}: {exc}") from exc
            if proc.returncode != 0:
                raise RuntimeError(f"{_CXX} failed ({proc.returncode}) on {_SRC}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        ptr = ctypes.c_void_p
        lib.ferreus_torch_build_lists.restype = ptr
        lib.ferreus_torch_build_lists.argtypes = [ctypes.c_int64, ctypes.c_int] + [ptr] * 6
        for name in ("ferreus_torch_num_v", "ferreus_torch_num_u", "ferreus_torch_num_w"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ptr]
        lib.ferreus_torch_copy_lists.restype = None
        lib.ferreus_torch_copy_lists.argtypes = [ptr] * 4
        lib.ferreus_torch_free_lists.restype = None
        lib.ferreus_torch_free_lists.argtypes = [ptr]
        _LIB = lib
        return lib


def build_interaction_lists(anchors, levels, parent, children, is_leaf, has_points):
    """The native (v, u, w) pair lists of a cell table: v (nv, 3) rows of
    (target, source, m2l vector id) with sources that hold points, u and w
    (n, 2) rows of (target leaf, source cell), unsorted, u with repeats."""
    lib = build()
    arrays = [np.ascontiguousarray(a, np.int64) for a in (anchors, levels, parent, children)]
    arrays += [np.ascontiguousarray(a, np.uint8) for a in (is_leaf, has_points)]
    ncells, dim = arrays[0].shape
    handle = lib.ferreus_torch_build_lists(ncells, dim, *(a.ctypes.data for a in arrays))
    if not handle:
        raise ValueError(f"the native list builder takes 1 <= d <= 3, got d={dim}")
    try:
        v = np.empty((lib.ferreus_torch_num_v(handle), 3), np.int64)
        u = np.empty((lib.ferreus_torch_num_u(handle), 2), np.int64)
        w = np.empty((lib.ferreus_torch_num_w(handle), 2), np.int64)
        lib.ferreus_torch_copy_lists(handle, v.ctypes.data, u.ctypes.data, w.ctypes.data)
    finally:
        lib.ferreus_torch_free_lists(handle)
    return v, u, w
