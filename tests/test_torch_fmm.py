"""The port's FmmTree against the JAX package's, on the CPU.

Same points, kernel, FMM parameters and weights (numpy, from a seed) go
through both packages' trees. The JAX package runs its XLA scan path here
(no Pallas on the CPU), which is true f64; the port's f64 tier is true
f64, so the two agree to rounding: 1e-12 relative (max |diff| / max
|value|). Its f32 tier is held to 1e-5 relative, the f32 tier's bound.
The clustered point set (a dense blob in a sparse background) makes a deep
adaptive tree whose w-lists are non-empty, so M2P runs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm.api import FmmTree as JaxTree
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

N_BLOB, N_BG = 2000, 500


def _clustered():
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(N_BLOB, 3)) + 0.25
    return np.clip(np.concatenate([blob, rng.random((N_BG, 3))]), 0, 1)


def _params(mod, name):
    kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in name else {}
    return mod.KernelParams(mod.KernelType(name), **kw)


def _trees(pts, name, adaptive=True, sparse=True):
    fmm = dict(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    jt = JaxTree(pts, 4, _params(jk, name), adaptive_tree=adaptive, sparse=sparse,
                 params=JFP(compression_type=JFC.ACA, **fmm))
    tt = FmmTree(pts, 4, _params(tk, name), adaptive_tree=adaptive, sparse=sparse,
                 params=FmmParams(compression_type=FmmCompressionType.ACA, **fmm), device="cpu")
    return jt, tt


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module", params=["ThinPlateSplineRbf", "Spheroidal5Rbf"])
def matvecs(request):
    """Both packages' evaluate_device at the sources, f64 and f32."""
    pts = _clustered()
    jt, tt = _trees(pts, request.param)
    jt.prepare_targets(pts, "src")
    tt.prepare_targets(pts, "src")
    n = pts.shape[0]
    n_pad = jt._target_cache["src"]["n_pad"]
    w = np.random.default_rng(5).standard_normal((n_pad, 2))
    out = {"m2p_tiles": tt._m2p_nw, "wtab": tt._target_cache["src"]["wtab"]}
    for prec in ("f64", "f32"):
        out[("jax", prec)] = np.asarray(jt.evaluate_device(jnp.asarray(w), "src", precision=prec))
        out[("port", prec)] = tt.evaluate_device(torch.as_tensor(w[:n]), "src", prec).numpy()
    return out


def test_adaptive_tree_runs_m2p(matvecs):
    assert matvecs["m2p_tiles"] > 0 and matvecs["wtab"] is not None


def test_evaluate_device_f64_matches_jax(matvecs):
    assert _rel(matvecs[("port", "f64")], matvecs[("jax", "f64")]) < 1e-12


def test_evaluate_device_f32_matches_jax(matvecs):
    assert _rel(matvecs[("port", "f32")], matvecs[("jax", "f64")]) < 1e-5
    assert _rel(matvecs[("port", "f32")], matvecs[("jax", "f32")]) < 1e-5


def test_uniform_tree_matches_jax():
    """The config-2 layout (uniform tree, no w-lists), LinearRbf, 4 RHS."""
    pts = np.random.default_rng(9).random((3000, 3))
    jt, tt = _trees(pts, "LinearRbf", adaptive=False)
    jt.prepare_targets(pts, "src")
    tt.prepare_targets(pts, "src")
    assert tt._target_cache["src"]["wtab"] is None
    n_pad = jt._target_cache["src"]["n_pad"]
    w = np.random.default_rng(10).standard_normal((n_pad, 4))
    want = np.asarray(jt.evaluate_device(jnp.asarray(w), "src", precision="f64"))
    got = tt.evaluate_device(torch.as_tensor(w[:3000]), "src", "f64").numpy()
    assert _rel(got, want) < 1e-12


def test_2d_adaptive_tree_matches_jax():
    """d = 2 (quadtree, 7 reference M2L vectors): TPS, f64."""
    rng = np.random.default_rng(15)
    pts = np.clip(np.concatenate([rng.normal(scale=0.03, size=(1500, 2)) + 0.7,
                                  rng.random((500, 2))]), 0, 1)
    jt, tt = _trees(pts, "ThinPlateSplineRbf")
    jt.prepare_targets(pts, "src")
    tt.prepare_targets(pts, "src")
    n_pad = jt._target_cache["src"]["n_pad"]
    w = rng.standard_normal((n_pad, 1))
    want = np.asarray(jt.evaluate_device(jnp.asarray(w), "src", precision="f64"))
    got = tt.evaluate_device(torch.as_tensor(w[:2000]), "src", "f64").numpy()
    assert _rel(got, want) < 1e-12


def test_evaluate_off_source_matches_jax_and_dense():
    """``evaluate`` on a non-sparse tree at targets that are not sources
    (the interpolator's evaluation path): equal to the JAX tree to
    rounding, and within the p = 4 truncation (1e-3) of a dense sum."""
    pts = _clustered()
    targets = np.random.default_rng(12).random((700, 3))
    extents = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    fmm = dict(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    name = "CubicRbf"
    jt = JaxTree(pts, 4, _params(jk, name), adaptive_tree=True, sparse=False,
                 extents=extents, params=JFP(compression_type=JFC.ACA, **fmm))
    tt = FmmTree(pts, 4, _params(tk, name), adaptive_tree=True, sparse=False,
                 extents=extents, params=FmmParams(compression_type=FmmCompressionType.ACA, **fmm),
                 device="cpu")
    w = np.random.default_rng(13).standard_normal((pts.shape[0], 1))
    jt.set_weights(w)
    tt.set_weights(w)
    want = np.asarray(jt.evaluate(w, targets))
    got = tt.evaluate(w, targets)
    assert _rel(got, want) < 1e-12
    dense = tk.make_kernel(_params(tk, name), xp=np).pair(targets, pts) @ w
    assert _rel(got, dense) < 1e-3


def test_outside_target_raises():
    pts = np.random.default_rng(14).random((200, 2))
    tt = FmmTree(pts, 3, _params(tk, "LinearRbf"), params=FmmParams(
        interpolation_order=3, max_points_per_cell=16, epsilon=1e-3),
        extents=np.array([0.0, 0.0, 1.0, 1.0]), device="cpu")
    tt.set_weights(np.ones((200, 1)))
    from ferreus_rbf_tpu_torch.ops.fmm.tree import PointOutsideTreeError

    with pytest.raises(PointOutsideTreeError):
        tt.evaluate(np.ones((200, 1)), np.array([[0.5, 0.5], [10.0, 0.5]]))
