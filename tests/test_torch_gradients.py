"""The port's gradient path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances (max |diff| / max |reference| unless stated):

* ``grad_scale_r2``, all ten kernel types, torch and numpy twins against
  the JAX numpy twin: 1e-14 elementwise relative (the same formulas; a few
  ulp of pow and sqrt), and exact zeros at coincident points;
* ``near_field_grad`` (CPU tensors: the plain version) against the Pallas
  kernel ``p2p_pairlist_df64_grad`` in interpret mode: 1e-10, the df64
  tier's ~1e-13 with room for the interpreter's sqrt artifact (measured
  ~2e-14 here, ~8e-13 for the inverse powers). The Pallas kernel's
  spheroidal *values* are 3.4e-8 off the JAX f64 closures themselves (its
  df64 phi, measured here), so for that type the values are held to the
  JAX numpy twin's dense sum (1e-13) and to the Pallas kernel at 1e-7;
* at coincident points against the JAX numpy twin's dense sum: 1e-13;
* ``FmmTree.evaluate_with_gradients`` against the JAX tree's true-f64 scan
  path: 1e-12 (the same f64 arithmetic in another order);
* leaf mode against full mode: 1e-12 absolute (``tests/test_fmm.py``);
  gradients against central differences: 5e-4 of the scale;
* ``RBFInterpolator.evaluate_with_gradients`` with linear and quadratic
  drift against the JAX interpolator: 1e-11.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import df64 as jdf
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm import p2p_pallas as pp
from ferreus_rbf_tpu.ops.fmm.api import FmmTree as JaxTree
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops import polynomials as tpoly
from ferreus_rbf_tpu_torch.ops.fmm import api as tapi
from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

KERNEL_NAMES = [kt.value for kt in tk.KernelType]


def _params(mod, name):
    kw = {"base_range": 1.1, "total_sill": 0.8} if "Spheroidal" in name else {}
    return mod.KernelParams(mod.KernelType(name), **kw)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------ gradient factors
def _r2_probe(name):
    rng = np.random.default_rng(0)
    r = np.concatenate([[0.0, 1e-9, 1e-4], rng.uniform(0.0, 3.0, 600)])
    r2 = r * r
    if "Spheroidal" in name:
        order = int(name[len("Spheroidal")])
        c = tk.spheroidal_coefficients(order, 1.1, 0.8)
        r2 = np.concatenate([r2, [c["ip2"] / c["s2"]]])  # the inflexion point
    return r2


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_grad_scale_matches_jax(name):
    r2 = _r2_probe(name)
    want = jk.make_kernel(_params(jk, name), xp=np).grad_scale_r2(r2)
    got_np = tk.make_kernel(_params(tk, name), xp=np).grad_scale_r2(r2)
    got_t = tk.make_kernel(_params(tk, name)).grad_scale_r2(torch.as_tensor(r2)).numpy()
    assert want[0] == 0.0 and want[1] == 0.0  # r2 = 0 and r2 = 1e-18 <= eps
    for got in (got_np, got_t):
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def test_pair_with_grad_matches_jax():
    rng = np.random.default_rng(1)
    tgt, src = rng.random((30, 3)), rng.random((40, 3))
    src[:5] = tgt[:5]  # coincident pairs
    for name in ("LinearRbf", "Spheroidal5Rbf"):
        jkern = jk.make_kernel(_params(jk, name), xp=np)
        want_k, want_g = jkern.pair_with_grad(tgt, src)
        got_k, got_g = tk.make_kernel(_params(tk, name)).pair_with_grad(
            torch.as_tensor(tgt), torch.as_tensor(src))
        assert got_g.shape == (30, 40, 3)
        np.testing.assert_allclose(got_k.numpy(), want_k, rtol=1e-14, atol=0)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-14, atol=1e-300)


# ------------------------------------------------------------- near field
R, T, S, L, U, NRHS, S_LIVE = 6, 16, 128, 5, 4, 2, 100


@pytest.fixture(scope="module")
def ops():
    """The operands of ``tests/test_torch_near_field.py``."""
    rng = np.random.default_rng(7)
    tgt = rng.random((R, T, 3)) - 0.5
    src = np.zeros((L + 1, 3, S))
    src[:L, :, :S_LIVE] = rng.random((L, 3, S_LIVE)) - 0.5
    w = np.zeros((L + 1, NRHS, S))
    w[:L, :, :S_LIVE] = rng.standard_normal((L, NRHS, S_LIVE))
    nbr = rng.integers(0, L, (U, R)).astype(np.int32)
    nbr[U - 1, ::2] = L  # sentinel entries
    cnt = rng.integers(1, U + 1, R).astype(np.int32)
    cnt[0] = 0
    return {"tgt": tgt, "src": src, "w": w, "nbr": nbr, "cnt": cnt}


def _torch_ops(o, with_cnt=False):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    return (t(o["tgt"]), t(o["src"]), t(o["w"]), t(o["nbr"]),
            t(o["cnt"]) if with_cnt else None)


def _pair_list(nbr):
    """Sorted (row, tile) pairs, one sentinel pair per row + the true pairs,
    ``first`` flagging each row's first pair (as ``api.py`` builds them)."""
    rows_true = np.nonzero(nbr.T != L)
    rows = np.concatenate([np.arange(R), rows_true[0]])
    tiles = np.concatenate([np.full(R, L), nbr.T[rows_true]])
    order = np.argsort(rows, kind="stable")
    rows, tiles = rows[order], tiles[order]
    first = np.zeros(rows.size, np.int32)
    first[0] = 1
    first[1:] = rows[1:] != rows[:-1]
    return (jnp.asarray(rows.astype(np.int32)), jnp.asarray(tiles.astype(np.int32)),
            jnp.asarray(first))


@pytest.mark.parametrize(
    "name", ["LinearRbf", "ThinPlateSplineRbf", "CubicRbf", "Spheroidal5Rbf", "OneOverR4"])
def test_near_field_grad_matches_p2p_pairlist_df64_grad(ops, name):
    th, tl = jdf.from_f64(jnp.asarray(ops["tgt"]))
    sh, sl = jdf.from_f64(jnp.asarray(ops["src"]))
    planes, _ = jdf.slice_planes(*jdf.from_f64(jnp.asarray(ops["w"])), (2,), 6)
    oh, ol, gh, gl = pp.p2p_pairlist_df64_grad(
        th, tl, sh, sl, jnp.transpose(planes, (1, 0, 2, 3)), *_pair_list(ops["nbr"]),
        kparams=_params(jk, name), nsl=6, keep=6, interpret=True)
    want_v = np.asarray(jdf.to_f64(oh, ol)).transpose(0, 2, 1)
    # (R, d*nrhs, T) dim-major -> (R, T, nrhs, d)
    want_g = np.asarray(jdf.to_f64(gh, gl)).reshape(R, 3, NRHS, T).transpose(0, 3, 2, 1)
    before = dict(nf.LAUNCHES)
    got_v, got_g = nf.near_field_grad(*_torch_ops(ops), kparams=_params(tk, name))
    assert nf.LAUNCHES == before  # CPU tensors run the plain version
    assert got_g.shape == (R, T, NRHS, 3)
    assert _rel(got_g.numpy(), want_g) < 1e-10
    if "Spheroidal" in name:
        assert _rel(got_v.numpy(), _dense_grad(name, ops, False)[0]) < 1e-13
        assert _rel(got_v.numpy(), want_v) < 1e-7
    else:
        assert _rel(got_v.numpy(), want_v) < 1e-10


def _dense_grad(name, ops, with_cnt):
    """The near field with gradients as an explicit loop over (row, tile)
    pairs of the JAX numpy twin's dense blocks."""
    k = jk.make_kernel(_params(jk, name), xp=np)
    vals = np.zeros((R, T, NRHS))
    grads = np.zeros((R, T, NRHS, 3))
    for r in range(R):
        for u in range(ops["cnt"][r] if with_cnt else U):
            tile = ops["nbr"][u, r]
            if tile == L:
                continue
            kmat, gmat = k.pair_with_grad(ops["tgt"][r], ops["src"][tile].T)
            vals[r] += kmat @ ops["w"][tile].T
            grads[r] += np.einsum("tsd,ks->tkd", gmat, ops["w"][tile])
    return vals, grads


@pytest.mark.parametrize("name", ["LinearRbf", "Spheroidal5Rbf", "Laplacian"])
def test_near_field_grad_at_coincident_points(ops, name):
    """Targets that are exact copies of sources: the r2 <= eps guards give
    zero gradient (and TPS/inverse powers zero value) for those pairs;
    counts mask entries past a row's count and a count-0 row stays 0."""
    o = dict(ops)
    o["tgt"] = ops["tgt"].copy()
    o["tgt"][1, :4] = ops["src"][ops["nbr"][0, 1], :, :4].T
    o["tgt"][2, 5:9] = ops["src"][ops["nbr"][1, 2], :, 10:14].T
    for with_cnt in (False, True):
        got_v, got_g = nf.near_field_grad(*_torch_ops(o, with_cnt), kparams=_params(tk, name))
        want_v, want_g = _dense_grad(name, o, with_cnt)
        assert np.isfinite(got_g.numpy()).all()
        assert _rel(got_v.numpy(), want_v) < 1e-13
        assert _rel(got_g.numpy(), want_g) < 1e-13
        if with_cnt:
            assert float(got_v[0].abs().max()) == 0.0 == float(got_g[0].abs().max())


def test_near_field_grad_rejects_bad_operands(ops):
    tgt, src, w, nbr, _ = _torch_ops(ops)
    kp = _params(tk, "LinearRbf")
    with pytest.raises(TypeError):
        nf.near_field_grad(tgt.float(), src.float(), w.float(), nbr, kparams=kp)
    with pytest.raises(TypeError):
        nf.near_field_grad(tgt, src, w, nbr.long(), kparams=kp)
    with pytest.raises(ValueError):
        nf.near_field_grad(tgt, src, w[:, :, :-1], nbr, kparams=kp)


# ------------------------------------------------------------ FmmTree
def _clustered():
    """The points of ``tests/test_torch_cuda.py``: a dense blob in a sparse
    background, so that P2P, M2P (w-lists) and P2L (x-lists) all run."""
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    return np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)


FMM = dict(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)


@pytest.fixture(scope="module")
def clustered_gradients():
    pts = _clustered()
    w = np.random.default_rng(5).standard_normal((pts.shape[0], 2))
    out = {}
    for name in ("Spheroidal5Rbf", "LinearRbf"):
        jt = JaxTree(pts, 4, _params(jk, name), adaptive_tree=True, sparse=True,
                     params=JFP(compression_type=JFC.ACA, **FMM))
        tt = FmmTree(pts, 4, _params(tk, name), adaptive_tree=True, sparse=True,
                     params=FmmParams(compression_type=FmmCompressionType.ACA, **FMM),
                     device="cpu")
        jt.set_weights(w)
        out[name] = {"jax": jt.evaluate_with_gradients(w, pts, reuse_key="src"),
                     "port": tt.evaluate_with_gradients(w, pts, reuse_key="src"),
                     "tree": tt}
    return out


@pytest.mark.parametrize("name", ["Spheroidal5Rbf", "LinearRbf"])
def test_fmm_gradients_match_jax(clustered_gradients, name):
    case = clustered_gradients[name]
    tree = case["tree"]
    assert tree._m2p_nw > 0 and tree.p2l_cells.size > 0  # M2P and P2L run
    (want_v, want_g), (got_v, got_g) = case["jax"], case["port"]
    assert got_v.shape == (2500, 2) and got_g.shape == (2500, 6)
    assert _rel(got_v, np.asarray(want_v)) < 1e-12
    assert _rel(got_g, np.asarray(want_g)) < 1e-12


def test_fmm_gradients_need_a_gradient_kernel():
    pts = np.random.default_rng(2).random((300, 3))
    tree = FmmTree(pts, 3, _params(tk, "CubicRbf"), params=FmmParams(
        interpolation_order=3, max_points_per_cell=32, epsilon=1e-3), device="cpu")
    tree.kernel_np.supports_gradients = False
    w = np.ones((300, 1))
    with pytest.raises(tapi.KernelDoesNotSupportGradientsError):
        tree.evaluate_with_gradients(w, pts)
    with pytest.raises(RuntimeError, match="set_local_coefficients"):
        FmmTree(pts, 3, _params(tk, "CubicRbf"), device="cpu").evaluate_leaves(w, pts)


def test_leaf_mode_matches_full_mode():
    """After ``set_local_coefficients`` the leaf-only calls equal the full
    ones (``tests/test_fmm.py``); gradients agree with central differences
    of the full evaluation."""
    rng = np.random.default_rng(21)
    pts = rng.random((700, 3))
    w = rng.standard_normal((700, 2))
    tree = FmmTree(pts, 5, _params(tk, "LinearRbf"), sparse=False, params=FmmParams(
        interpolation_order=5, max_points_per_cell=48, epsilon=1e-5), device="cpu")
    tree.set_weights(w)
    tree.set_local_coefficients(w)
    targets = rng.random((120, 3))
    full_v, full_g = tree.evaluate_with_gradients(w, targets)
    leaf_v, leaf_g = tree.evaluate_leaves_with_gradients(w, targets)
    np.testing.assert_allclose(leaf_v, full_v, rtol=0, atol=1e-12)
    np.testing.assert_allclose(leaf_g, full_g, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tree.evaluate_leaves(w, targets), full_v, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tree.evaluate(w, targets), full_v, rtol=0, atol=1e-12)
    eps = 1e-6
    for axis in range(3):
        tp = targets.copy()
        tp[:, axis] += eps
        tm = targets.copy()
        tm[:, axis] -= eps
        fd = (tree.evaluate(w, tp) - tree.evaluate(w, tm)) / (2 * eps)
        got = leaf_g.reshape(120, 2, 3)[:, :, axis]
        assert np.max(np.abs(got - fd)) < 5e-4 * max(1.0, np.max(np.abs(fd)))


# ------------------------------------------------------------ interpolator
DRIFT_CASES = {
    # linear drift: TPS in 2-D (its minimum drift)
    "tps_2d_linear": (2, "ThinPlateSpline", "Linear"),
    # quadratic drift: cubic in 3-D
    "cubic_3d_quadratic": (3, "Cubic", "Quadratic"),
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_interpolator_gradients_match_jax(case):
    d, kernel, drift = DRIFT_CASES[case]
    pts = jrt.generate_random_points(300, d, seed=4)
    vals = np.sin(3.0 * pts).sum(axis=1)
    jfit = jrt.RBFInterpolator(pts, vals, jrt.InterpolantSettings(
        kernel_type=jrt.RBFKernelType(kernel), drift=jrt.Drift(drift)))
    settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType(kernel),
                                       drift=prt.Drift(drift))
    model = prt.RBFInterpolator.from_numpy_state(
        jfit.points, jfit.point_values, settings, jfit.coefficients.point_coefficients,
        jfit.coefficients.poly_coefficients, jfit.translation_factor, jfit.scale_factor,
        device="cpu")
    assert model.coefficients.poly_coefficients.shape[0] == {2: 3, 3: 10}[d]
    targets = np.random.default_rng(6).random((200, d)) * 1.2 - 0.1
    want_v, want_g = jfit.evaluate_with_gradients(targets)
    got_v, got_g = model.evaluate_with_gradients(targets)
    assert got_v.shape == want_v.shape == (200,) and got_g.shape == want_g.shape == (200, d)
    assert _rel(got_v, want_v) < 1e-11
    assert _rel(got_g, want_g) < 1e-11
    # the leaf-only evaluator gives the same numbers
    model.build_evaluator()
    jfit.build_evaluator()
    inside = targets[(targets >= pts.min(0)).all(1) & (targets <= pts.max(0)).all(1)]
    got_v, got_g = model.evaluate_targets_with_gradients(inside)
    want_v, want_g = jfit.evaluate_targets_with_gradients(inside)
    assert _rel(got_v, want_v) < 1e-11
    assert _rel(got_g, want_g) < 1e-11
    assert _rel(model.evaluate_targets(inside), jfit.evaluate_targets(inside)) < 1e-11


def test_monomial_gradients_match_jax():
    from ferreus_rbf_tpu.ops import polynomials as jpoly

    rng = np.random.default_rng(8)
    pts = rng.random((50, 3))
    coef = rng.standard_normal((10, 2))
    t, s = np.array([0.5, 0.4, 0.6]), np.array([0.6, 0.7, 0.5])
    for degree, basis in ((1, 4), (2, 10)):
        want = jpoly.evaluate_monomial_gradients(pts, coef[:basis], degree, t, s)
        got = tpoly.evaluate_monomial_gradients(pts, coef[:basis], degree, t, s)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ devices
def test_entry_points_without_a_card_raise(monkeypatch):
    """No device named and no CUDA card: raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(3).random((60, 3))
    settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prt.RBFInterpolator(pts, pts[:, 0], settings)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prt.RBFInterpolator.from_numpy_state(pts, pts[:, 0], settings, np.zeros(60),
                                             np.zeros((1, 1)), np.zeros(3), np.ones(3))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FmmTree(pts, 3, _params(tk, "LinearRbf"))
    assert FmmTree(pts, 3, _params(tk, "LinearRbf"), device="cpu").device.type == "cpu"
