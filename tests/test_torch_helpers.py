"""The port's last public helpers against the JAX package's.

``get_a_matrix``, ``dense_matvec_with_gradients`` (``ops/dense.py``),
``kernel_phi`` (``ops/kernels.py``), ``schwarz_ddm_solver``
(``solver/fgmres.py``) and ``native_available`` (``native.py``), on the
same inputs made with numpy from a seed. Tolerances, max |diff| / max
|JAX|:

* ``kernel_phi`` and ``get_a_matrix``, f64: 1e-14 (the JAX closures take
  sqrt and reciprocal from an f32 seed plus Newton steps, the port the
  native operations: a few ulp; ``tests/test_torch_kernels.py``);
* ``dense_matvec_with_gradients``: 1e-13 (sums of 300 terms in another
  order);
* ``schwarz_ddm_solver``: 1e-12 (the same host numpy iteration; the
  preconditioners' products round alike).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ferreus_rbf_tpu import native as jnative
from ferreus_rbf_tpu.interpolant_config import FittingAccuracy as JFittingAccuracy
from ferreus_rbf_tpu.interpolant_config import FittingAccuracyType as JFittingAccuracyType
from ferreus_rbf_tpu.ops import dense as jdense
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.solver import fgmres as jfgmres
from ferreus_rbf_tpu_torch import native as tnative
from ferreus_rbf_tpu_torch import ops as tops
from ferreus_rbf_tpu_torch.interpolant_config import FittingAccuracy, FittingAccuracyType
from ferreus_rbf_tpu_torch.ops import dense as tdense
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.solver import fgmres as tfgmres

KERNEL_NAMES = [kt.value for kt in tk.KernelType]


def _params(mod, name):
    kw = {"base_range": 1.3, "total_sill": 0.9} if "Spheroidal" in name else {}
    return mod.KernelParams(mod.KernelType(name), **kw)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


def _points(d):
    rng = np.random.default_rng(21)
    return rng.random((150, d)), rng.random((300, d)) * 1.5


def test_ops_exports_the_jax_names():
    from ferreus_rbf_tpu import ops as jops

    assert set(tops.__all__) == set(jops.__all__)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_phi_matches_jax(name):
    r = np.concatenate([[0.0, 1e-6], np.random.default_rng(0).uniform(0.0, 3.0, 400)])
    want = np.asarray(jk.kernel_phi(jnp.asarray(r), _params(jk, name)))
    got = tk.kernel_phi(torch.as_tensor(r), _params(tk, name))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) < 1e-14
    assert _rel(tk.kernel_phi(r, _params(tk, name), xp=np),
                jk.kernel_phi(r, _params(jk, name), xp=np)) < 1e-14


@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf",
                                  "Laplacian"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_get_a_matrix_matches_jax(name, d):
    tgt, src = _points(d)
    want = np.asarray(jdense.get_a_matrix(jnp.asarray(tgt), jnp.asarray(src), _params(jk, name)))
    got = tdense.get_a_matrix(torch.as_tensor(tgt), torch.as_tensor(src), _params(tk, name))
    assert got.shape == (150, 300) and got.dtype == torch.float64
    assert _rel(got.numpy(), want) < 1e-14
    host = tops.get_a_matrix(tgt, src, _params(tk, name), xp=np)
    assert _rel(host, jdense.get_a_matrix(tgt, src, _params(jk, name), xp=np)) < 1e-14


@pytest.mark.parametrize("name", ["LinearRbf", "CubicRbf", "Spheroidal3Rbf", "OneOverR2"])
@pytest.mark.parametrize("d", [2, 3])
def test_dense_matvec_with_gradients_matches_jax(name, d):
    """Values (M, nrhs) and gradients (M, nrhs * d), rhs-major, with a
    chunk that cuts the targets unevenly; one target sits on a source."""
    tgt, src = _points(d)
    tgt[7] = src[11]
    w = np.random.default_rng(4).standard_normal((300, 3))
    jv, jg = jdense.dense_matvec_with_gradients(jk.make_kernel(_params(jk, name)), tgt, src, w)
    kernel = tk.make_kernel(_params(tk, name))
    tv, tg = tdense.dense_matvec_with_gradients(kernel, torch.as_tensor(tgt),
                                                torch.as_tensor(src), torch.as_tensor(w),
                                                chunk=64)
    assert tv.shape == (150, 3) and tg.shape == (150, 3 * d)
    assert _rel(tv.numpy(), jv) < 1e-13
    assert _rel(tg.numpy(), jg) < 1e-13
    # the values are dense_matvec's
    assert _rel(tv.numpy(), tdense.dense_matvec(kernel, torch.as_tensor(tgt),
                                                torch.as_tensor(src),
                                                torch.as_tensor(w)).numpy()) < 1e-15


class _Messages:
    """A progress sink that keeps what it is sent."""

    def __init__(self):
        self.msgs = []

    def emit(self, msg):
        self.msgs.append(msg)


def _spd_system(n=40):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    return a, rng.standard_normal((n, 1))


@pytest.mark.parametrize("kind", ["Relative", "Absolute"])
@pytest.mark.parametrize("precon", ["exact", "jacobi", "none"])
def test_schwarz_ddm_solver_matches_jax(kind, precon):
    """The stationary iteration with an exact, a Jacobi (many steps) and no
    preconditioner: the same solution and the same reported steps."""
    a, b = _spd_system()
    m = {"exact": lambda r: np.linalg.solve(a, r),
         "jacobi": lambda r: r / np.diag(a)[:, None], "none": None}[precon]
    seen = {"jax": _Messages(), "torch": _Messages()}
    want = jfgmres.schwarz_ddm_solver(
        lambda v: a @ v, b, m=m, max_iterations=60,
        tolerance=JFittingAccuracy(1e-10, getattr(JFittingAccuracyType, kind)),
        callback=seen["jax"])
    got = tfgmres.schwarz_ddm_solver(
        lambda v: a @ v, b, m=m, max_iterations=60,
        tolerance=FittingAccuracy(1e-10, getattr(FittingAccuracyType, kind)),
        callback=seen["torch"])
    assert got.shape == (40, 1)
    if precon == "none":
        assert not np.any(got) and not np.any(want)
        return
    assert _rel(got, want) < 1e-12
    steps = {k: [(m.iter, m.residual) for m in v.msgs] for k, v in seen.items()}
    assert len(steps["torch"]) == len(steps["jax"]) > 0
    assert [i for i, _ in steps["torch"]] == [i for i, _ in steps["jax"]]
    np.testing.assert_allclose([r for _, r in steps["torch"]], [r for _, r in steps["jax"]],
                               rtol=1e-9, atol=0)
    if precon == "exact":
        np.testing.assert_allclose(a @ got, b, atol=1e-9)


def test_native_available_matches_jax(monkeypatch):
    assert tnative.native_available() is jnative.native_available()
    monkeypatch.setenv("FERREUS_RBF_TPU_NATIVE", "0")
    assert tnative.native_available() is False


@pytest.mark.parametrize("module, name", [
    ("utils", "telemetry"), ("solver", "Domain"), ("ops.dense", "get_pointarray_extents")])
def test_the_jax_names_import_from_both_packages(module, name):
    for package in ("ferreus_rbf_tpu", "ferreus_rbf_tpu_torch"):
        assert getattr(__import__(f"{package}.{module}", fromlist=[name]), name) is not None


@pytest.mark.parametrize("d", [1, 2, 3])
def test_get_pointarray_extents_matches_jax(d):
    pts = np.random.default_rng(23).standard_normal((500, d)) * 1e3
    want = jdense.get_pointarray_extents(pts)
    got = tdense.get_pointarray_extents(pts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_telemetry_is_timing():
    from ferreus_rbf_tpu.utils import telemetry as jtelemetry
    from ferreus_rbf_tpu_torch.solver import Domain
    from ferreus_rbf_tpu_torch.solver.domain import Domain as DomainClass
    from ferreus_rbf_tpu_torch.utils import telemetry, timing

    assert telemetry.enable_global_tracer is timing.enable_global_tracer
    assert all(getattr(telemetry, n) is getattr(timing, n) for n in telemetry.__all__)
    # the JAX module's public names, but for those the port leaves out by
    # rule (XLA traces and jit-cache sizes; see timing.py)
    jax_names = {n for n in vars(jtelemetry) if not n.startswith("_")
                 and callable(getattr(jtelemetry, n))
                 and getattr(getattr(jtelemetry, n), "__module__", "") == jtelemetry.__name__}
    assert jax_names - {"xla_trace", "compiled_program_counts"} <= set(telemetry.__all__)
    assert Domain is DomainClass
