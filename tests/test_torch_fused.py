"""The port's fused FGMRES (``solver/fused.py``) against the JAX package's,
on the CPU.

One system throughout, the one of ``tests/test_solver.py``'s fused test:
1,500 random 3-D points (seed 21), ThinPlateSpline, DDM leaf 128, coarse
ratio 0.5, coarse threshold 400, the iterative path forced. On the CPU the
cycle runs eagerly, with a host check of each step's flag. Tolerances:

* the Givens rotation within 1 ulp of the JAX package's and of the host
  loop's ``fgmres.givens_rotation``;
* the coarse solve on the device and the fused preconditioner within
  1e-10 relative of the host solve and ``schwarz_preconditioner``: the same
  factors, another order of the triangular solves;
* one f64 restart cycle within 1e-8 relative of the JAX package's;
* the fits: the solver's tolerance 1e-6, ``evaluate_at_source`` within
  1e-5 of max |values| and the coefficients of two fits within
  1e-2 * (max |c| + 1), the JAX package's bounds for its fused test.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.solver import fused as jfused
from ferreus_rbf_tpu.solver import iterative as jiterative
from ferreus_rbf_tpu.utils.common import get_cheb_cube_scaling_factors as jscaling
from ferreus_rbf_tpu_torch.progress import SolverIteration
from ferreus_rbf_tpu_torch.solver import domain as pdomain
from ferreus_rbf_tpu_torch.solver import fgmres as pfgmres
from ferreus_rbf_tpu_torch.solver import fused as pfused
from ferreus_rbf_tpu_torch.solver import iterative as piterative
from ferreus_rbf_tpu_torch.utils import timing
from ferreus_rbf_tpu_torch.utils.common import get_cheb_cube_scaling_factors as pscaling

FUSED_ENV = "FERREUS_RBF_TPU_FUSED"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    rng = np.random.default_rng(21)
    pts = rng.random((1500, 3))
    vals = np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1]) + 0.5 * pts[:, 2]
    return pts, vals


def _settings(mod, kernel_type=None):
    return mod.InterpolantSettings(
        kernel_type=kernel_type or mod.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=mod.FittingAccuracy(1e-6, mod.FittingAccuracyType.Relative))


def _params(mod, factor_dtype="f32"):
    return mod.Params(
        ddm_params=mod.DDMParams(leaf_threshold=128, coarse_ratio=0.5, coarse_threshold=400),
        naive_solve_threshold=0, precond_factor_dtype=factor_dtype)


def _port_fit(**kw):
    pts, vals = _data()
    return prt.RBFInterpolator(pts, vals, _settings(prt), _params(prt), device="cpu", **kw)


def _systems(mod, factor_dtype):
    """(DeviceSystem, FusedSystem) of one package over the test's system,
    without a fit."""
    pts, vals = _data()
    kw = {"device": "cpu"} if mod is prt else {}
    rbfi = mod.RBFInterpolator(pts, vals, _settings(mod), _params(mod, factor_dtype),
                               _skip_solve=True, **kw)
    scaling = pscaling if mod is prt else jscaling
    rbfi.translation_factor, rbfi.scale_factor = scaling(rbfi.points)
    iterative, fused = (piterative, pfused) if mod is prt else (jiterative, jfused)
    system = iterative.DeviceSystem(rbfi)
    return system, fused.FusedSystem(system)


@pytest.fixture(scope="module")
def port_system():
    system, fs = _systems(prt, "f32")
    assert fs.ok and len(system.ddm_tree.levels) == 3  # two fine levels and the coarse
    return system, fs


@pytest.fixture(scope="module")
def fits():
    """The fit three ways: the port's fused path (its cycles' stats and
    progress messages kept), the JAX package's fused path, and the port's
    host loop (``FERREUS_RBF_TPU_FUSED=0``)."""
    out = {"cycles": [], "messages": [], "ok": {}}
    cycle = pfused.FusedSystem.cycle

    def kept(self, *args, **kw):
        res = cycle(self, *args, **kw)
        out["cycles"].append(res[2])
        out["ok"]["port"] = self.ok
        return res

    tracer = timing.enable_global_tracer()
    pfused.FusedSystem.cycle = kept
    try:
        out["port"] = _port_fit(progress_callback=prt.Progress(out["messages"].append))
    finally:
        pfused.FusedSystem.cycle = cycle
        timing.disable_global_tracer()
    out["events"], out["counters"] = tracer.events, tracer.counters

    init = jfused.FusedSystem.__init__

    def spy(self, system):
        init(self, system)
        out["ok"]["jax"] = self.ok

    jfused.FusedSystem.__init__ = spy
    try:
        pts, vals = _data()
        out["jax"] = jrt.RBFInterpolator(pts, vals, _settings(jrt), _params(jrt))
    finally:
        jfused.FusedSystem.__init__ = init

    tracer = timing.enable_global_tracer()
    os.environ[FUSED_ENV] = "0"
    try:
        out["host"] = _port_fit()
    finally:
        del os.environ[FUSED_ENV]
        timing.disable_global_tracer()
    out["host_events"] = tracer.events
    return out


def _ulps(a, b):
    """|a - b| in units of the last place of the larger magnitude."""
    return abs(a - b) / np.spacing(max(abs(a), abs(b)))


def test_givens_matches_jax_and_host_loop():
    """(a) dlartg semantics on every pair of f, g in {0, ±1, ±2.5, ±1e-200,
    ±1e200}: within 1 ulp of the JAX package's rotation and of the host
    loop's scaled one."""
    values = [0.0] + [s * v for v in (1.0, 2.5, 1e-200, 1e200) for s in (1.0, -1.0)]
    for f in values:
        for g in values:
            got = [float(t) for t in pfused._givens_device(torch.tensor(f, dtype=torch.float64),
                                                           torch.tensor(g, dtype=torch.float64))]
            jax_rot = [float(t) for t in jfused._givens_device(jnp.float64(f), jnp.float64(g))]
            host = pfgmres.givens_rotation(f, g)
            for want in (jax_rot, host):
                assert all(_ulps(a, b) <= 1.0 for a, b in zip(got, want)), (f, g, got, want)


@pytest.mark.parametrize("add_poly", [True, False])
def test_device_coarse_solve_matches_host(port_system, add_poly):
    """(b) The coarse solve from the Cholesky factor on the device against
    ``DDMTree.solve_coarse``'s host solve, with and without the tail."""
    system, fs = port_system
    rng = np.random.default_rng(5)
    res = torch.as_tensor(rng.standard_normal((system.n + system.m, 1)))
    got = fs._solve_coarse(res, add_poly)
    want = system.ddm_tree.solve_coarse(res, add_poly)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    assert bool((got[system.n:] != 0).any()) == add_poly


def test_fused_precon_matches_schwarz(port_system):
    """(c) The fused preconditioner against ``schwarz_preconditioner`` with
    the host coarse solve."""
    system, fs = port_system
    rng = np.random.default_rng(6)
    rg = torch.as_tensor(rng.standard_normal((system.n + system.m, 1)))
    got, want = fs.precon(rg), system.precon(rg)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("tol", [1e-3, 1e-12])
def test_f64_cycle_matches_jax(monkeypatch, tol):
    """(d) One f64 restart cycle from the same r, with f64 Schwarz factors
    in both packages: the steps run (jf) equal, res_g, res_r and hist within
    1e-8 relative. tol 1e-3 stops the cycle early (jf 4), 1e-12 runs it whole.

    The preconditioner's restricted matvecs run in f32 in both packages;
    two f32 FMM sums in two orders differ by ~1e-7, and the preconditioner
    carries that into the cycle at ~1e-3 (measured: hist 8e-5 to 1.4e-3
    apart). Both packages' restricted matvecs are switched to f64 here, so
    that the test holds the cycle itself; the f32 path is held by the fits.
    """
    psys, pfs = _systems(prt, "f64")
    jsys, jfs = _systems(jrt, "f64")
    assert pfs.ok and jfs.ok
    monkeypatch.setattr(psys, "matvec_partial",
                        functools.partial(piterative.DeviceSystem.matvec_partial, psys,
                                          precision="f64"))

    def partial_f64(self, state, w, level_key):
        wp = w[: self.n]
        idx = state["lvl_idx"][self._k(level_key)]
        vals = self._fmm_eval(state, wp, self._k(("lvl", level_key)), "f64")
        rows = vals + self.nugget * wp[idx]
        if self.m:
            rows = rows + state["monomial"][idx] @ w[self.n:]
        return jnp.zeros_like(w).at[idx].set(rows)

    monkeypatch.setattr(jfused._FusedOps, "_matvec_partial", partial_f64)
    monkeypatch.setattr(jfs.ops, "_cycles", {})  # no cycle traced with f32 partials

    r = np.random.default_rng(3).standard_normal((psys.n + psys.m, 1))
    r[psys.n:] = 0.0
    beta = float(np.linalg.norm(r))
    rt = torch.as_tensor(r)
    _, _, got = pfs.cycle("f64", False, 5, rt, torch.zeros_like(rt), rt, beta, tol)
    b = jnp.asarray(r)
    _, _, want = jfs.cycle_fn("f64", False, 5)(jfs.state, b, jnp.zeros_like(b), b,
                                               jnp.float64(beta), jnp.float64(tol))
    want = np.asarray(want)
    assert got[2] == want[2] == (4 if tol == 1e-3 else 5)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0.0)


def test_fit_three_ways(fits):
    """(e) Port fused, JAX fused and port host loop each converge, honour
    the data within 1e-5 of max |values|, and agree pairwise."""
    pts, vals = _data()
    assert fits["ok"] == {"port": True, "jax": True}
    done = [e for e in fits["events"] if e["event"] == "solve_done"]
    host_done = [e for e in fits["host_events"] if e["event"] == "solve_done"]
    assert done[-1]["converged"] and done[-1]["residual"] <= 1e-6
    assert host_done[-1]["converged"] and host_done[-1]["residual"] <= 1e-6
    assert not any(e["event"] == "fused_system" for e in fits["host_events"])
    scale = float(np.max(np.abs(vals)))
    coefs = {}
    for key in ("port", "jax", "host"):
        fit = fits[key]
        resid = float(np.max(np.abs(fit.evaluate_at_source(add_nugget=True) - vals)))
        assert resid < 1e-5 * scale, (key, resid)
        coefs[key] = fit.coefficients.point_coefficients
    for a, b in (("port", "jax"), ("port", "host"), ("jax", "host")):
        assert float(np.max(np.abs(coefs[a] - coefs[b]))) < 1e-2 * (
            float(np.max(np.abs(coefs[b]))) + 1), (a, b)


def _host_loop_fit(**kw):
    os.environ[FUSED_ENV] = "0"
    try:
        return _port_fit(**kw)
    finally:
        del os.environ[FUSED_ENV]


@pytest.mark.parametrize("gate", ["coarse", "recompute", "bytes"])
def test_gates_keep_the_host_loop(fits, monkeypatch, gate):
    """(f) Each gate sets ``ok`` False and the fit takes the host loop, with
    the host loop's coefficients bit for bit.

    coarse: at this size every kernel's coarse system is SPD (LinearRbf's
    too, measured), so the coarse factorisation is made to fall back to LDL
    the way ``_CholeskyOrLU`` does when scipy's ``cho_factor`` finds the
    matrix indefinite. recompute: every Schwarz level recomputes its
    factors. bytes: the factor-byte limit at 0."""
    if gate == "coarse":
        def indefinite(*_a, **_k):
            raise pdomain.scipy.linalg.LinAlgError("not positive definite")

        monkeypatch.setattr(pdomain.scipy.linalg, "cho_factor", indefinite)
    elif gate == "recompute":
        monkeypatch.setenv("FERREUS_RBF_TPU_DDM_RECOMPUTE", "1")
        monkeypatch.setenv("FERREUS_RBF_TPU_DDM_MEM_GB", "1e-6")
    else:
        monkeypatch.setattr(pfused, "FACTOR_BYTES_MAX", 0)
    tracer = timing.enable_global_tracer()
    try:
        got = _port_fit()
    finally:
        timing.disable_global_tracer()
    event = [e for e in tracer.events if e["event"] == "fused_system"]
    assert len(event) == 1 and not event[0]["ok"]
    assert event[0]["gate"].split()[0] == {"coarse": "coarse", "recompute": "a",
                                           "bytes": "factor"}[gate]
    assert not any(e["event"] == "fused_solve" for e in tracer.events)
    want = fits["host"] if gate == "bytes" else _host_loop_fit()
    assert np.array_equal(got.coefficients.point_coefficients,
                          want.coefficients.point_coefficients)
    assert np.array_equal(got.coefficients.poly_coefficients,
                          want.coefficients.poly_coefficients)


def test_progress_callbacks_follow_hist(fits):
    """(g) One ``SolverIteration`` per inner iteration, numbered from 1 in
    each inner solve, with the residuals of the cycles' hist in order."""
    msgs = [m for m in fits["messages"] if isinstance(m, SolverIteration)]
    hist = [float(r) for stats in fits["cycles"] for r in stats[3 : 3 + int(stats[2])]]
    stats = [e for e in fits["events"] if e["event"] == "fused_solve"][-1]
    assert len(msgs) == len(hist) == fits["counters"]["fgmres_iters"] > 0
    assert [m.residual for m in msgs] == hist
    assert msgs[0].iter == 1
    assert stats["host_pulls"] == stats["cycles"] == len(fits["cycles"])
