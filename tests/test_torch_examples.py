"""The port's examples (``ferreus_rbf_tpu_torch/examples``) on the CPU.

Three of them run in this process, in a temporary working directory, with
``--device cpu``: ``isosurface_sphere`` (the golden 540 vertices and 1076
facets), ``boundary_closure`` (its printed lines equal to the JAX example's,
run in the same way: both run the same host RMT) and ``franke_2d`` (the
direct 2-D fit; its two errors below 1e-6 and 1e-2 and within 1% of the
JAX example's). The albatite examples fit 35,801 3-D points and run on
the card (``chip_smoke.py`` phase 11), not here. ``scripts/fit_at_scale.py``
runs at 3,000 points. A static check holds
every file of the examples and scripts free of imports of ``jax`` and of
the JAX package.
"""

import ast
import importlib
import json
import os
import re
import runpy
import sys

import pytest
import torch

import ferreus_rbf_tpu_torch

PORT = os.path.dirname(os.path.abspath(ferreus_rbf_tpu_torch.__file__))
REPO = os.path.dirname(PORT)
JAX_EXAMPLES = os.path.join(REPO, "examples")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_example(name, capsys, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    importlib.import_module(f"ferreus_rbf_tpu_torch.examples.{name}").main(["--device", "cpu"])
    return capsys.readouterr().out


def _jax_example(name, capsys, cwd, monkeypatch):
    """The JAX package's example, as ``python examples/<name>.py`` runs it."""
    monkeypatch.chdir(cwd)
    monkeypatch.syspath_prepend(JAX_EXAMPLES)
    monkeypatch.setattr(sys, "argv", [name])
    runpy.run_path(os.path.join(JAX_EXAMPLES, f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def test_isosurface_sphere_golden_counts(capsys, tmp_path, monkeypatch):
    out = _port_example("isosurface_sphere", capsys, tmp_path, monkeypatch)
    assert "sphere mesh: 540 vertices, 1076 facets" in out
    assert (tmp_path / "sphere.obj").stat().st_size > 0


def test_boundary_closure_prints_the_jax_examples_lines(capsys, tmp_path, monkeypatch):
    (tmp_path / "port").mkdir()
    got = _port_example("boundary_closure", capsys, tmp_path / "port", monkeypatch)
    want = _jax_example("boundary_closure", capsys, tmp_path, monkeypatch)
    lines = got.splitlines()
    assert len(lines) == 3 and all("V=" in ln and "watertight=" in ln for ln in lines)
    assert got == want
    for mode in ("None", "ClosePositive", "CloseNegative"):
        assert (tmp_path / "port" / f"sphere_{mode}.obj").exists()


def _errors(out):
    resid = float(re.search(r"max residual at sources: (\S+)", out).group(1))
    err = float(re.search(r"max grid error vs analytic Franke: (\S+)", out).group(1))
    return resid, err


def test_franke_2d_matches_the_jax_example(capsys, tmp_path, monkeypatch):
    (tmp_path / "port").mkdir()
    got = _errors(_port_example("franke_2d", capsys, tmp_path / "port", monkeypatch))
    want = _errors(_jax_example("franke_2d", capsys, tmp_path, monkeypatch))
    assert got[0] < 1e-6 and got[1] < 1e-2
    assert abs(got[1] - want[1]) <= 1e-2 * want[1]
    assert (tmp_path / "port" / "franke_2d_interpolated.csv").stat().st_size > 0


def test_fit_at_scale_on_the_cpu(capsys):
    """``scripts/fit_at_scale.py`` at 3,000 points (the direct solve, so
    the dense f64 oracle sees an exact fit): its JSON line and the oracle's
    residual at 256 sources, to 1e-10 of max |values|. The iterative path's
    fields (the solver's residual, the weights' budget) come from the card's
    runs at 1M and 3M."""
    from ferreus_rbf_tpu_torch.scripts import fit_at_scale

    fit_at_scale.main(["3000", "--device", "cpu", "--oracle-sample", "256"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 3000 and out["order"] == "default" and out["seed"] == 11
    assert out["oracle_n_sample"] == 256 and out["true_residual_rel_max"] < 1e-10
    assert out["refinement_rounds"] == 0 and "solver_residual_rel" not in out
    assert out["weights_per_chunk"] == {"p2m": False, "l2p": False}
    assert "peak_device_gb" not in out and out["fit_s"] > 0


def test_every_jax_example_has_a_port():
    names = {f for f in os.listdir(JAX_EXAMPLES) if f.endswith(".py")}
    assert len(names - {"common.py"}) == 9
    assert names <= set(os.listdir(os.path.join(PORT, "examples")))


def _sources():
    out = []
    for sub in ("examples", "scripts"):
        folder = os.path.join(PORT, sub)
        out += [os.path.join(sub, f) for f in sorted(os.listdir(folder)) if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources())
def test_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(open(os.path.join(PORT, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "ferreus_rbf_tpu"), f"{path} imports {name}"
