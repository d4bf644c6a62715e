"""PyTorch port: the example scripts ported from examples/, run as a user
runs them, each in a fresh interpreter on the CPU.

examples/torch_joint_binary_surface.py is held against the JAX package's
examples/joint_binary_surface.py: the same assertions pass inside the
script, and the printed table and counts are the same lines.  With
--shards 4 it also runs the sweep split over four CPU shards and asserts
that it matches the unsharded sweep.

The six workflows that read the reference's data (not in the repository)
run on in-repo data: the square-well trees of tests/torch_windows.py
(SW_DIAGRAM, SW_NOTEBOOK), the n31 composite at max_order 2 as the binary
isopleth's fixture, and the closed-form binary ideal gas of
tests/torch_composites.py (IDEAL_GAS).  Each port's ``run`` on the CPU is
held against the same workflow through the JAX package
(tests/jax_example_workflows.py, in a fresh interpreter):

* mu* within 1e-9 (the JAX package's own bar between two solver
  engines), segmentation, validity and fail codes equal;
* floats (surfaces, coexistence states, contours, peak errors) within
  1e-12 relative to max(1, |value|), the bar of
  tests/test_torch_isopleth.py at order 1, and its order-2 bar of 1e-10
  on the order-2 workflows; measured worst 8.2e-15;
* the Gibbs-Duhem residuals within 1e-11: check_gibbs_duhem's splines
  through the isobar's contour amplify the surfaces' differences
  (measured worst 2.0e-12, binary_isopleth; 1.2e-13 on the order-2
  surfaces).

Where the JAX script's own acceptance checks hold on that data, both
scripts also run end to end and print the same lines.  They do not hold
for two: square_well_notebook's published values belong to the
reference's T = 0.90 tree, and multivariable_extrapolation's order-2
peak error at (T, dMu_2) = (1.20, 2.94) is 1.12 on the exact ideal gas
against its bar of 0.5: the order-2 Taylor remainder of
N ln(1 + kappa exp(beta dMu_2)) moves the peak value by lambda (e^c - 1 - c),
with c ~ 0.14 per particle and lambda ~ 100 particles at the peak (1.09 at
kappa = 1), so no binary ideal gas in closed form with the combining
notebook's volume passes it.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
TESTS = os.path.dirname(os.path.abspath(__file__))
WORKFLOWS = ("square_well_phase_diagram", "binary_isopleth", "combining_simulations", "multivariable_extrapolation", "mutual_diffusion", "square_well_notebook")
END_TO_END = ("square_well_phase_diagram", "binary_isopleth", "combining_simulations", "mutual_diffusion")
ORDER2 = ("combining_simulations", "mutual_diffusion", "multivariable_extrapolation")
TIMEOUT = 240
GIBBS_DUHEM = 1e-11


def _run(code, timeout):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, cwd=EXAMPLES)
    assert res.returncode == 0, "%s\n%s" % (res.stdout[-2000:], res.stderr[-2000:])
    return res.stdout.splitlines()


def test_torch_joint_binary_surface():
    port = _run(
        "import sys, runpy; sys.argv = ['torch_joint_binary_surface.py', '--device', 'cpu', '--shards', '4'];"
        "runpy.run_path(%r, run_name='__main__')" % os.path.join(EXAMPLES, "torch_joint_binary_surface.py"),
        timeout=120,
    )
    ref = _run(
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import runpy; runpy.run_path(%r, run_name='__main__')" % os.path.join(EXAMPLES, "joint_binary_surface.py"),
        timeout=120,
    )
    assert any(line.startswith("sharded over GridMesh(") and line.endswith("matches the unsharded sweep") for line in port)
    table = [line for line in port if not line.startswith("sharded over")]
    assert table[:-1] == ref[:-1]  # the header and the rows
    assert table[-1].split("; on ")[0] == ref[-1].split("; one launch")[0]  # the counts


# ---- the reference-notebook workflows on in-repo data ----


def _write_data(root):
    """{workflow: its --data} under root."""
    import torch_composites as TC
    import torch_windows as TW

    from fhmcanalysis_torch.io import write_composite

    TW.write_sw_diagram(os.path.join(root, "sw_diagram"))
    TW.write_sw_notebook(os.path.join(root, "sw_notebook"))
    d, meta, _ = TC.cell("n31", 1, max_order=2)
    raw = TC.composite_raw(d, meta["nspec"], 2)
    fixture = os.path.join(root, "n31.nc")
    write_composite(fixture, raw["lnpi"], raw["op"], raw["mom"], raw["volume"], raw["nspec"], raw["max_order"])
    ig = TC.write_ideal_gas(os.path.join(root, "ideal_gas"))
    t120 = os.path.join(ig, "T_1.20")
    return {"square_well_phase_diagram": os.path.join(root, "sw_diagram"), "binary_isopleth": fixture, "combining_simulations": t120,
            "multivariable_extrapolation": ig, "mutual_diffusion": t120, "square_well_notebook": os.path.join(root, "sw_notebook")}


class _Proc:
    """A fresh interpreter started now and read when needed, each with its
    own timeout."""

    def __init__(self, args, out=None):
        self.out = out
        self.p = subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=EXAMPLES)

    def lines(self):
        try:
            stdout, stderr = self.p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.communicate()
            raise
        assert self.p.returncode == 0, "%s\n%s" % (stdout[-2000:], stderr[-2000:])
        return stdout.splitlines()

    def values(self):
        self.lines()
        with open(self.out, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def workflows(tmp_path_factory):
    """Every JAX workflow (with --main where its checks hold) and every
    end-to-end port script, started together: (data, {name: JAX proc},
    {name: port proc})."""
    root = str(tmp_path_factory.mktemp("example_data"))
    data = _write_data(root)
    jax_procs = {
        n: _Proc([os.path.join(TESTS, "jax_example_workflows.py"), n, data[n], os.path.join(root, n + ".pkl")] + (["--main"] if n in END_TO_END else []),
                 out=os.path.join(root, n + ".pkl"))
        for n in WORKFLOWS
    }
    port_procs = {n: _Proc([os.path.join(EXAMPLES, "torch_%s.py" % n), "--device", "cpu", "--data", data[n]]) for n in END_TO_END}
    yield data, jax_procs, port_procs
    for p in list(jax_procs.values()) + list(port_procs.values()):
        if p.p.poll() is None:
            p.p.kill()
            p.p.communicate()


def _port(name):
    import importlib.util

    sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location("torch_" + name, os.path.join(EXAMPLES, "torch_%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, what):
    """Equal where integer, bool or not finite; within tol relative to
    max(1, |want|) elsewhere."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "biuO" or g.dtype.kind in "biuO":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=what)
    np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=what)
    d = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
    assert np.max(d, initial=0.0) <= tol, (what, float(np.max(d)))


@pytest.mark.parametrize("name", WORKFLOWS)
def test_workflow_against_jax(name, workflows):
    data, jax_procs, _ = workflows
    want = jax_procs[name].values()
    mod = _port(name)
    got = mod.run(data[name], "cpu")
    tol = 1e-10 if name in ORDER2 else 1e-12
    if name == "square_well_phase_diagram":
        assert np.abs(got["mu_star"] - want["mu_star"]).max() <= 1e-9
        for k in ("converged", "mask", "left", "right", "n_phases", "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("betas", "fe", "density", "x_i"):
            _close(got[k], want[k], tol, k)
        mod.check(got)
    elif name == "multivariable_extrapolation":
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].keys() == want[key].keys()
            for d in want[key]:
                assert got[key][d][1] == want[key][d][1], (key, d)
                assert abs(got[key][d][0] - want[key][d][0]) <= tol * max(1.0, abs(want[key][d][0])), (key, d)
        assert abs(got[(2, 1.20)][2.94][0] - 1.116) < 1e-3  # the exact ideal gas's order-2 remainder (module docstring)
    elif name == "square_well_notebook":
        assert got["is_safe"] == want["is_safe"] and got["bounds"] == want["bounds"]
        assert abs(got["mu_kt"] - want["mu_kt"]) <= 1e-9
        _close(np.array(got["rows"]), np.array(want["rows"]), tol, "rows")
        (_, _, fe1, _), (_, _, fe2, _) = got["rows"]
        assert got["is_safe"] and abs(fe1 - fe2) < 1e-3
    else:
        for k in ("valid", "fail_code"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("Z", "X", "Y", "fe", "density"):
            _close(got[k], want[k], tol, k)
        if name == "binary_isopleth":
            assert got["zoom_shape"] == want["zoom_shape"]
            _close(got["target"], want["target"], tol, "target")
            _close(got["pts"], want["pts"], tol, "pts")
            for k in ("errs", "ierrs"):
                _close(got[k], want[k], GIBBS_DUHEM, k)
        if name == "combining_simulations":
            assert got["dmu2"] == want["dmu2"]
            for k in ("x1_err", "p_rel"):
                _close(got[k], want[k], tol, k)
        if name == "mutual_diffusion":
            for k in ("mu_vals", "phi_v", "p_v", "p_at", "p_exact"):
                _close(got[k], want[k], tol, k)
        if name in ("combining_simulations", "mutual_diffusion"):
            assert len(got["isobars"]) == len(want["isobars"])
            for a, b in zip(got["isobars"], want["isobars"]):
                for i, (x, y) in enumerate(zip(a, b)):
                    if y is not None:
                        _close(x, y, GIBBS_DUHEM if i == 1 else tol, "isobar[%d]" % i)
        mod.check(got)


@pytest.mark.parametrize("name", END_TO_END)
def test_workflow_end_to_end(name, workflows):
    """The port's script and the JAX script, run as a user runs them on the
    same data: both pass their acceptance checks and print the same
    lines."""
    _, jax_procs, port_procs = workflows
    assert _printed(port_procs[name].lines()) == _printed(jax_procs[name].lines())


def _printed(lines):
    """The lines, with a printed relative error at rounding level (mutual
    diffusion's P(phi) against its closed form: 4.4e-16 from JAX, 8.9e-16
    from the port) read as that level."""
    return [re.sub(r"rel err ([0-9.]+e-\d+)", lambda m: "rel err " + ("< 1e-12" if float(m.group(1)) < 1e-12 else m.group(1)), line) for line in lines]
