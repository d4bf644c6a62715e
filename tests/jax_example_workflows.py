"""The JAX package's side of tests/test_torch_examples.py, run in a fresh
interpreter: each example workflow's steps through fhmcanalysis_tpu on the
in-repo data, returning the values its port's ``run`` returns, and with
--main the JAX script itself, its path constant pointed at the data.

    python tests/jax_example_workflows.py NAME DATA OUT.pkl [--main]

prints the script's output (with --main), then pickles the workflow's
values to OUT.pkl.
"""

import importlib.util
import os
import pickle
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fhmcanalysis_tpu.win_patch.fhmc_equil as we  # noqa: E402
import fhmcanalysis_tpu.win_patch.fhmc_patch as wp  # noqa: E402
from fhmcanalysis_tpu.binary import check_gibbs_duhem, get_iso, isopleth, parameterize_mesh  # noqa: E402
from fhmcanalysis_tpu.core import segment, solve  # noqa: E402
from fhmcanalysis_tpu.histogram.ntot import histogram  # noqa: E402

# name -> (JAX script, its data path constant)
SCRIPTS = {
    "square_well_phase_diagram": ("square_well_phase_diagram.py", "SRC"),
    "binary_isopleth": ("binary_isopleth.py", "FIXTURE"),
    "combining_simulations": ("combining_simulations.py", "DATA"),
    "multivariable_extrapolation": ("multivariable_extrapolation.py", "DATA"),
    "mutual_diffusion": ("mutual_diffusion.py", "DATA"),
    "square_well_notebook": ("square_well_notebook.py", "SRC"),
}


def script(name: str):
    fname, _ = SCRIPTS[name]
    spec = importlib.util.spec_from_file_location("jax_" + name, os.path.join(ROOT, "examples", fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched(src, per_err, out, **kw):
    seq = wp.get_patch_sequence(src)
    seq = we.test_nebr_equil(seq, per_err=per_err, fname=os.path.join(out, "maxEq"), trust=True)
    composite = os.path.join(out, "composite.nc")
    wp.patch_all_windows(seq, out_fname=composite, log_fname=os.path.join(out, "patch.log"), offset=1, **kw)
    return composite


def dmu2_dirs(data):
    return [(float(d.split("_")[1]), os.path.join(data, d, "composite.nc")) for d in sorted(x for x in os.listdir(data) if "dMu2" in x)]


def square_well_phase_diagram(data, mod):
    with tempfile.TemporaryDirectory() as out:
        h = histogram(patched(data, 10.0, out), mod.BETA_REF, mod.MU_REF, smooth=1)
    h.data["ln(PI)"] = np.concatenate([np.linspace(0, 10, 11), np.linspace(10, 0, 11)[1:], np.linspace(0, 5, 6)[1:], np.linspace(5, 0, 6)[1:]])
    hh, meta = h._hist(), h._meta()
    betas = jnp.linspace(mod.BETA_REF * 0.98, mod.BETA_REF * 1.02, 5)

    def solve_at(beta):
        out, mu_star, err, conv = solve.find_phase_eq_state(
            hh, meta, 1.0e-6, float(mod.MU_REF[0]), beta=beta, dmu=hh.curr_mu[1:] - hh.curr_mu[0], order=1, min_width=2, extrapolate=True
        )
        _, pt = segment.thermo(out, meta, props=True)
        props = segment.phase_props(pt, out.volume)
        return dict(mu_star=mu_star, converged=conv, density=props["density"], x_i=props["x_i"], fe=pt.fe, mask=pt.mask,
                    left=pt.left, right=pt.right, n_phases=pt.n_phases, valid=pt.valid)

    res = {k: np.asarray(v) for k, v in jax.vmap(solve_at)(betas).items()}
    return dict(res, betas=np.asarray(betas))


def binary_isopleth(data, mod):
    sources = [histogram(data, 1.0, [5.0, 0.0], smooth=1), histogram(data, 1.0, [5.0, 1.0], smooth=1)]
    iso = isopleth(sources, beta_target=1.02, order=1)
    Z, (X, Y) = iso.make_grid((-9.0, -6.0), (-4.9, -4.1), (0.15, 0.08))
    valid = Z > 0
    target = float(np.median(Z[valid]))
    pts = get_iso(target, Z, X, Y)
    zz, _, _, _ = iso.zoom(2.0, order=1)
    p_grid = np.where(valid, -np.asarray(iso.data["F.E./kT"]), np.nan)
    _, errs, _, _, _ = check_gibbs_duhem(np.array([float(np.nanmedian(p_grid))]), Z, p_grid, X, Y)[0]
    MU1, DMU2 = np.meshgrid(np.linspace(-3.0, -1.0, 41), np.linspace(-1.0, 1.0, 41))
    Z1, Z2 = np.exp(MU1), np.exp(MU1 + DMU2)
    _, ierrs, _, _, _ = check_gibbs_duhem(np.array([0.3]), Z1 / (Z1 + Z2), Z1 + Z2, MU1, DMU2)[0]
    return dict(Z=Z, X=X, Y=Y, valid=valid, fail_code=np.asarray(iso.data["fail_code"]), fe=np.asarray(iso.data["F.E./kT"]),
                density=np.asarray(iso.data["density"]), target=target, pts=np.asarray(pts), zoom_shape=zz.shape,
                errs=np.asarray(errs), ierrs=np.asarray(ierrs))


def combining_simulations(data, mod):
    histograms = [histogram(f, 1.0 / 1.20, [0.0, d], 10) for d, f in dmu2_dirs(data)]
    tb = 1.0 / 1.10
    iso = isopleth(histograms, beta_target=tb, order=2)
    Z, (X, Y) = iso.make_grid((-6.0, -4.0), (-2.5, 2.5), (0.25, 0.25), m=2.5)
    valid = np.asarray(iso.data["valid"]).astype(bool)
    P = -iso.data["F.E./kT"] / mod.VOLUME / tb
    p_rel = np.abs(P / ((np.exp(tb * X) + np.exp(tb * (X + Y))) / tb) - 1.0)
    isobars = [(p_, None if psi is None else np.asarray(psi), np.asarray(x1_)) for p_, psi, x1_, _, _ in check_gibbs_duhem(np.array([0.02]), Z, P, X, Y)]
    return dict(dmu2=[round(float(h.data["curr_mu"][1]), 2) for h in histograms], Z=Z, X=X, Y=Y, valid=valid,
                fail_code=np.asarray(iso.data["fail_code"]), fe=np.asarray(iso.data["F.E./kT"]), density=np.asarray(iso.data["density"]),
                x1_err=np.abs(Z - 1.0 / (1.0 + np.exp(tb * Y)))[valid], p_rel=p_rel[valid], isobars=isobars)


def multivariable_extrapolation(data, mod):
    mod.DATA = data
    h120, h100 = mod.load(1.20), mod.load(1.00)
    base = h120[0.0]
    base.reweight(mod.MU1)
    return {(order, T): mod.peak_errors(base, sims, 1.0 / T, order) for order in (1, 2) for T, sims in ((1.20, h120), (1.00, h100))}


def mutual_diffusion(data, mod):
    from scipy.interpolate import interp1d

    histograms = [histogram(f, 1.0 / 1.20, [0.0, d], smooth=10) for d, f in dmu2_dirs(data)]
    tb = 1.0 / 1.10
    iso = isopleth(histograms, beta_target=tb, order=2)
    Z, (X, Y) = iso.make_grid((-6.0, -4.0), (-2.0, 2.0), (0.2, 0.2), m=2.5)
    x1 = 0.5
    mu_vals = get_iso(x1, Z, X, Y)
    p = -iso.data["F.E./kT"] / mod.VOLUME / tb
    rho = iso.data["density"]
    phi = np.pi / 6.0 * ((mod.SIG11**3) * x1 * rho + (mod.SIG22**3) * (1.0 - x1) * rho)
    xy = parameterize_mesh(X, Y, phi, p, mu_vals)
    phi_v, p_v = np.array([q[0] for q in xy]), np.array([q[1] for q in xy])
    srt = np.argsort(phi_v)
    p_at = float(interp1d(phi_v[srt], p_v[srt], kind="cubic")(0.02))
    p_exact = 0.02 / (np.pi / 6.0 * ((mod.SIG11**3) * x1 + (mod.SIG22**3) * (1 - x1))) / tb
    isobars = []
    for p_, psi, x1_, _, q_beta in check_gibbs_duhem(np.array([p_at]), Z, p, X, Y, k=5, s=0.001):
        q1 = None
        if psi is not None:
            x1_, q_beta = np.asarray(x1_), np.asarray(q_beta)
            f2 = interp1d(x1_, q_beta, kind="cubic" if len(x1_) > 3 else "linear")
            q1 = float(f2(x1)) * tb if x1_.min() < x1 < x1_.max() else None
        isobars.append((p_, None if psi is None else np.asarray(psi), x1_, q1))
    return dict(Z=Z, X=X, Y=Y, valid=np.asarray(iso.data["valid"]).astype(bool), fail_code=np.asarray(iso.data["fail_code"]),
                fe=np.asarray(iso.data["F.E./kT"]), density=np.asarray(rho), mu_vals=np.asarray(mu_vals), phi_v=phi_v, p_v=p_v,
                p_at=p_at, p_exact=p_exact, target_beta=tb, isobars=isobars)


def square_well_notebook(data, mod):
    with tempfile.TemporaryDirectory() as out:
        hist = histogram(patched(data, 3.0, out, smooth=True), 1.0 / mod.TEMP, [0.0], smooth=10)
    eq = hist.find_phase_eq(lnZ_tol=1.0e-6, mu_guess=-3.94, beta=1.0 / mod.TEMP)
    safe = eq.is_safe()
    eq.thermo()
    vol, beta = eq.data["volume"], eq.data["curr_beta"]
    rows, bounds = [], []
    for p in sorted(eq.data["thermo"]):
        ph = eq.data["thermo"][p]
        rows.append((ph["u"] / ph["ntot"], ph["density"], ph["F.E./kT"], -ph["F.E./kT"] / vol / beta))
        bounds.append(ph["bound_idx"])
    return dict(is_safe=safe, mu_kt=float(np.asarray(eq.data["curr_mu"])[0] * eq.data["curr_beta"]), rows=rows, bounds=bounds)


def main():
    name, data, out = sys.argv[1:4]
    mod = script(name)
    if "--main" in sys.argv[4:]:
        setattr(mod, SCRIPTS[name][1], data)
        mod.main()
        sys.stdout.flush()
    res = globals()[name](data, mod)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
