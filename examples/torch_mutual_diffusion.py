"""Mutual-diffusion workflow: thermodynamic factor along an iso-composition path, on the PyTorch port.

The port of examples/mutual_diffusion.py, which mirrors the reference
notebook example/ntot/mutual_diffusion/mutual_diffusion.ipynb: build an
isopleth surface at a target temperature (kernel K3 on the card), trace
the iso-x1 contour, parameterize pressure against packing fraction along
it, and extract Q_1 = x1 dmu1/dx1 (the Gibbs-Duhem lhs spline by-product,
gc_binary.pyx:566-635) at the target composition.  On the binary ideal
gas with the notebook's size asymmetry in the packing fraction
(sig22 = 1.5) the closed forms

    x_1 = 0.5 contour  <=>  dMu_2 = 0
    P(phi) = phi / (pi/6 (sig11^3 x1 + sig22^3 (1-x1))) / beta

hold.  Same steps, prints and acceptance checks.

Run: python examples/torch_mutual_diffusion.py [--device cpu] [--data DIR]

--data is the temperature's directory of dMu2_<value>/composite.nc files
(default: the JAX script's; reading them needs h5py).  run() also takes
the composites in memory ({dMu_2: read_composite dict}).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch_example_io as ex
from scipy.interpolate import interp1d

from fhmcanalysis_torch.binary import check_gibbs_duhem, get_iso, isopleth, parameterize_mesh

DATA = ex.jax_data_path("mutual_diffusion.py", "DATA")
VOLUME = 512.0
SIG11, SIG22 = 1.00, 1.50  # notebook's fluid asymmetry (mutual_diffusion.ipynb cell 3)
X1 = 0.5
PACKING_FRAC = 0.02


def run(inputs, device=None, engine="auto") -> dict:
    """The workflow on the T = 1.20 simulations (a directory or
    {dMu_2: read_composite dict}); ``engine`` is make_grid's."""
    beta_ref = 1.0 / 1.20
    histograms = [ex.load(src, beta_ref, [0.0, dmu2], 10, device) for dmu2, src in ex.dmu2_sources(inputs).items()]
    target_beta = 1.0 / 1.10
    iso = isopleth(histograms, beta_target=target_beta, order=2)
    Z, (X, Y) = iso.make_grid((-6.0, -4.0), (-2.0, 2.0), (0.2, 0.2), m=2.5, engine=engine)

    # iso-composition path: for the ideal gas x1 = 0.5 <=> dMu2 = 0
    mu_vals = get_iso(X1, Z, X, Y)

    # pressure against packing fraction along the path
    p = -iso.data["F.E./kT"] / VOLUME / target_beta
    rho = iso.data["density"]
    phi = np.pi / 6.0 * ((SIG11**3) * X1 * rho + (SIG22**3) * (1.0 - X1) * rho)
    xy = parameterize_mesh(X, Y, phi, p, mu_vals)
    phi_v = np.array([q[0] for q in xy])
    p_v = np.array([q[1] for q in xy])
    srt = np.argsort(phi_v)
    p_at = float(interp1d(phi_v[srt], p_v[srt], kind="cubic")(PACKING_FRAC))
    p_exact = PACKING_FRAC / (np.pi / 6.0 * ((SIG11**3) * X1 + (SIG22**3) * (1 - X1))) / target_beta

    # Q_1 = x1 dmu1/dx1 at the target composition from the GD splines
    isobars = []
    for p_, psi, x1_, _, q_beta in check_gibbs_duhem(np.array([p_at]), Z, p, X, Y, k=5, s=0.001):
        q1 = None
        if psi is not None:
            x1_, q_beta = np.asarray(x1_), np.asarray(q_beta)
            f2 = interp1d(x1_, q_beta, kind="cubic" if len(x1_) > 3 else "linear")
            q1 = float(f2(X1)) * target_beta if x1_.min() < X1 < x1_.max() else None
        isobars.append((p_, None if psi is None else np.asarray(psi), x1_, q1))
    return dict(Z=Z, X=X, Y=Y, valid=np.asarray(iso.data["valid"]).astype(bool), fail_code=np.asarray(iso.data["fail_code"]),
                fe=np.asarray(iso.data["F.E./kT"]), density=np.asarray(rho), mu_vals=np.asarray(mu_vals), phi_v=phi_v, p_v=p_v,
                p_at=p_at, p_exact=p_exact, target_beta=target_beta, isobars=isobars)


def report(res: dict):
    dmu2_along = res["mu_vals"][:, 1]
    print("iso x1=%.2f: %d points, |dMu2| <= %.3f" % (X1, len(res["mu_vals"]), np.abs(dmu2_along).max()))
    print("P(phi=%.2f) = %.6f  (exact %.6f, rel err %.1e)" % (PACKING_FRAC, res["p_at"], res["p_exact"], abs(res["p_at"] / res["p_exact"] - 1)))
    for p_, psi, _, q1 in res["isobars"]:
        if psi is not None and q1 is not None:
            print("P = %.5f  T = %.3f  max|psi| = %.3f  Q_1 = %.4f" % (p_, 1.0 / res["target_beta"], np.max(np.abs(psi[1:])), q1))


def check(res: dict):
    """The JAX script's acceptance checks: the contour at dMu_2 = 0, P(phi)
    against the closed form, and Q_1 = 1/beta of the ideal mixture."""
    assert len(res["mu_vals"]) >= 5
    assert np.abs(res["mu_vals"][:, 1]).max() < 0.05
    assert res["phi_v"].min() < PACKING_FRAC < res["phi_v"].max()
    assert abs(res["p_at"] / res["p_exact"] - 1) < 5e-3
    for _, psi, x1_, q1 in res["isobars"]:
        assert psi is not None, "isobar escaped the grid"
        assert x1_.min() < X1 < x1_.max()
        # ideal mixture: mu_1 = ln(x1 P beta)/beta + const  =>  Q_1 = 1/beta
        assert abs(q1 * res["target_beta"] - 1.0) < 0.2


def main():
    args = ex.parse_args(__doc__, DATA)
    res = run(args.data, args.device)
    report(res)
    check(res)
    print("OK mutual_diffusion")


if __name__ == "__main__":
    main()
