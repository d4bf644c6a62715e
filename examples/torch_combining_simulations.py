"""Combining simulations at different dMu_2 into one isopleth surface on the PyTorch port.

The port of examples/combining_simulations.py, which mirrors the reference
notebook example/ntot/binary_square_well/combining_simulations.ipynb:
grand-canonical simulations at one temperature and several dMu_2 are
combined (each grid cell brackets its two nearest sources,
Taylor-extrapolates both to the target (beta, dMu_2) and blends them with
inverse-distance^m weights, gc_binary.pyx:355-476; kernel K3 on the card),
then the surface is held to the binary ideal gas's closed forms,

    x_1 = 1 / (1 + exp(beta * dMu_2)),   P = (z_1 + z_2) / beta,

and checked for Gibbs-Duhem consistency.  Same steps, prints and
acceptance checks.

Run: python examples/torch_combining_simulations.py [--device cpu] [--data DIR]

--data is the temperature's directory of dMu2_<value>/composite.nc files
(default: the JAX script's; reading them needs h5py).  run() also takes
the composites in memory ({dMu_2: read_composite dict}).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch_example_io as ex

from fhmcanalysis_torch.binary import check_gibbs_duhem, isopleth

DATA = ex.jax_data_path("combining_simulations.py", "DATA")
VOLUME = 512.0  # simulation cell of the provided data
DELTA = (0.25, 0.25)  # the notebook's lattice


def mixing_weights(dl, dr, m):
    """The inverse-distance^m blend the grid uses for its two bracketing
    sources (gc_binary.pyx:457-460)."""
    return dr**m / (dl**m + dr**m)


def run(inputs, device=None, engine="auto", delta=DELTA) -> dict:
    """The workflow on the T = 1.20 simulations (a directory or
    {dMu_2: read_composite dict}); ``engine`` is make_grid's ("auto": K3
    on the card, "torch" its plain version), ``delta`` its lattice."""
    beta_ref = 1.0 / 1.20
    histograms = [ex.load(src, beta_ref, [0.0, dmu2], 10, device) for dmu2, src in ex.dmu2_sources(inputs).items()]

    # the surface at a DIFFERENT temperature (T = 1.10)
    target_beta = 1.0 / 1.10
    iso = isopleth(histograms, beta_target=target_beta, order=2)
    Z, (X, Y) = iso.make_grid((-6.0, -4.0), (-2.5, 2.5), delta, m=2.5, engine=engine)
    valid = np.asarray(iso.data["valid"]).astype(bool)

    # composition and pressure against the exact ideal-gas answers
    x1_exact = 1.0 / (1.0 + np.exp(target_beta * Y))
    P = -iso.data["F.E./kT"] / VOLUME / target_beta
    z1 = np.exp(target_beta * X)
    z2 = np.exp(target_beta * (X + Y))
    p_rel = np.abs(P / ((z1 + z2) / target_beta) - 1.0)

    # Gibbs-Duhem consistency along an isobar inside the valid region
    isobars = [(p_, None if psi is None else np.asarray(psi), np.asarray(x1_)) for p_, psi, x1_, _, _ in check_gibbs_duhem(np.array([0.02]), Z, P, X, Y)]
    return dict(dmu2=[round(float(h.data["curr_mu"][1]), 2) for h in histograms], Z=Z, X=X, Y=Y, valid=valid,
                fail_code=np.asarray(iso.data["fail_code"]), fe=np.asarray(iso.data["F.E./kT"]), density=np.asarray(iso.data["density"]),
                x1_err=np.abs(Z - x1_exact)[valid], p_rel=p_rel[valid], isobars=isobars)


def report(res: dict):
    print("sources: %d simulations at dMu2 = %s" % (len(res["dmu2"]), res["dmu2"]))
    print("grid %s: %d/%d valid cells" % (res["Z"].shape, res["valid"].sum(), res["Z"].size))
    print("x1 error vs analytic: max %.2e mean %.2e" % (res["x1_err"].max(), res["x1_err"].mean()))
    print("P relative error vs analytic: max %.2e" % res["p_rel"].max())
    for p_, psi, x1_ in res["isobars"]:
        if psi is not None:
            print("isobar P=%.3f: %d points, max |x1 dmu1/dx1 + (1-x1) dmu2/dx1| = %.3f" % (p_, len(x1_), np.max(np.abs(psi[1:]))))


def check(res: dict):
    """The JAX script's acceptance checks: the notebook's weight-function
    cells, the valid share, x_1 and P against the closed forms, and the
    Gibbs-Duhem residual along the isobar."""
    d = np.linspace(1e-3, np.pi - 1e-3, 1000)
    for m in [1, 5, 100]:
        w = mixing_weights(d, np.max(d) - d, m)
        assert abs(w[0] - 1.0) < 1e-2 and abs(w[-1]) < 1e-2  # nearer wins
        assert abs(mixing_weights(np.pi / 2, np.pi / 2, m) - 0.5) < 1e-12
    assert np.all(np.diff(mixing_weights(d, np.max(d) - d, 5)) <= 1e-12)
    assert res["valid"].sum() > 0.7 * res["Z"].size
    assert res["x1_err"].max() < 0.02
    assert res["p_rel"].max() < 0.02
    for _, psi, _ in res["isobars"]:
        assert psi is not None, "isobar escaped the grid"
        assert np.max(np.abs(psi[1:])) < 0.5  # first entry trimmed, as the notebook does


def main():
    args = ex.parse_args(__doc__, DATA)
    res = run(args.data, args.device)
    report(res)
    check(res)
    print("OK combining_simulations")


if __name__ == "__main__":
    main()
