"""Binary-mixture isopleth surface and iso-composition tracing on the PyTorch port.

The port of examples/binary_isopleth.py, which mirrors the reference
notebook example/ntot/binary_square_well/phase_behavior.ipynb: build an
isopleth object from histograms at different dMu_2, compute the
(mu_1, dMu_2) surface in one batched pass (kernel K3 on the card), trace
an iso-x1 contour, and check Gibbs-Duhem consistency.  Same steps, prints
and acceptance checks.

Run: python examples/torch_binary_isopleth.py [--device cpu] [--data FILE]

--data is the composite netCDF file both sources are read from (default:
the JAX script's fixture; reading it needs h5py).  run() also takes the
composite in memory (a ``read_composite`` dict).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch_example_io as ex

from fhmcanalysis_torch.binary import check_gibbs_duhem, get_iso, isopleth

FIXTURE = ex.jax_data_path("binary_isopleth.py", "FIXTURE")


def run(inputs, device=None, engine="auto") -> dict:
    """The workflow on the fixture (a file or a ``read_composite`` dict);
    ``engine`` is make_grid's ("auto": K3 on the card, "torch" its plain
    version)."""
    # sources measured at different dMu_2 (here: the fixture re-tagged)
    sources = [
        ex.load(inputs, 1.0, [5.0, 0.0], 1, device),  # dMu2 = -5
        ex.load(inputs, 1.0, [5.0, 1.0], 1, device),  # dMu2 = -4
    ]
    iso = isopleth(sources, beta_target=1.02, order=1)
    Z, (X, Y) = iso.make_grid((-9.0, -6.0), (-4.9, -4.1), (0.15, 0.08), engine=engine)
    valid = Z > 0

    # trace the median iso-composition line
    target = float(np.median(Z[valid]))
    pts = get_iso(target, Z, X, Y)

    # persist + resample
    with tempfile.TemporaryDirectory(prefix="fhmc_example_") as out:
        iso.dump(os.path.join(out, "isopleth.json"))
    zz, _, _, _ = iso.zoom(2.0, order=1)

    # Gibbs-Duhem along an isobar of the (re-tagged, inconsistent) surface,
    # -F.E./kT standing in for the pressure grid (gc_binary.pyx:566-635)
    p_grid = np.where(valid, -np.asarray(iso.data["F.E./kT"]), np.nan)
    p_iso = float(np.nanmedian(p_grid))
    _, errs, _, _, _ = check_gibbs_duhem(np.array([p_iso]), Z, p_grid, X, Y)[0]

    # ... and on an exact ideal binary mixture: P*v = z1 + z2, z_i =
    # exp(beta mu_i), x1 = z1/(z1+z2)
    beta = 1.0
    MU1, DMU2 = np.meshgrid(np.linspace(-3.0, -1.0, 41), np.linspace(-1.0, 1.0, 41))
    Z1, Z2 = np.exp(beta * MU1), np.exp(beta * (MU1 + DMU2))
    _, ierrs, _, _, _ = check_gibbs_duhem(np.array([0.3]), Z1 / (Z1 + Z2), Z1 + Z2, MU1, DMU2)[0]
    return dict(Z=Z, X=X, Y=Y, valid=valid, fail_code=np.asarray(iso.data["fail_code"]), fe=np.asarray(iso.data["F.E./kT"]),
                density=np.asarray(iso.data["density"]), target=target, pts=np.asarray(pts), zoom_shape=zz.shape,
                errs=np.asarray(errs), ierrs=np.asarray(ierrs))


def report(res: dict):
    Z, valid, pts = res["Z"], res["valid"], res["pts"]
    print("grid %s: %d/%d valid, x1 in [%.4f, %.4f]" % (Z.shape, valid.sum(), Z.size, Z[valid].min(), Z[valid].max()))
    print("x1 = %.4f isopleth: %d points, mu_1 range [%.2f, %.2f]" % (res["target"], len(pts), pts[:, 0].min(), pts[:, 0].max()))
    print("zoomed surface:", res["zoom_shape"])
    print("Gibbs-Duhem median |residual| (re-tagged fixture, inconsistent"
          " by construction): %.2e" % np.median(np.abs(res["errs"])))
    print("Gibbs-Duhem median |residual| (ideal mixture): %.2e" % float(np.median(np.abs(res["ierrs"]))))


def check(res: dict):
    """The JAX script's acceptance checks (the reference notebook's
    consistency properties)."""
    Z, valid = res["Z"], res["valid"]
    assert valid.sum() > 0.5 * Z.size, "the coexistence region must cover most of the grid (fixture gives ~57%)"
    assert 0.0 < Z[valid].min() and Z[valid].max() < 1.0, "x1 must be a mole fraction"
    assert (res["fail_code"][~valid] != 0).all() and (res["fail_code"][valid] == 0).all()
    assert len(res["pts"]) > 3, "iso-composition trace must produce a contour"
    assert res["zoom_shape"][0] > Z.shape[0] and res["zoom_shape"][1] > Z.shape[1], "zoom must refine the lattice"
    # the re-tagged sources are not consistent: a large residual is the
    # correct verdict, the check must run and report it
    errs = res["errs"]
    assert errs.size > 3, "isobar trace too short for a Gibbs-Duhem check"
    assert np.isfinite(errs).all()
    resid = float(np.median(np.abs(res["ierrs"])))
    assert resid < 1e-2, resid


def main():
    args = ex.parse_args(__doc__, FIXTURE)
    res = run(args.data, args.device)
    report(res)
    check(res)
    print("all acceptance checks passed")


if __name__ == "__main__":
    main()
