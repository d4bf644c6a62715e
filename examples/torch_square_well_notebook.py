"""The reference's square-well notebook, end to end, on the PyTorch port.

The port of examples/square_well_notebook.py, which reproduces
example/ntot/square_well/example.ipynb on its T = 0.90 production window
tree (22 windows): discover -> equilibration gate (per_err=3.0, trust) ->
patch (offset=1, smooth) -> composite -> the histogram class's
find_phase_eq(mu_guess=-3.94) -> thermo, then the notebook's own printed
coexistence outputs as acceptance values.  Same steps, prints and
acceptance checks; on any other tree the published values do not hold.

Published values (example.ipynb cell 14 output):
    mu_coexist/kT = -4.47264655
    Phase 1: U/N = -0.22851744836  density = 0.0144348254033
             F.E./kT = -9.28506932479  P = 0.0114630485491
    Phase 2: U/N = -5.49071646599  density = 0.692967266981
             F.E./kT = -9.28546354084  P = 0.0114635352356

Run: python examples/torch_square_well_notebook.py [--device cpu] [--data TREE]

--data is the FHMCSimulation window tree (default: the JAX script's);
patching it writes a composite netCDF file, which needs h5py.  run() also
takes the patched composite in memory (a ``read_composite`` dict).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch_example_io as ex

TEMP = 0.90
SRC = ex.jax_data_path("square_well_notebook.py", "SRC") % TEMP


def run(inputs, device=None) -> dict:
    """The notebook's cells on a window tree or a patched composite."""
    # cell 5: discover, gate on equilibration, patch; cell 7: load
    hist = ex.load_patched(inputs, 1.0 / TEMP, [0.0], 10, device, per_err=3.0, offset=1, patch_smooth=True)
    # cells 12 + 14: solve for coexistence, thermo
    eq = hist.find_phase_eq(lnZ_tol=1.0e-6, mu_guess=-3.94, beta=1.0 / TEMP)
    safe = eq.is_safe()
    eq.thermo()
    mu_kt = float(np.asarray(eq.data["curr_mu"])[0] * eq.data["curr_beta"])
    vol, beta = eq.data["volume"], eq.data["curr_beta"]
    rows, bounds = [], []
    for p in sorted(eq.data["thermo"]):
        ph = eq.data["thermo"][p]
        rows.append((ph["u"] / ph["ntot"], ph["density"], ph["F.E./kT"], -ph["F.E./kT"] / vol / beta))
        bounds.append(ph["bound_idx"])
    return dict(is_safe=safe, mu_kt=mu_kt, rows=rows, bounds=bounds)


def report(res: dict):
    print("mu_coexist/kT =", res["mu_kt"])
    for p, row in enumerate(res["rows"]):
        print("Phase %d: U/N=%.9f density=%.10f F.E./kT=%.9f P=%.10f" % ((p + 1,) + row))


def check(res: dict):
    """The JAX script's acceptance checks: the notebook's printed outputs,
    pinned (loose where the solver endpoint legitimately differs within
    lnZ_tol)."""
    assert res["is_safe"], "max(lnPI) too close to the edge"
    mu_kt = res["mu_kt"]
    assert abs(mu_kt - (-4.47264655)) < 1e-6, mu_kt
    (u1, rho1, fe1, p1), (u2, rho2, fe2, p2) = res["rows"]
    assert abs(u1 - (-0.22851744836)) < 1e-6, u1
    assert abs(rho1 - 0.0144348254033) < 1e-7, rho1
    assert abs(fe1 - (-9.28506932479)) < 1e-6, fe1
    assert abs(p1 - 0.0114630485491) < 1e-7, p1
    assert abs(u2 - (-5.49071646599)) < 1e-6, u2
    assert abs(rho2 - 0.692967266981) < 1e-7, rho2
    assert abs(fe2 - (-9.28546354084)) < 1e-4, fe2
    assert abs(p2 - 0.0114635352356) < 1e-6, p2
    # both phases at coexistence: free energies equal to ~lnZ_tol
    assert abs(fe1 - fe2) < 1e-3, (fe1, fe2)


def main():
    args = ex.parse_args(__doc__, SRC)
    res = run(args.data, args.device)
    report(res)
    check(res)
    print("all notebook acceptance values reproduced")


if __name__ == "__main__":
    main()
