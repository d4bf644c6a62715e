"""Vapor-liquid phase diagram workflow (single component) on the PyTorch port.

The port of examples/square_well_phase_diagram.py, which mirrors the
reference notebook example/ntot/square_well/example.ipynb: patch windows ->
composite -> coexistence across a temperature range.  The per-beta scipy
loop of the reference is one batched solve: core.solve.find_phase_eq_state
over the beta batch (on the card its objective runs K2's paired mode, and
the coexistence states of every beta are built in one pass), then
segment.thermo + phase_props of the returned batch, where the JAX script
vmaps the same two steps.  Same steps, printed table and acceptance
checks.

Run: python examples/torch_square_well_phase_diagram.py [--device cpu] [--data TREE]

--data is the FHMCSimulation window tree (default: the JAX script's);
patching it writes a composite netCDF file, which needs h5py.  run() also
takes the patched composite in memory (a ``read_composite`` dict).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch_example_io as ex

from fhmcanalysis_torch.core import segment, solve

SRC = ex.jax_data_path("square_well_phase_diagram.py", "SRC")
BETA_REF = 1.0 / 1.5
MU_REF = [2.0, 2.0]
# The JAX script's two-phase stand-in for the patched lnPI (its bundled
# miniature tree is single-phase at these conditions).
STAND_IN = np.concatenate([np.linspace(0, 10, 11), np.linspace(10, 0, 11)[1:], np.linspace(0, 5, 6)[1:], np.linspace(5, 0, 6)[1:]])


def run(inputs, device=None, engine="auto") -> dict:
    """The workflow on a window tree or a patched composite (module
    docstring); ``engine`` is the solver's ("auto": K2's paired mode on
    the card, "torch" its plain version)."""
    # 1-2. discover, gate on equilibration, patch; load the composite
    h = ex.load_patched(inputs, BETA_REF, MU_REF, 1, device, per_err=10.0, offset=1)
    h.data["ln(PI)"] = STAND_IN
    hh, meta = h._hist(), h._meta()

    # 3. one batched solve: coexistence at every temperature, then the
    # thermodynamics of the returned batch of states
    betas = torch.as_tensor(np.linspace(BETA_REF * 0.98, BETA_REF * 1.02, 5), device=hh.device)
    out, mu_star, _, conv = solve.find_phase_eq_state(
        hh, meta, 1.0e-6, float(MU_REF[0]), beta=betas,
        dmu=hh.curr_mu[1:] - hh.curr_mu[0], order=1, min_width=2, extrapolate=True, engine=engine,
    )
    _, pt = segment.thermo(out, meta, props=True)
    props = segment.phase_props(pt, out.volume)
    res = dict(betas=betas, mu_star=mu_star, converged=conv, density=props["density"], x_i=props["x_i"])
    res.update({k: getattr(pt, k) for k in ("fe", "mask", "left", "right", "n_phases", "valid")})
    return {k: v.cpu().numpy() for k, v in res.items()}


def report(res: dict):
    print("  beta      mu1*       rho_vap    rho_liq   converged")
    for i, b in enumerate(res["betas"]):
        rho = res["density"][i][res["mask"][i]]
        print("%8.5f  %9.5f  %9.6f  %9.6f   %s" % (b, float(res["mu_star"][i]), rho.min(), rho.max(), bool(res["converged"][i])))


def check(res: dict):
    """The JAX script's acceptance checks (the reference notebook's
    phase-diagram sanity properties): every solve converged, a proper
    two-phase split (rho_vap < rho_liq), equal free energies at
    coexistence, mu* strictly monotone in beta, and the pinned mu* at the
    middle temperature."""
    mus_np = res["mu_star"]
    assert all(bool(c) for c in res["converged"]), "coexistence solve did not converge"
    for i in range(len(mus_np)):
        m = res["mask"][i]
        rho = res["density"][i][m]
        assert len(rho) == 2 and rho.min() < rho.max(), "expected a vapor-liquid split"
        fe = res["fe"][i][m]
        assert abs(fe[0] - fe[1]) < 1e-4, "free energies not equal at coexistence"
    assert np.all(np.diff(mus_np) < 0), "mu* must fall monotonically with beta here"
    assert abs(float(mus_np[2]) - 2.50149) < 1e-3, float(mus_np[2])


def main():
    args = ex.parse_args(__doc__, SRC)
    res = run(args.data, args.device)
    report(res)
    check(res)
    print("all acceptance checks passed")


if __name__ == "__main__":
    main()
