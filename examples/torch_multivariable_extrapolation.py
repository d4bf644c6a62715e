"""Basic multivariable (beta, dMu_2) Taylor extrapolation of lnPI on the PyTorch port.

The port of examples/multivariable_extrapolation.py, which mirrors the
reference notebook example/ntot/binary_square_well/
basic_multivariable_extrapolation.ipynb: take ONE simulation (at beta_ref,
dMu_2 = 0), jointly Taylor-extrapolate its lnPI to other (beta, dMu_2)
state points (the histogram class's temp_dmu_extrap, gc_hist.pyx:889) and
compare against the simulations actually run there: the lnPI error at
each simulated peak and the peak's shift.  Same steps, prints and
acceptance checks.

Run: python examples/torch_multivariable_extrapolation.py [--device cpu] [--data DIR]

--data holds T_<T>/dMu2_<value>/composite.nc for T = 1.20 and 1.00
(default: the JAX script's; reading them needs h5py).  run() also takes
the composites in memory ({T: {dMu_2: read_composite dict}}).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch_example_io as ex

DATA = ex.jax_data_path("multivariable_extrapolation.py", "DATA")
MU1 = -5.0  # arbitrary comparison chemical potential, as the notebook picks -5.1


def load(inputs, T, device):
    src = inputs[T] if isinstance(inputs, dict) else os.path.join(inputs, "T_%.2f" % T)
    return {dmu2: ex.load(s, 1.0 / T, [0.0, dmu2], 10, device) for dmu2, s in ex.dmu2_sources(src).items()}


def peak_errors(base, sims, target_beta, order):
    """Extrapolate base to (target_beta, dmu2) for every simulated dmu2;
    return {dmu2: (lnPI error at the simulated peak, peak-location shift)}
    -- the notebook's max_err / max_err_n dictionaries."""
    out = {}
    for dmu2, sim in sorted(sims.items()):
        sim.reweight(MU1)
        clone = base.temp_dmu_extrap(target_beta, np.array([dmu2]), order)
        ms = min(len(sim.data["ln(PI)"]), len(clone.data["ln(PI)"]))
        a = np.asarray(sim.data["ln(PI)"][:ms])
        b = np.asarray(clone.data["ln(PI)"][:ms])
        loc = int(np.argmax(a))
        out[dmu2] = (float(a[loc] - b[loc]), loc - int(np.argmax(b)))
    return out


def run(inputs, device=None) -> dict:
    """{(order, T): {dMu_2: (peak error, peak shift)}} from the T = 1.20,
    dMu_2 = 0 simulation, at orders 1 and 2."""
    h120 = load(inputs, 1.20, device)
    h100 = load(inputs, 1.00, device)
    base = h120[0.0]
    base.reweight(MU1)
    results = {}
    for order in (1, 2):
        for T, sims in ((1.20, h120), (1.00, h100)):
            results[(order, T)] = peak_errors(base, sims, 1.0 / T, order)
    return results


def report(results: dict):
    print("extrapolating from (T=1.20, dMu2=0) at mu1 = %.1f" % MU1)
    for (order, T), errs in results.items():
        row = "  order %d -> T=%.2f:" % (order, T)
        for dmu2, (e, dn) in sorted(errs.items()):
            row += "  %+0.2f:%+.3f(%+d)" % (dmu2, e, dn)
        print(row)


def check(results: dict):
    """The JAX script's acceptance checks: the identity at the source, an
    accurate pure-beta step, errors growing with |dMu_2| and order 2 far
    ahead of order 1 at the far sources."""
    for order in (1, 2):
        e0, dn0 = results[(order, 1.20)][0.0]
        assert abs(e0) < 1e-10 and dn0 == 0, (order, e0, dn0)
    for order in (1, 2):
        e0, _ = results[(order, 1.00)][0.0]
        assert abs(e0) < 0.05, (order, e0)
    for T in (1.20, 1.00):
        for far in (-2.94, 2.94):
            e1 = abs(results[(1, T)][far][0])
            e2 = abs(results[(2, T)][far][0])
            near = abs(results[(2, T)][far / 2.94 * 1.10][0])
            assert e2 < e1, (T, far, e1, e2)
            assert near <= e2 + 1e-9 or near < 0.05, (T, far, near, e2)
    assert abs(results[(2, 1.20)][2.94][0]) < 0.5  # vs 16.3 at order 1
    assert abs(results[(1, 1.20)][2.94][0]) > 5.0


def main():
    args = ex.parse_args(__doc__, DATA)
    results = run(args.data, args.device)
    report(results)
    check(results)
    print("OK multivariable_extrapolation")


if __name__ == "__main__":
    main()
