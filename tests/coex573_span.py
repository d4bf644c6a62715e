"""How the coex573 cell's beta span and mu guess were chosen
(tests/torch_composites.py COEX573).  A script, not a test:

    JAX_PLATFORMS=cpu python tests/coex573_span.py

On the CPU it prints (1) the coexistence mu and its basin (the mu where
|dF.E./kT| < 10, outside which the objective is flat at DEFAULT_ERR2) at 9
betas over the JAX bench's span T in [0.88, 0.92]; (2) for that span, a
narrower one and the cell's, how many of 256 betas the port's plain solver
brings to (dF.E./kT)^2 <= lnZ_tol^2 from each of a few guesses; (3) JAX's
trace_coexistence over the cell, which must converge at every beta, and
the port's distance from it.
"""

import os
import sys

import numpy as np

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))), os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

import fhmcanalysis_torch.core.pipeline as TP  # noqa: E402
import fhmcanalysis_torch.core.solve as TSV  # noqa: E402
import fhmcanalysis_torch.core.state as TS  # noqa: E402
from torch_composites import COEX573, coex_grid  # noqa: E402


def main():
    d, mk, betas, guess, kw = coex_grid()
    th, tm = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    mus = np.linspace(-1.0, 1.0, 2001)
    grid_b = np.linspace(1 / 0.92, 1 / 0.88, 9)
    o = TP.mu_beta_sweep_thermo(th, tm, mus, grid_b, np.zeros((1, 0)), props=False)
    for t, b in enumerate(grid_b):
        two = o["n_phases"][:, t] == 2
        dfe = torch.where(two, o["fe"][:, t, 0] - o["fe"][:, t, 1], torch.nan)
        basin = mus[(two & (dfe.abs() < 10)).numpy()]
        cross = mus[1:][(two[1:] & two[:-1] & (torch.sign(dfe[1:]) != torch.sign(dfe[:-1]))).numpy()]
        print(f"T={1 / b:.4f}: coexistence mu {cross.tolist()}, basin [{basin.min():.3f}, {basin.max():.3f}]")
    for span in ((0.88, 0.92), (0.89, 0.91), COEX573["T"]):
        bs = np.linspace(1 / span[1], 1 / span[0], 256)
        for g in (0.0, 0.02, 0.022, 0.025, 0.05):
            out = TSV.trace_coexistence(th, tm, bs, g, **kw)
            ok = int((out["converged"] & (out["err"] <= kw["lnZ_tol"] ** 2)).sum())
            print(f"T in {span}, guess {g}: {ok} of 256 betas converged to |dF.E./kT| <= {kw['lnZ_tol']}")
    import jax

    jax.config.update("jax_enable_x64", True)
    import fhmcanalysis_tpu.core.solve as JSV
    import fhmcanalysis_tpu.core.state as JS

    want = JSV.trace_coexistence(JS.make_hist(**d), JS.HistMeta(**mk), jax.numpy.asarray(betas), guess, **kw)
    got = TSV.trace_coexistence(th, tm, betas, guess, **kw)
    jm = np.asarray(want["mu_star"])
    print(f"JAX trace_coexistence over the cell (T in {COEX573['T']}, guess {guess}): {int(np.asarray(want['converged']).sum())} of {len(betas)} converged, "
          f"worst err^2 {float(np.asarray(want['err']).max()):.3e}, mu* from {jm.max():.4f} to {jm.min():.4f}; "
          f"the port's mu* within {float(np.abs(got['mu_star'].numpy() - jm).max()):.2e}")


if __name__ == "__main__":
    main()
