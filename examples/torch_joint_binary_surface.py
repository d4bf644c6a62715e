"""Joint (N_1, N_tot) binary-surface workflow on the PyTorch port.

The port of examples/joint_binary_surface.py: assembles a joint_hist from
per-N_1 entries (joint_hist.pyx:22-301 is the reference analog of the
assembly; it has no thermo), then reweights the whole surface to a grid of
(mu_1, mu_2) targets at once, watershed-segments every reweighted surface,
and reads per-phase free energies, compositions, and failure codes for the
full grid, with the same assertions as the JAX example.

Run: python examples/torch_joint_binary_surface.py [--device cpu] [--shards k]

--device picks where the sweep runs (default: the CUDA card); --shards k
also runs parallel.sharded_joint_state_sweep over k shards of that device
(grid_mesh(k, devices=[device] * k)) and asserts that it matches the
unsharded sweep: integers, labels and peaks equal, floats within 1e-12.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fhmcanalysis_torch.parallel import grid_mesh, sharded_joint_state_sweep
from fhmcanalysis_torch.two_dim import joint_hist, joint_state_sweep

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device of the sweep (default: the CUDA card)")
ap.add_argument("--shards", type=int, default=1, help="also run the sweep split over this many shards of the device")
args = ap.parse_args()

# ----------------------------------------------------------------------
# assemble lnPI(N_1, N_tot): a vapor-like basin (few particles, species-2
# rich) and a liquid-like basin (N_tot ~ 18, species-1 rich)
# ----------------------------------------------------------------------
BETA = 1.1
MU_REF = (0.2, -0.3)

jh = joint_hist()
for i in range(12):  # N_1 rows; ragged columns N_tot >= N_1
    nt = np.arange(i, 25, dtype=float)
    vapor = 30.0 * np.exp(-((i - 2.0) ** 2) / 6.0) * np.exp(-((nt - 4.0) ** 2) / 8.0)
    liquid = 33.0 * np.exp(-((i - 8.0) ** 2) / 6.0) * np.exp(-((nt - 18.0) ** 2) / 8.0)
    jh.enter(
        float(i),
        vapor + liquid - 0.05 * nt,
        nt.astype(int),
        {"N_tot": nt, "N_1": np.full(nt.shape, float(i)), "U": -0.4 * nt},
    )

# ----------------------------------------------------------------------
# one sweep: 25 (mu_1, mu_2) state points across the stability crossover
# ----------------------------------------------------------------------
mu1_v = np.linspace(-0.4, 0.7, 5)
mu2_v = np.linspace(-0.7, 0.2, 5)
targets = np.array([(m1, m2) for m1 in mu1_v for m2 in mu2_v])

out = joint_state_sweep(jh, BETA, MU_REF, targets, nnebr=1, max_peaks=4, device=args.device)

names = out["prop_names"]
j_nt = names.index("N_tot")
j_n1 = names.index("N_1")

# Not every target is analyzable: near the top of the mu_2 range, mass
# piles onto the ragged N_tot edge and the ridge guard trips.  The class
# path would raise per state; the sweep flags it — read the code and skip.
codes = out["fail_code"]
clean = np.where(codes == 0)[0]
assert len(clean) >= 10, "expected a mostly-clean grid"
assert (codes[codes != 0] == 1).all(), "only ridge-unsafe failures expected here"

print("%8s %8s | %10s %10s | %8s %8s" % ("mu_1", "mu_2", "FE_vap/kT", "FE_liq/kT", "x1_vap", "x1_liq"))
stable_flips = 0
for s in clean:
    m1, m2 = targets[s]
    n = int(out["n_phases"][s])
    nt = out["ave"][s, :n, j_nt]
    order = np.argsort(nt)  # label by size: small N_tot = vapor-like
    vap, liq = order[0], order[-1]
    fe = out["fe"][s, :n]
    x1 = out["ave"][s, :n, j_n1] / np.maximum(nt, 1e-300)
    if fe[liq] < fe[vap]:
        stable_flips += 1
    if s % 6 == 0:
        print("%8.2f %8.2f | %10.3f %10.3f | %8.3f %8.3f" % (m1, m2, fe[vap], fe[liq], x1[vap], x1[liq]))

# raising both chemical potentials must flip stability toward the liquid
assert 0 < stable_flips < len(clean), "expected a stability crossover inside the grid"

# the liquid basin is species-1 rich by construction (centered N_1 ~ 8 of
# N_tot ~ 18); the vapor basin species-2 rich (N_1 ~ 2 of N_tot ~ 4)
s0 = int(clean[0])
n = int(out["n_phases"][s0])
nt = out["ave"][s0, :n, j_nt]
order = np.argsort(nt)
vap, liq = order[0], order[-1]
x1 = out["ave"][s0, :n, j_n1] / nt
assert x1[vap] < 0.6 and x1[liq] < 0.6, "compositions should be fractions"
assert abs(nt[liq] - 18.0) < 1.5 and abs(nt[vap] - 4.0) < 1.5

# ----------------------------------------------------------------------
# the same sweep split over shards of the device: states are independent,
# so every shard's answer is the unsharded one's (the per-phase averages
# are a matrix product over the shard's states, so floats may differ in
# the last bits)
# ----------------------------------------------------------------------
if args.shards > 1:
    device = args.device or "cuda"
    mesh = grid_mesh(args.shards, devices=[device] * args.shards)
    sh = sharded_joint_state_sweep(mesh, jh, BETA, MU_REF, targets, nnebr=1, max_peaks=4)
    assert set(sh) == set(out) and sh["prop_names"] == out["prop_names"]
    assert all(np.array_equal(a, b) for a, b in zip(sh["local_maxima"], out["local_maxima"]))
    for k in set(out) - {"prop_names", "local_maxima"}:
        a, b = (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for v in (sh[k], out[k]))
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:  # NaN and +-inf in the same places
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=k)
    print("sharded over %s: matches the unsharded sweep" % mesh)

print(
    "OK: %d clean / %d ridge-flagged states; %d liquid-stable; on %s"
    % (len(clean), len(targets) - len(clean), stable_flips, args.device or "the card")
)
