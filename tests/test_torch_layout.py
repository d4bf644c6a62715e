"""PyTorch port: the kernels' layout rule and the inputs that hold it.

K1 and K2 run G lanes per state point (csrc/thermo_tail.cuh), with G from
``cuda_sweep.lanes_per_point``, and K3 G lanes per isopleth cell, with G
from ``cuda_iso.lanes_per_cell``.  On the CPU this file checks the rules'
contracts, that a forced G the kernels do not build raises before any
launch, and that the shuffled mu grid the GPU tests use really mixes
segmentation cases inside every warp-sized group of points (checked with
the plain version, and held against the JAX package like every other
input: segmentation equal, floats to 1e-12).
"""

import sys

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_iso as CI
import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.segment as TSeg
import fhmcanalysis_torch.binary.isopleth  # noqa: F401  (the module; the package exports the class under its name)
import fhmcanalysis_torch.core.state as TS
from fhmcanalysis_torch.utils.profiling import counters
import fhmcanalysis_tpu.core.pipeline as JP
import fhmcanalysis_tpu.core.state as JS
from torch_composites import CELLS, ISO31, ISO1400, ISO_PARTIAL, cell, iso_grid_args, iso_sources, port_histogram, shuffled_mu_grid, worst_abs_diff

IB = sys.modules["fhmcanalysis_torch.binary.isopleth"]
torch.set_num_threads(1)
SEG = ("valid", "mask", "n_phases", "left", "right")
SURFACES = ("n31", "negated")


def _surface(name):
    d, mk, _ = cell("n31")
    if name == "negated":
        d = dict(d, lnpi=-d["lnpi"])
    return d, mk


def _cases(h, meta, mus):
    """(extrema kind, n_phases) per point: kind 0 none, 1 maxima only, 2
    minima only, 3 both, from the stencil flags the tail branches on."""
    x = h.lnpi + TP._reweight_coeff(h, torch.as_tensor(mus))[:, None] * h.op
    fmx, fmn = TSeg.stencil_flags(x, meta.smooth)
    kind = fmx.any(1).long() + 2 * fmn.any(1).long()
    n_ph = TP.mu_sweep_thermo(h, meta, mus, props=False)["n_phases"]
    return list(zip(kind.tolist(), n_ph.tolist()))


@pytest.mark.parametrize("points", [32 * 48, 32 * 16 + 13])
@pytest.mark.parametrize("surface", SURFACES)
def test_shuffled_grid_mixes_cases_in_every_warp(surface, points):
    d, mk = _surface(surface)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    mus = shuffled_mu_grid(points, seed=points)
    cases = _cases(h, meta, mus)
    for start in range(0, points - 31, 32):  # whole groups of 32
        distinct = set(cases[start : start + 32])
        assert len(distinct) >= 3, (start, distinct)
    kinds = {k for k, _ in cases}
    assert {0, 3, 1 if surface == "n31" else 2} <= kinds, kinds
    assert {1, 2, 3} <= {n for _, n in cases}


@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("surface", SURFACES)
def test_shuffled_grid_matches_jax_xla(surface, props):
    d, mk = _surface(surface)
    mus = shuffled_mu_grid(96, seed=1)
    got = TP.mu_sweep_thermo(TS.from_host(d, device="cpu"), TS.HistMeta(**mk), mus, props=props)
    want = JP.mu_sweep_thermo(JS.make_hist(**d), JS.HistMeta(**mk), mus, props=props, engine="xla")
    for k in SEG:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    ok = np.asarray(want["mask"])
    for k in ("fe",) + (("n_i", "x_i", "ntot", "u", "density") if props else ()):
        assert worst_abs_diff(got[k].numpy(), np.asarray(want[k]), ok) <= 1e-12, k


H100_SMS = 132  # the card the rule was fitted on


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 1])
def test_lanes_per_point_contract(n_sm):
    """One of the layouts the kernels build; one warp per point for the
    n1400 cell's 4,096 points (N = 1400 keeps PR 3's layout there) and for
    any sweep too small to fill the card at one lane per point; one lane
    per point on the main-path cells; never more lanes for more points or
    fewer bins; and one rule for K1 and K2 (K2 at identity targets must
    equal K1 bit for bit)."""
    Ns = [1, 2, 31, 63, 127, 255, 383, 384, 385, 573, 1023, 1400, 2047, 4096]
    Bs = [1, 7, 1000, 2046, 4092, 4096, 8184, 25_344, 50_688, 101_376, 262_144, 2**21]
    gs = {(N, B): CS.lanes_per_point(N, B, n_sm) for N in Ns for B in Bs}
    assert set(gs.values()) <= set(CS.LANES) == {1, 32}
    assert CS.lanes_per_point(1400, 4096, H100_SMS) == 32
    if n_sm == H100_SMS:
        for name in ("n31", "n573"):  # the main-path sweeps and mb31 run one lane per point
            assert CS.lanes_per_point(CELLS[name]["N"], CELLS[name]["B"], n_sm) == 1
        assert CS.lanes_per_point(31, 65_536 * 64, n_sm) == 1
        assert CS.lanes_per_point(31, 4_092, n_sm) == 1 and CS.lanes_per_point(31, 4_091, n_sm) == 32
        assert CS.lanes_per_point(1400, 50_688, n_sm) == 1 and CS.lanes_per_point(1400, 50_687, n_sm) == 32
    for N in Ns:
        assert [gs[N, B] for B in Bs] == sorted((gs[N, B] for B in Bs), reverse=True)
    for B in Bs:
        assert [gs[N, B] for N in Ns] == sorted(gs[N, B] for N in Ns)
    assert CM.lanes_per_point is CS.lanes_per_point


def _cpu_inputs():
    d, mk, mus = cell("n31", 8, max_order=3)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    return h, meta, mus


@pytest.mark.parametrize("lanes", [0, 2, 3, 4, 6, 8, 12, 16, 33, 64, -1, True, 2.0, "4"])
def test_forced_invalid_lanes_raise_before_launch(lanes):
    """A forced G the kernels do not build (anything but 1 and 32) raises on
    CPU tensors, before the device check and before any launch, in both
    wrappers and both entry points; a valid G on CPU tensors still meets
    the device check."""
    h, meta, mus = _cpu_inputs()
    n1, n2 = counters().get("launches.k1", 0), counters().get("launches.k2", 0)
    keys = TSeg.key_rows(h.mom, meta).contiguous()
    a = TP._reweight_coeff(h, torch.as_tensor(mus)).contiguous()
    mu, a2, xrows, krows, tg = TP._mb_inputs(h, meta, mus, [1.0, 1.02], [[-5.0], [-4.9]], 1, True, False)
    calls = [
        lambda G: CS.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, meta.max_phases, _lanes=G),
        lambda G: CM.mb_sweep_thermo(h.lnpi, h.op, xrows, krows, h.volume, mu, a2, tg, meta.nspec, meta.smooth, meta.max_phases, _lanes=G),
        lambda G: TP.mu_sweep_thermo(h, meta, mus, engine="cuda", _lanes=G),
        lambda G: TP.mu_beta_sweep_thermo(h, meta, mus, [1.0], [[-5.0]], engine="cuda", _lanes=G),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="lanes per point must be a power of two dividing 32"):
            call(lanes)
        for valid in CS.LANES:
            with pytest.raises(ValueError, match="CUDA tensors"):
                call(valid)
    assert (counters().get("launches.k1", 0), counters().get("launches.k2", 0)) == (n1, n2) == (0, 0)


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 1])
def test_lanes_per_cell_contract(n_sm):
    """K3's rule: one of the layouts the kernel builds; one cell per lane on
    the iso31 grid (251,034 cells) and one warp per cell on iso1400's
    16,384 cells of 1,400 bins on the card it was fitted on, with the
    switch where cuda_iso.g1_switch puts it; never more lanes for more
    cells or fewer bins."""
    Ns = [1, 2, 31, 63, 127, 255, 384, 573, 1023, 1400, 2047]
    Bs = [1, 7, 1000, 4092, 6138, 12_276, 16_384, 24_552, 67_584, 135_168, 251_034, 270_336, 2**21]
    gs = {(N, B): CI.lanes_per_cell(N, B, n_sm) for N in Ns for B in Bs}
    assert set(gs.values()) <= set(CS.LANES)
    if n_sm == H100_SMS:
        assert CI.lanes_per_cell(31, ISO31["NX"] * ISO31["NY"], n_sm) == 1
        assert CI.lanes_per_cell(1400, ISO1400["NX"] * ISO1400["NY"], n_sm) == 32
        assert CI.lanes_per_cell(31, 12_276, n_sm) == 1 and CI.lanes_per_cell(31, 12_275, n_sm) == 32
        assert CI.lanes_per_cell(1400, 135_168, n_sm) == 1 and CI.lanes_per_cell(1400, 135_167, n_sm) == 32
    for N in Ns:
        assert CI.lanes_per_cell(N, CI.g1_switch(N, n_sm), n_sm) == 1 and CI.lanes_per_cell(N, CI.g1_switch(N, n_sm) - 1, n_sm) == 32
    for N in Ns:
        assert [gs[N, B] for B in Bs] == sorted((gs[N, B] for B in Bs), reverse=True)
    for B in Bs:
        assert [gs[N, B] for N in Ns] == sorted(gs[N, B] for N in Ns)


@pytest.mark.parametrize("lanes", [0, 2, 4, 16, 33, -1, True, 1.0, "1"])
def test_iso_forced_invalid_lanes_raise_before_launch(lanes):
    """A forced G that K3 does not build raises on CPU histograms, before
    the device check and before any launch, in the wrapper and in
    binary.isopleth.iso_grid at every engine; a valid G on CPU tensors
    still meets the device check."""
    ds, mk = iso_sources()
    srcs = [port_histogram(d, mk, device="cpu")._hist() for d in ds]
    grid = iso_grid_args(ISO_PARTIAL)
    mu1_v, dmu2_v = np.linspace(*grid[0], ISO_PARTIAL["NX"]), np.linspace(*ISO_PARTIAL["dmu2"], ISO_PARTIAL["NY"])
    lr = np.array([[0, 0]] * 4 + [[0, 1]] * (ISO_PARTIAL["NY"] - 8) + [[1, 1]] * 4, dtype=np.int32)
    wts = np.full((ISO_PARTIAL["NY"], 2), 0.5)
    metas = [TS.HistMeta(**dict(mk, max_phases=8))] * 2
    args = (srcs, metas, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0)
    pro = IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0)
    kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
    calls = [lambda G: CI.iso_grid(*kin, mk["smooth"], 8, 1, 10.0, _lanes=G), lambda G: IB.iso_grid(*args, engine="cuda", _lanes=G)]
    for call in calls:
        with pytest.raises(ValueError, match="lanes per point must be a power of two dividing 32"):
            call(lanes)
        for valid in CS.LANES:
            with pytest.raises(ValueError, match="CUDA tensors"):
                call(valid)
    for engine in ("auto", "torch"):
        with pytest.raises(ValueError, match="lanes per point must be a power of two dividing 32"):
            IB.iso_grid(*args, engine=engine, _lanes=lanes)
    assert counters().get("launches.k3", 0) == 0
