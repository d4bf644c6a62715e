"""PyTorch port: the kernels' capacities beyond their first build, against
the JAX package.

The JAX package's kernels take any max_phases (its class path caps the
padded device representation at 64 slots) and its K1 any nspec.  The
port's K1, K2 and K3 have a second build of 64 phase slots, and K1 one of
6 per-phase sums (nspec 3-4); ``cuda_sweep.capacity`` and
``cuda_sweep.accumulators`` pick the smallest build that holds a run.  The
builds run only on the card (tests/test_torch_gpu.py holds each against
its plain version there); on the CPU this file holds the plain versions
they are compared with against the JAX package on the inputs that need
the wide builds (tests/torch_composites.py ``CAPACITY``, ``ten_peak``):

* the ripple121 surface (15 maxima: every point overflows 8 slots, fits
  16) through ``mu_sweep_thermo`` and ``mu_beta_sweep_thermo`` at
  max_phases 8, 16 and 64 against JAX's XLA engine;
* the fail-code test's ten-peak isopleth sources through ``make_grid``
  with ``_meta`` at 8 slots (fail code 3 on every cell) and at 16 (the
  documented remedy: every cell ok) against JAX's;
* ``find_phase_eq_state`` batched over betas at 16 slots (K2's paired
  mode's plain version) against JAX's ``trace_coexistence``;
* the three- and four-species n573 cells through ``mu_sweep_thermo``;
* at N = 31 and 32 points, JAX's own K1 body
  (``pallas_sweep.mu_sweep_thermo_ds(mode="xla")``, double-single) at 16
  slots and at nspec 3, at the kernel bar 1e-10;
* the host-side rules: the capacity and sums choice, the layout rule with
  max_phases, the slot and staging byte counts;
* the wide build's tail (``thermo_point_wide``): on the plain version's
  outputs, the fill of the slots past the count and the O(phases)
  overlap rule against the all-pairs one; and the tail itself, built
  with g++ for one lane on the host (``tests/tail_host``), the wide body
  against the body every build ran before it, bit for bit;
* K3's cell (``csrc/iso_cell.cuh``) built the same way: the wide build
  with x_m formed once into its area against x_m formed on read, bit for
  bit, and both against the plain version; and the host's count of the
  area (``cuda_iso.xm_bytes``).

Segmentation fields equal, floats within 1e-12 absolute (the JAX CPU
suite's bar); mu_star within 1e-9 (JAX's own bar between two trace
engines).  Measured worst when written: 1.1e-13 (ripple121), 6.8e-13
(tern573 / quat573, fe of order 1e3), 3.6e-15 (isopleth).
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_iso as CI
import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.segment as TSG
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.pallas_sweep as JPS
import fhmcanalysis_tpu.core.pipeline as JP
import fhmcanalysis_tpu.core.solve as JSV
import fhmcanalysis_tpu.core.state as JS
from fhmcanalysis_torch.binary import isopleth
from fhmcanalysis_torch.binary.isopleth import FAIL_OK, FAIL_PHASE_OVERFLOW
from fhmcanalysis_torch.histogram.ntot import histogram
from fhmcanalysis_torch.io import write_composite
from fhmcanalysis_torch.utils.profiling import counters
from fhmcanalysis_tpu.binary import isopleth as jax_isopleth
from fhmcanalysis_tpu.histogram.ntot import histogram as jax_histogram
from torch_composites import CAPACITY, CELLS, ISO1400, SURFACE_KINDS, capacity_cell, cell, composite_raw, iso_sources, make_composite, mu_window, random_surface, ripple1400, ten_peak, worst_abs_diff

import jax.numpy as jnp

IB = sys.modules["fhmcanalysis_torch.binary.isopleth"]
torch.set_num_threads(1)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")


def _hold(got, want, props, bar=1e-12):
    """Segmentation equal, floats within ``bar`` on valid masked slots;
    returns the valid share."""
    for k in SEG:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    ok = np.asarray(want["mask"]) & np.asarray(want["valid"])[..., None]
    for k in ("fe",) + (PROPS if props else ()):
        assert worst_abs_diff(got[k].numpy(), np.asarray(want[k]), ok) <= bar, k
    return float(np.asarray(want["valid"]).mean())


def _both(name, points=None, max_order=2, max_phases=None):
    d, mk, mus = capacity_cell(name, points, max_order, max_phases)
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk), mus


@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("max_phases", [8, 16, 64])
def test_mu_sweep_phase_slots_match_jax(max_phases, collect, props):
    """ripple121: 15 maxima, so every point overflows 8 slots (valid False
    on both sides) and every point is valid at 16 and 64."""
    th, tm, jh, jm, mus = _both("ripple121", max_phases=max_phases)
    got = TP.mu_sweep_thermo(th, tm, mus, props=props, collect=collect)
    want = JP.mu_sweep_thermo(jh, jm, mus, props=props, collect=collect, engine="xla")
    share = _hold(got, want, props)
    assert share == (0.0 if max_phases == 8 else 1.0)
    if max_phases > 8 and collect is None:
        assert set(got["n_phases"].tolist()) == {14}


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("max_phases", [8, 16, 64])
def test_mu_beta_sweep_phase_slots_match_jax(max_phases, order):
    th, tm, jh, jm, mus = _both("ripple121", 8, max_order=3, max_phases=max_phases)
    betas, dmus = np.array([0.98, 1.0, 1.02]), np.array([[-5.2], [-5.0], [-4.8]])
    got = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=order)
    want = JP.mu_beta_sweep_thermo(jh, jm, mus, betas, dmus, order=order, engine="xla")
    bar = 1e-12 if order == 1 else 1e-10  # the order-2 sweep's measured bar (tests/test_torch_mb.py)
    share = _hold(got, want, True, bar)
    assert share == (0.0 if max_phases == 8 else 1.0)


@pytest.fixture(scope="module")
def overflow_sources(tmp_path_factory):
    """(paths, meta kwargs) of two isopleth sources on the fail-code test's
    ten-peak surface, written once."""
    root = tmp_path_factory.mktemp("overflow31")
    ds, mk = iso_sources("n31", (-5.0, -4.0), 3, False, ten_peak())
    paths = []
    for j, d in enumerate(ds):
        p = str(root / f"src{j}.nc")
        write_composite(p, d["lnpi"], d["op"], d["mom"], d["volume"], mk["nspec"], mk["max_order"], history="synthetic composite")
        paths.append((p, d))
    return paths, mk


def _with_slots(h, max_phases):
    """h, whose _meta now defaults to max_phases slots: the remedy
    FAIL_PHASE_OVERFLOW names ("retry with a larger max_phases in
    _meta()")."""
    h._meta = lambda max_phases=max_phases, _m=type(h)._meta: _m(h, max_phases)
    return h


@pytest.mark.parametrize("max_phases", [8, 16])
def test_overflow_isopleth_matches_jax(overflow_sources, max_phases):
    """make_grid on the ten-peak sources (the JAX fail-code test's window):
    fail code 3 on every cell at 8 slots, every cell ok at 16, both
    packages alike."""
    paths, mk = overflow_sources
    grid = ((4.9, 5.1), (-4.9, -4.1), (0.01, 0.05))
    port = [_with_slots(histogram(p, d["curr_beta"], d["curr_mu"], mk["smooth"], mk["used_ke"], device="cpu"), max_phases) for p, d in paths]
    ref = [_with_slots(jax_histogram(p, d["curr_beta"], d["curr_mu"], mk["smooth"], mk["used_ke"]), max_phases) for p, d in paths]
    a, b = isopleth(port, 1.001, order=1), jax_isopleth(ref, 1.001, order=1)
    a.make_grid(*grid)
    b.make_grid(*grid, engine="xla")
    np.testing.assert_array_equal(a.data["fail_code"], b.data["fail_code"])
    np.testing.assert_array_equal(a.data["valid"], b.data["valid"])
    assert a.data["fail_code"].shape == (18, 21)
    assert (a.data["fail_code"] == (FAIL_PHASE_OVERFLOW if max_phases == 8 else FAIL_OK)).all()
    ok = b.data["valid"].astype(bool)
    for k in ("Z", "density", "F.E./kT"):
        assert np.max(np.abs(np.where(ok, a.data[k] - b.data[k], 0.0))) <= 1e-12, k


def test_find_phase_eq_state_16_slots_matches_jax():
    """Three betas in one batched, extrapolating find_phase_eq_state at 16
    phase slots (the plain version of K2's paired mode) against the same
    solve inside JAX's trace_coexistence."""
    lnpi = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0], dtype=np.float64)  # tests/test_solve.py
    d, mk, _ = cell("n31", 1, max_order=3)
    d, mk = dict(d, lnpi=lnpi), dict(mk, max_phases=16)
    th, tm = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    betas = (0.99, 1.0, 1.01)
    dmu = th.curr_mu[1:] - th.curr_mu[0]
    _, mus, err, conv = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=betas, dmu=dmu, order=1, min_width=2, extrapolate=True)
    want = JSV.trace_coexistence(JS.make_hist(**d), JS.HistMeta(**mk), jnp.asarray(betas), 5.0, lnZ_tol=1e-6, min_width=2)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want["converged"]))
    assert conv.all() and np.abs(mus.numpy() - np.asarray(want["mu_star"])).max() <= 1e-9
    assert np.abs(err.numpy() - np.asarray(want["err"])).max() <= 1e-12


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("name", ["tern573", "quat573"])
def test_mu_sweep_nspec_matches_jax(name, collect):
    th, tm, jh, jm, mus = _both(name, 16)
    got = TP.mu_sweep_thermo(th, tm, mus, collect=collect)
    want = JP.mu_sweep_thermo(jh, jm, mus, collect=collect, engine="xla")
    assert got["n_i"].shape == (16, 4, CAPACITY[name]["nspec"])
    assert _hold(got, want, True) == 1.0
    assert set(got["n_phases"].tolist()) == {1, 2}


def _ds_inputs(kind):
    """N = 31, 32 points: the ten-peak surface on the n31 composite at 16
    slots, or a three-species 31-bin composite at 4."""
    c = CAPACITY["tern573"]
    if kind == "slots16":
        d, mk, mus = capacity_cell("ten31")
    else:
        c31 = dict(c, N=31, smooth=1, seed=31)
        d = make_composite(**c31)
        mk = dict(nspec=3, max_order=2, used_ke=False, smooth=1, max_phases=4)
        mus = np.linspace(*mu_window(**c31), 32)
    return d, mk, mus


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("kind", ["slots16", "nspec3"])
def test_plain_matches_jax_kernel_body(kind, collect):
    """JAX's own K1 body (pallas_sweep.mu_sweep_thermo_ds, mode "xla": the
    kernel's double-single arithmetic, run eagerly) at the kernel bar."""
    d, mk, mus = _ds_inputs(kind)
    got = TP.mu_sweep_thermo(TS.from_host(d, device="cpu"), TS.HistMeta(**mk), mus, collect=collect)
    want = JPS.mu_sweep_thermo_ds(JS.make_hist(**d), JS.HistMeta(**mk), mus, mode="xla", collect=collect)
    share = _hold(got, want, True, bar=1e-10)
    assert share > 0.5
    if kind == "slots16" and collect is None:
        assert int(got["n_phases"][got["valid"]].max()) > 8


# ---- the host-side rules (no card needed) ----


def test_capacity_and_sums_choice():
    """The smallest build that holds a run; above the widest, a ValueError
    that names the limit and its reason."""
    assert CS.CAPACITIES == (8, 64) and CS.MAX_PHASES == CM.MAX_PHASES == CI.MAX_PHASES == 64
    assert [CS.capacity(p) for p in (1, 4, 8, 9, 16, 32, 63, 64)] == [8, 8, 8, 64, 64, 64, 64, 64]
    for bad in (0, -1, 65, 1000):
        with pytest.raises(ValueError, match="max_phases.*1..64.*64 phase slots"):
            CS.capacity(bad)
    assert CS.MAX_NSPEC == 4 and [CS.accumulators(s) for s in (1, 2, 3, 4)] == [4, 4, 6, 6]
    for bad in (0, 5):
        with pytest.raises(ValueError, match="nspec.*1..4"):
            CS.accumulators(bad)


@pytest.mark.parametrize("n_sm", [132, 114, 1])
def test_lanes_rule_with_phase_slots(n_sm):
    """max_phases <= 8 keeps the rule it had (and its default); K1's and
    K2's wide builds switch at min(N, G1_PER_SM_CAP_WIDE) points per SM,
    K3's at min(N, its G1_PER_SM_CAP) cells (its x_m area keeps G = 32
    ahead longer at large N: overflow1400's 16,384 to 67,584 cells run one
    warp a cell); K1 and K2 share one rule, so K2 at identity targets
    equals K1 bit for bit at every max_phases; both rules raise above 64
    slots."""
    Ns, Bs = [1, 31, 121, 384, 573, 1400], [1, 1000, 4096, 50_688, 262_144, 2**21]
    for N in Ns:
        for B in Bs:
            g8 = CS.lanes_per_point(N, B, n_sm)
            assert all(CS.lanes_per_point(N, B, n_sm, p) == g8 for p in (1, 4, 8))
            switch = n_sm * min(N, CS.G1_PER_SM_CAP_WIDE)
            for p in (9, 16, 64):
                assert CS.lanes_per_point(N, B, n_sm, p) == (1 if B >= switch else 32)
            assert all(CI.lanes_per_cell(N, B, n_sm, p) == CI.lanes_per_cell(N, B, n_sm) for p in (1, 4, 8))
            k3_switch = n_sm * min(N, CI.G1_PER_SM_CAP)
            assert all(CI.lanes_per_cell(N, B, n_sm, p) == (1 if B >= k3_switch else 32) for p in (9, 16, 64))
    assert CS.G1_PER_SM_CAP_WIDE == 256 and CS.G1_PER_SM_CAP == 384 and CI.G1_PER_SM_CAP == 1024 and CI.G1_PER_BIN_WIDE == 1
    if n_sm == 132:  # multi573's 524,288 points and overflow31's 251,034 cells run one lane each; a 1,280-point solver step one warp
        assert CS.lanes_per_point(573, 524_288, n_sm, 64) == 1 and CI.lanes_per_cell(31, 251_034, n_sm, 16) == 1
        assert CS.lanes_per_point(31, 1280, n_sm, 16) == 32
        assert CS.lanes_per_point(573, 33_792, n_sm, 16) == 1 and CS.lanes_per_point(573, 33_791, n_sm, 16) == 32
        assert CS.lanes_per_point(121, 15_972, n_sm, 64) == 1 and CS.lanes_per_point(121, 15_971, n_sm, 64) == 32
        assert CI.lanes_per_cell(31, 4092, n_sm, 64) == 1 and CI.lanes_per_cell(31, 4091, n_sm, 64) == 32
        assert CI.lanes_per_cell(1400, 67_584, n_sm, 16) == 32 and CI.lanes_per_cell(1400, 135_168, n_sm, 16) == 1
    assert CM.lanes_per_point is CS.lanes_per_point
    for rule in (CS.lanes_per_point, CI.lanes_per_cell):
        with pytest.raises(ValueError, match="max_phases"):
            rule(31, 4096, n_sm, 65)


def test_slot_and_staging_bytes():
    """The index slots a block reserves in shared memory (as the kernels'
    thermo_tail.cuh counts them) and what that leaves for staged rows: the
    wide build at G = 1 keeps its slots in local memory, 132 KB a block
    being past the 48 KB a block gets without opting in."""
    assert CS.slot_bytes(1, 8) == 17 * 4 * 256 == 17_408
    assert CS.slot_bytes(32, 8) == 17 * 4 * 8 == 544
    assert CS.slot_bytes(32, 64) == 129 * 4 * 8 == 4_128
    assert CS.slot_bytes(1, 64) == 0 and (2 * 64 + 1) * 4 * 256 > CS.STATIC_SMEM
    # K1 at n573's rows (lnpi, op, 2 key rows: 4 x 573 doubles), G = 1
    n573 = 4 * 573 * 8
    assert CS.stages_rows(1, 8, n573) and CS.stages_rows(1, 64, n573)
    assert not CS.stages_rows(32, 8, n573) and not CS.stages_rows(32, 64, 8)
    edge = CS.STATIC_SMEM - CS.slot_bytes(1, 8)
    assert CS.stages_rows(1, 8, edge) and not CS.stages_rows(1, 8, edge + 1)
    assert CS.stages_rows(1, 64, CS.STATIC_SMEM) and not CS.stages_rows(1, 64, CS.STATIC_SMEM + 1)


def test_row_tile_and_shared_bytes():
    """K1's and K2's row tile: 32 bytes a lane, a warp's 1 KB, only in the
    wide build at G = 1, where a lane writes a point's row; each block's
    static shared memory is its index slots and its tile (chip_smoke.py
    holds the ptxas lines to it), and multi573's K1 rows still fit beside
    them."""
    assert CS.row_tile_bytes(1, 64) == 8 * 32 * 32 == 8_192
    assert CS.row_tile_bytes(32, 64) == CS.row_tile_bytes(1, 8) == CS.row_tile_bytes(32, 8) == 0
    assert [CS.shared_bytes(G, c) for G, c in ((1, 8), (32, 8), (1, 64), (32, 64))] == [17_408, 544, 8_192, 4_128]
    n573 = 5 * 573 * 8  # multi573's K1 rows: lnpi, op, 3 key rows
    assert n573 + CS.shared_bytes(1, 64) <= CS.STATIC_SMEM


# K2's x' area: the largest N it admits at G = 1, by build (cuda_mb.xarea_fits)
XAREA_TOP = {8: 33, 64: 36}


@pytest.mark.parametrize("N", [31, "top", "top+1", 573, 1400])
@pytest.mark.parametrize("cap", CS.CAPACITIES)
@pytest.mark.parametrize("G", CS.LANES)
def test_mb_xarea_fits(G, cap, N):
    """K2 forms x' once a bin into shared memory at G = 1 where a block's
    area (64 points of N doubles), its index slots (4,352 bytes in the
    build of 8 slots) or row tile (2,048 in the build of 64), the most rows
    it stages (25 of N doubles) and the runtime's 1 KB leave eight blocks in
    an SM's 228 KB; never at G = 32, nor at N = 573 or 1400."""
    top = XAREA_TOP[cap]
    n = {"top": top, "top+1": top + 1}.get(N, N)
    block = 64 * n * 8 + 25 * n * 8 + {8: 4_352, 64: 2_048}[cap] + 1_024
    want = G == 1 and 8 * block <= 228 * 1024
    assert CM.xarea_fits(G, cap, n) == want == (G == 1 and n <= top)
    assert CM.xarea_limit(G, cap) == (top if G == 1 else 0)
    assert CM.xarea_bytes(G, n) == 64 // G * n * 8


def test_mb_xarea_argument_checked_first():
    """_xarea takes None, True or False, checked before any tensor is."""
    with pytest.raises(ValueError, match="_xarea must be None, True or False"):
        CM.mb_sweep_thermo(*[None] * 8, 2, 1, 4, _xarea="on")


def test_iso_staged_sources_count():
    """K3's staging at G = 1: a block's 256 cells span (255 // NX) + 2 rows,
    2 sources each, staged where they fit beside the build's slots and the
    list of staged sources; never at G = 32."""
    src = lambda N, order: (2 + (2 if order == 1 else 5) + 3 * (3 if order == 1 else 6)) * N * 8  # noqa: E731  (one source's rows)
    assert CI.staged_sources(1, 2, 834, 301, 31, 1) == 2 and CI.staged_sources(1, 2, 834, 301, 31, 1, 64) == 2
    assert CI.staged_sources(32, 2, 834, 301, 31, 1, 64) == 0
    assert CI.staged_sources(1, 2, 128, 128, 1400, 1) == 0  # one source's rows are 146 KB
    assert CI.staged_sources(1, 5, 12, 40, 31, 2) == 5
    # the N at which two order-2 sources stop fitting: the small build
    # leaves 48 KB - 17,408 - 144 bytes, the wide build 48 KB - 144 (the
    # staged-source list, 33 ints rounded up to 16 bytes)
    assert CI.LIST_BYTES == 144
    for cap, room in ((8, CS.STATIC_SMEM - 17_408 - 144), (64, CS.STATIC_SMEM - 144)):
        n = room // (2 * src(1, 2))
        assert CI.staged_sources(1, 2, 834, 301, n, 2, cap) == 2 and CI.staged_sources(1, 2, 834, 301, n + 1, 2, cap) == 0
    with pytest.raises(ValueError, match="max_phases"):
        CI.staged_sources(1, 2, 834, 301, 31, 1, 65)


def test_iso_xm_bytes_count():
    """K3's x_m area: the build of 64 slots keeps THREADS/G cells of N
    doubles in shared memory where the block's static slots and list, its
    staged rows and the area fit the 227 KB a Hopper block may opt in to;
    the first build has none."""
    assert CI.SMEM_OPTIN == 227 * 1024 == 232_448
    src = lambda N, order: (2 + (2 if order == 1 else 5) + 3 * (3 if order == 1 else 6)) * N * 8  # noqa: E731  (one source's rows)
    # the main cases: overflow31 at G = 1 (63.5 KB beside 2 staged sources),
    # overflow1400 at G = 32 (89.6 KB), overflow1400 at G = 1 (2.8 MB: on read)
    assert CI.xm_bytes(1, 2, 834, 301, 31, 1, 16) == CI.xm_bytes(1, 2, 834, 301, 31, 2, 64) == 256 * 31 * 8 == 63_488
    assert CI.xm_bytes(32, 2, 834, 301, 31, 1, 16) == 8 * 31 * 8
    assert CI.xm_bytes(32, 2, 128, 128, 1400, 1, 16) == CI.xm_bytes(32, 2, 128, 128, 1400, 2, 64) == 8 * 1400 * 8 == 89_600
    assert CI.xm_bytes(1, 2, 128, 128, 1400, 1, 16) == 0
    for G in CS.LANES:
        for order in (1, 2):
            assert all(CI.xm_bytes(G, 2, 834, 301, N, order, p) == 0 for N in (31, 1400) for p in (1, 4, 8))
    # the N at which the area stops fitting: at G = 32 beside the slots
    # (4,128 bytes); at G = 1 beside the list (144) and the 2 staged sources
    edge32 = (CI.SMEM_OPTIN - CS.slot_bytes(32, 64)) // (8 * 8)
    assert edge32 == 3_567
    assert CI.xm_bytes(32, 2, 128, 128, edge32, 1, 64) == 8 * edge32 * 8 and CI.xm_bytes(32, 2, 128, 128, edge32 + 1, 1, 64) == 0
    for order, edge1 in ((1, 102), (2, 94)):
        assert CI.staged_sources(1, 2, 834, 301, edge1 + 1, order, 64) == 2
        assert edge1 == (CI.SMEM_OPTIN - CI.LIST_BYTES) // (256 * 8 + 2 * src(1, order))
        assert CI.xm_bytes(1, 2, 834, 301, edge1, order, 64) == 256 * edge1 * 8 and CI.xm_bytes(1, 2, 834, 301, edge1 + 1, order, 64) == 0
    # nothing staged (a block naming more sources than the list holds): the area alone
    assert CI.staged_sources(1, 40, 1, 300, 113, 1, 64) == 0 and CI.xm_bytes(1, 40, 1, 300, 113, 1, 64) == 256 * 113 * 8
    assert CI.xm_bytes(1, 40, 1, 300, 114, 1, 64) == 0
    with pytest.raises(ValueError, match="max_phases"):
        CI.xm_bytes(1, 2, 834, 301, 31, 1, 65)


def test_wrappers_raise_above_the_builds():
    """The plain version takes any max_phases, as JAX's XLA engine does;
    the kernel path on CPU tensors meets the device check and launches
    nothing."""
    th, tm, _, _, mus = _both("ripple121", 4, max_phases=65)
    assert TP.mu_sweep_thermo(th, tm, mus)["fe"].shape == (4, 65)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TP.mu_sweep_thermo(th, tm, mus, engine="cuda")
    assert (counters().get("launches.k1", 0), counters().get("launches.k2", 0), counters().get("launches.k3", 0)) == (0, 0, 0)


# ---- the wide build's redesign (csrc/thermo_tail.cuh thermo_point_wide) ----
#
# The wide build writes the slots past a point's count as a fill, tests
# whether phases share bins in O(phases), and keeps its later lists as
# views of the two compacted ones.  The facts it relies on, on the plain
# version's outputs over the capacity cells' windows, and the wide body
# itself built for the host (tests/tail_host) against the body every build
# ran before it, bit for bit.

WIDE_CELLS = (("ten31", None), ("ripple121", None), ("multi573", 1024))
BIG = TSG.BIG


def _plain_points(name, points, max_phases, collect, chunk=256):
    """The plain mu sweep over a capacity cell's window, in chunks of
    points (numpy outputs, N)."""
    d, mk, mus = capacity_cell(name, points, max_phases=max_phases)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    parts = [TP.mu_sweep_thermo(h, meta, mus[i : i + chunk], props=True, collect=collect, engine="torch") for i in range(0, len(mus), chunk)]
    return {k: np.concatenate([o[k].numpy() for o in parts]) for k in parts[0]}, h.nbins


def _overlap_rules(left, right, n_phases, N):
    """(all-pairs, O(phases)) answers to "does another masked phase share
    a bin of phase p's summed range [b0, e)", [B, P] each, where the bin
    loop runs (b0 < e), and whether each point's left bounds ascend."""
    B, P = left.shape
    nmask = np.minimum(n_phases, P)
    slots = np.arange(P)
    masked = slots[None] < nmask[:, None]
    b0, e = np.clip(left, 0, N), np.minimum(right, N - 1)
    runs = masked & (b0 < e)
    meet = (np.maximum(left[:, None, :], b0[:, :, None]) < np.minimum(right[:, None, :], e[:, :, None])) & masked[:, None, :]
    meet &= ~np.eye(P, dtype=bool)[None]
    all_pairs = meet.any(-1) & runs
    # the O(phases) rule: the largest right before p, the left of the first
    # non-empty masked phase after p
    hi_m = np.where(masked, right, -1)
    pre_r = np.concatenate([np.full((B, 1), -1), np.maximum.accumulate(hi_m, axis=1)[:, :-1]], axis=1)
    nonempty = masked & (left < right)
    nx_l = np.full((B, P), np.iinfo(np.int64).max)
    nxt = np.full(B, np.iinfo(np.int64).max)
    for p in range(P - 1, -1, -1):
        nx_l[:, p] = nxt
        nxt = np.where(nonempty[:, p], left[:, p], nxt)
    fast = ((pre_r > b0) | (nx_l < e)) & runs
    ascending = np.where(masked[:, 1:], left[:, 1:] >= left[:, :-1], True).all(-1)
    return all_pairs, fast, ascending


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("max_phases", [16, 32, 64])
@pytest.mark.parametrize("name,points", WIDE_CELLS)
def test_wide_fill_and_overlap_facts(name, points, max_phases, collect):
    """Every point of the capacity cells' windows (multi573 at 1,024 mu):
    the slots at and past min(n_phases, P) are the unmasked ones and hold
    right N, fe +0 and zero properties, and left BIG from at most one slot
    past the count on (a trailing minimum); the O(phases) overlap rule
    answers as the all-pairs rule, where the left bounds ascend (all of
    them here, and no two phases share a bin)."""
    out, N = _plain_points(name, points, max_phases, collect)
    P = max_phases
    n = out["n_phases"]
    slots = np.arange(P)
    past = slots[None] >= np.minimum(n, P)[:, None]
    np.testing.assert_array_equal(out["mask"], ~past)
    assert (out["right"][past] == N).all()
    for k in ("fe", "ntot", "u", "density"):
        v = out[k][past]
        assert (v == 0.0).all() and not np.signbit(v).any(), k
    for k in ("n_i", "x_i"):
        v = out[k][past]
        assert (v == 0.0).all() and not np.signbit(v).any(), k
    real_left = ~past | (out["left"] != BIG)
    q_end = P - np.argmax(real_left[:, ::-1], axis=1)  # one past the last slot whose left is not BIG
    assert (q_end - np.minimum(n, P) <= 1).all()
    all_pairs, fast, ascending = _overlap_rules(out["left"].astype(np.int64), out["right"].astype(np.int64), n, N)
    assert ascending.all()
    np.testing.assert_array_equal(fast, all_pairs)
    assert not all_pairs.any()


def _n_peak_surface(n_peaks):
    """n_peaks maxima at the odd bins of 2 n_peaks + 1, a slight tilt."""
    t = np.arange(2 * n_peaks + 1, dtype=np.float64)
    return (t % 2) + 1e-3 * t


@pytest.fixture(scope="module")
def tail_host(tmp_path_factory):
    """tests/tail_host/tail_host.cpp built with g++ (the kernels' tail for
    one lane on the CPU)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the tail for the host")
    here = Path(__file__).parent
    so = tmp_path_factory.mktemp("tail_host") / "libtail_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-I", str(here / "tail_host"),
                    "-I", str(here.parent / "fhmcanalysis_torch" / "csrc"), str(here / "tail_host" / "tail_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tail_run.argtypes = [i, p, p, ctypes.c_double] + [i] * 7 + [p] * 12
    lib.iso_cell_run.argtypes = [i, i] + [p] * 11 + [i] * 10 + [ctypes.c_double] + [p] * 5
    lib.iso_cell_run.restype = i
    return lib


def _tail_host_run(lib, body, x, keys, volume, P, smooth, collect):
    """One body of the host-built tail over the rows of x [B, N]; every
    output starts poisoned, so a slot the body leaves unwritten shows."""
    B, N = x.shape
    S = keys.shape[0] - 1
    o = {"fe": np.full((B, P), 12345.0), "left": np.full((B, P), -7, np.int32), "right": np.full((B, P), -7, np.int32),
         "mask": np.full((B, P), 9, np.uint8), "n_phases": np.full(B, -7, np.int32), "valid": np.full(B, 9, np.uint8),
         "n_i": np.full((B, P, S), 12345.0), "x_i": np.full((B, P, S), 12345.0), "ntot": np.full((B, P), 12345.0),
         "u": np.full((B, P), 12345.0), "density": np.full((B, P), 12345.0), "last_max": np.full(B, -7, np.int32)}
    x, keys = np.ascontiguousarray(x), np.ascontiguousarray(keys)
    lib.tail_run(body, x.ctypes.data, keys.ctypes.data, volume, B, N, S, P, smooth, 1, int(collect == "janus"),
                 *(o[k].ctypes.data for k in ("fe", "left", "right", "mask", "n_phases", "valid", "n_i", "x_i", "ntot", "u", "density", "last_max")))
    return o


def _tail_host_inputs(max_phases):
    """(name, x [B, N], keys [S+1, N], volume, smooth): the capacity cells
    (multi573 at 512 mu), the randomized structures, surfaces of P - 1 to
    P + 2 maxima, and flat, monotone and tiny ones."""
    rng = np.random.default_rng(max_phases)
    cases = []
    for name, points in (("ten31", None), ("ripple121", None), ("multi573", 512)):
        d, mk, mus = capacity_cell(name, points, max_phases=max_phases)
        h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
        x = (h.lnpi[None] + TP._reweight_coeff(h, torch.as_tensor(mus))[:, None] * h.op[None]).numpy()
        cases.append((name, x, TSG.key_rows(h.mom, meta).numpy(), float(h.volume), mk["smooth"]))
    for kind in SURFACE_KINDS:
        for smooth in (1, 2, 3):
            cases.append((f"{kind} smooth={smooth}", np.stack([random_surface(kind, 61, rng) for _ in range(16)]), rng.normal(size=(3, 61)), 0.9, smooth))
    for k in (max_phases - 1, max_phases, max_phases + 1, max_phases + 2):
        cases.append((f"{k} peaks", _n_peak_surface(k)[None], rng.normal(size=(3, 2 * k + 1)), 1.0, 1))
    rise = np.r_[np.cos(np.linspace(0.0, 6 * np.pi, 37)), [-1.5, 2.0]]  # ends on a minimum inside, then climbs to bin N-1
    for x in (np.zeros(20), np.arange(20.0), -np.arange(20.0), np.array([1.0]), np.array([2.0, 1.0, 2.0]), np.array([0.0, 5, 5, 0, 5, 5, 0]), rise, -rise):
        cases.append((f"special {x[:4]}", x[None], rng.normal(size=(3, x.size)), 1.0, 1))
    cases.append(("integer ties", rng.integers(-2, 3, size=(64, 40)).astype(np.float64), rng.normal(size=(3, 40)), 1.0, 2))
    return cases


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("max_phases", [9, 16, 32, 64])
def test_wide_body_on_host(tail_host, max_phases, collect):
    """The wide build's body (views of the compacted lists, loops to the
    counts, the O(phases) overlap rule, the fill) writes every output, and
    the last maximum K3 keeps, bit for bit as the body every build ran
    before it, at 64 slots, on one
    lane of the host; and both equal the plain version in segmentation,
    the fill in value (an empty plain sum may read -0.0), the masked
    floats within 1e-10."""
    for name, x, keys, volume, smooth in _tail_host_inputs(max_phases):
        old = _tail_host_run(tail_host, 0, x, keys, volume, max_phases, smooth, collect)
        new = _tail_host_run(tail_host, 1, x, keys, volume, max_phases, smooth, collect)
        for k in old:
            assert old[k].tobytes() == new[k].tobytes(), (name, k)
        meta = TS.HistMeta(nspec=keys.shape[0] - 1, max_order=2, used_ke=False, smooth=smooth, max_phases=max_phases)
        pt, props = TSG.thermo_key_core(torch.as_tensor(x), torch.as_tensor(keys), meta, torch.tensor(volume, dtype=torch.float64), collect=collect)
        want = {"fe": pt.fe, "left": pt.left, "right": pt.right, "mask": pt.mask, "n_phases": pt.n_phases, "valid": pt.valid, **props}
        want = {k: v.numpy() for k, v in want.items()}
        for k in SEG:
            np.testing.assert_array_equal(new[k].astype(want[k].dtype), want[k], err_msg=f"{name} {k}")
        for k in ("fe",) + PROPS:
            m = want["mask"] if new[k].ndim == 2 else np.broadcast_to(want["mask"][..., None], new[k].shape)
            np.testing.assert_array_equal(new[k][~m], want[k][~m], err_msg=f"{name} {k}")  # the plain version's sums may be -0.0
            assert worst_abs_diff(new[k], want[k], want["mask"]) <= 1e-10, (name, k)


# ---- K3's cell (csrc/iso_cell.cuh) on the host: x_m formed once against
# x_m formed on read, and against the plain version ----


def _host_iso_inputs(surface):
    """(prologue tensors on the CPU, meta kwargs, beta, sizes) of a small
    isopleth grid whose dMu_2 rows reach past both sources (clamped rows):
    the overflow31 sources (ten_peak), the n31 ones (one and two phases),
    n31's with a random edge-peaked surface (the last bins count: maxima
    at the ends, edge guards that fail) and the overflow1400 ones
    (ripple1400, N = 1400, smooth 2)."""
    if surface == "ten31":
        ds, mk = iso_sources("n31", lnpi=ten_peak())
        beta, mu1_v, NY = 1.001, np.linspace(4.9, 5.1, 23), 17
    elif surface in ("n31", "edge31"):
        lnpi = random_surface("edge_peaks", 31, np.random.default_rng(5)) if surface == "edge31" else None
        ds, mk = iso_sources("n31", lnpi=lnpi)
        beta, mu1_v, NY = 1.02, np.linspace(*mu_window(**CELLS["n31"]), 23), 17
    else:
        ds, mk = iso_sources("n1400", lnpi=ripple1400())
        beta, mu1_v, NY = ISO1400["beta"], np.linspace(*mu_window(**CELLS["n1400"]), 7), 5
    dmu2_v = np.linspace(-5.3, -3.7, NY)
    hs = [histogram.from_composite(composite_raw(d, mk["nspec"], mk["max_order"]), d["curr_beta"], d["curr_mu"], smooth=mk["smooth"], ke=mk["used_ke"], device="cpu") for d in ds]
    iso = isopleth(hs, beta, order=1)
    lr, wts = iso._bracket(dmu2_v, 2.5)
    return [h._hist() for h in hs], mk, beta, mu1_v, dmu2_v, lr, wts


def _host_iso_run(lib, cap, xm_once, pro, meta, order, collect, cutoff=10.0):
    """K3's cells through the host-built iso_cell_run; outputs start
    poisoned."""
    W, N = pro["lnpi"].shape
    NX, NY = pro["mu"].shape[0], pro["lr"].shape[0]
    t = {k: np.ascontiguousarray(v.numpy()) for k, v in pro.items()}
    t["edge"] = t["edge"].astype(np.uint8)
    o = {"z": np.full((NY, NX), 12345.0), "rho": np.full((NY, NX), 12345.0), "fe": np.full((NY, NX), 12345.0),
         "ok": np.full((NY, NX), 9, np.uint8), "code": np.full((NY, NX), -7, np.int32)}
    rc = lib.iso_cell_run(cap, xm_once, *(t[k].ctypes.data for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")),
                          W, NX, NY, N, CM.n_xrows(2, order), CM.n_groups(2, order, False), meta.max_phases, meta.smooth, order,
                          int(collect == "janus"), cutoff, *(o[k].ctypes.data for k in ("z", "rho", "fe", "ok", "code")))
    assert rc == 0
    return o


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("surface", ["ten31", "n31", "edge31", "ripple1400"])
def test_iso_cell_on_host(tail_host, surface, order, collect):
    """K3's cell as the kernel runs it (csrc/iso_cell.cuh, one lane a
    cell, built with g++ for the host): the wide build with x_m formed once
    into its area writes every output bit for bit as with x_m formed on
    read; both, and the first build at 8 slots, equal the plain version
    (iso_grid_body) in ok and fail_code, floats within 1e-10 on ok cells.
    ten31 and ripple1400 overflow 8 slots on every cell (without janus,
    which merges the phases first)."""
    srcs, mk, beta, mu1_v, dmu2_v, lr, wts = _host_iso_inputs(surface)
    for P in (8, 16, 64):
        meta = TS.HistMeta(**dict(mk, max_phases=P))
        pro = IB._iso_prologue(srcs, meta, mu1_v, dmu2_v, lr, wts, beta, order, 10.0)
        want = IB.iso_grid_body(srcs, [meta] * len(srcs), mu1_v, dmu2_v, lr, wts, beta, order, 10.0, collect)
        cap = CS.capacity(P)
        runs = [_host_iso_run(tail_host, cap, 0, pro, meta, order, collect)]
        if cap == CS.CAPACITIES[-1]:
            runs.append(_host_iso_run(tail_host, cap, 1, pro, meta, order, collect))
            for k in runs[0]:
                assert runs[0][k].tobytes() == runs[1][k].tobytes(), (P, k)
        ok = want[3].numpy()
        for got in runs:
            np.testing.assert_array_equal(got["ok"].astype(bool), ok, err_msg=f"P={P} ok")
            np.testing.assert_array_equal(got["code"], want[4].numpy(), err_msg=f"P={P} fail_code")
            for k, w in zip(("z", "rho", "fe"), want[:3]):
                assert worst_abs_diff(got[k], w.numpy(), ok) <= 1e-10, (P, k)
                assert (got[k][~ok] == 0.0).all(), (P, k)
        if surface in ("ten31", "ripple1400"):
            if P == 8 and collect is None:
                assert (want[4] == 3).all()
            elif P == 64:
                assert ok.mean() > 0.5
        elif surface == "n31":
            assert ok.mean() > 0.3
