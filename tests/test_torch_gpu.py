"""PyTorch port on the card: the fused kernels (K1, the mu sweep; K2, the
(mu, beta, dMu) sweep, and its paired mode; K3, the isopleth cell) against
their plain versions on the same card, and the coexistence solver through
the kernels against its plain objective.
Imports no JAX, so it runs on the GPU machine:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(--noconftest: tests/conftest.py imports JAX, which that machine lacks.)
The 2-D surface path (plain PyTorch on the card, no kernel of its own) is
held here against the host flood, the class numpy engine and its own CPU
run.

Segmentation fields (for K3: ok and fail_code) must be equal; fe and the
properties agree to 1e-10 absolute on valid masked slots (the JAX
package's own kernel bar, tests/test_pallas_sweep.py): the kernel sums in
another order and uses the card's f64 exp/log.  K1 and K2 are checked at
the G (lanes per point) their rule picks and forced to every G they build:
the layout changes only the order of the sums.  K3 likewise, at the G
its rule picks and at G = 1 and 32.  K2's paired mode equals the product
mode's point (m, tix[m]) bit for bit at each G.  The solver through the
kernels ends where engine="torch" does: convergence equal, mu_star within
1e-9 (the JAX package's bar between two trace engines), and the
properties at its mu_star within 1e-10 of the plain version's.
The row former (K2's rows in one launch) writes pipeline._mb_rows' rows
bit for bit, once a sweep and once a source or solve, and the solver's
and the isopleth's outputs from its rows equal those from the plain rows.
The wide builds (64 phase slots; K1's 6 per-phase sums for nspec 3-4)
are held the same way on the capacity inputs (torch_composites CAPACITY,
ten_peak): K1 at max_phases 9, 16, 32 and 64 and at nspec 3 and 4, K2 in
both modes and K3 at 16 and 64, every wrapper raising at 65 slots (and
K1 at 5 species) before any launch.  The wide build writes the slots
past each point's count as a fill: those equal the plain version's at
every G on multi573 (None and janus, 16-64 slots) and on surfaces of 63,
64 and 65 maxima (one slot of fill, every slot real, overflow).  K3's
wide build, which forms each cell's x_m once in shared memory where a
block's area fits, is held on overflow31 and overflow1400 (ripple1400)
against its plain version and bit for bit against x_m formed on read;
the host's count of the area equals the library's, and an area forced
past what the card grants raises.  K2's x' area (each point's x' formed
once a bin into shared memory at G = 1 and small N) returns the re-forming
route's outputs bit for bit over orders, nspec, props, first_order_mom,
janus, both modes and both builds; the host's rule equals the library's,
and launches.k2_xarea counts the launches that take it.
"""

import sys


import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_iso as CI
import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
from fhmcanalysis_torch.binary import isopleth
from fhmcanalysis_torch.utils.profiling import counters
from torch_composites import CAPACITY, CELLS, make_composite, ISO31, ISO1400, ROW_CASES, ROW_MAX_ORDERS, capacity_cell, ripple1400, coex31_guesses, ten_peak, coex_grid, ISO_FIVE_DMU2, ISO_NARROW, ISO_PARTIAL, SURFACE_KINDS, cell, iso_grid_args, iso_sources, janus_surfaces, mb_grid, mu_window, port_histogram, random_surface, row_inputs, shuffled_mu_grid, worst_abs_diff

IB = sys.modules["fhmcanalysis_torch.binary.isopleth"]

SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")
LANES = (None,) + CS.LANES  # the rule's pick, then every G forced


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU machine: python -m pytest -m gpu --noconftest tests/test_torch_gpu.py)")
    return torch.device("cuda", 0)


def _compare(h, meta, mus, props, collect):
    want = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="torch")
    ok = (want["mask"] & want["valid"][:, None]).cpu()
    for G in LANES:
        n0 = counters().get("launches.k1", 0)
        got = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda", _lanes=G)
        torch.cuda.synchronize()
        assert counters().get("launches.k1", 0) == n0 + 1
        assert set(got) == set(want)
        for k in SEG:
            assert torch.equal(got[k], want[k]), (G, k)
        for k in ("fe",) + (PROPS if props else ()):
            assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, (G, k)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_kernel_matches_plain_cells(cuda, name, props, collect):
    d, mk, mus = cell(name, 2048)
    _compare(TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, props, collect)


@pytest.mark.gpu
@pytest.mark.parametrize("max_phases", [1, 4, 8])
@pytest.mark.parametrize("smooth", [1, 2])
@pytest.mark.parametrize("kind", SURFACE_KINDS)
def test_kernel_matches_plain_structures(cuda, kind, smooth, max_phases):
    d, mk, _ = cell("n31")
    rng = np.random.default_rng(SURFACE_KINDS.index(kind) + 10 * smooth)
    meta = TS.HistMeta(**dict(mk, smooth=smooth, max_phases=max_phases))
    for _ in range(4):
        h = TS.from_host(dict(d, lnpi=random_surface(kind, 31, rng)), device=cuda)
        _compare(h, meta, np.linspace(4.85, 5.15, 64), True, None)


@pytest.mark.gpu
@pytest.mark.parametrize("max_phases", [1, 8])
@pytest.mark.parametrize("name", ["n573", "n1400"])
def test_kernel_phase_slots_large_n(cuda, name, max_phases):
    """P = 1 and 8 at large N, where the rule keeps one warp per point."""
    d, mk, mus = cell(name, 512)
    _compare(TS.from_host(d, device=cuda), TS.HistMeta(**dict(mk, max_phases=max_phases)), mus, True, None)


@pytest.mark.gpu
@pytest.mark.parametrize("surface", range(4))
def test_kernel_janus_multipeak(cuda, surface):
    d, mk, _ = cell("n1400")
    h = TS.from_host(dict(d, lnpi=janus_surfaces(1400)[surface] * 10.0), device=cuda)
    _compare(h, TS.HistMeta(**mk), np.linspace(4.99, 5.01, 256), True, "janus")


@pytest.mark.gpu
def test_kernel_rejects_unsupported(cuda):
    """Past the widest build (65 phase slots, 5 species) and a wrong
    dtype raise before any launch; 9 slots, which raised before the wide
    build, run the kernel and equal the plain version."""
    d, mk, mus = cell("n31", 8)
    h = TS.from_host(d, device=cuda)
    n0 = counters().get("launches.k1", 0)
    with pytest.raises(ValueError, match="max_phases=65 outside the kernels' 1..64"):
        TP.mu_sweep_thermo(h, TS.HistMeta(**dict(mk, max_phases=65)), mus)
    keys5 = torch.zeros((6, h.nbins), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="nspec=5 outside K1's 1..4"):
        CS.sweep_thermo(h.lnpi, h.op, keys5, h.volume, torch.zeros(3, dtype=torch.float64, device=cuda), 1, 4)
    with pytest.raises(TypeError, match="float64"):
        CS.sweep_thermo(h.lnpi.float(), h.op, h.mom[:2, 1, 0, 0, 0], h.volume, torch.zeros(3, dtype=torch.float64, device=cuda), 1, 4)
    assert counters().get("launches.k1", 0) == n0
    _compare(h, TS.HistMeta(**dict(mk, max_phases=9)), mus, True, None)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("max_phases", [8, 9, 16, 32, 64])
def test_kernel_phase_slots_multi573(cuda, max_phases, collect):
    """multi573 (11-25 maxima over the window): 8 slots overflow on every
    point, 16 hold some, 32 and 64 all; the wide build (9 and up) against
    the plain version at the rule's G and at every G."""
    d, mk, mus = capacity_cell("multi573", 2048, max_phases=max_phases)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    _compare(h, meta, mus, True, collect)
    valid = TP.mu_sweep_thermo(h, meta, mus, props=False, engine="torch")["valid"]
    share = float(valid.double().mean())
    if max_phases <= 9:
        assert share == 0.0
    elif max_phases == 16:
        assert 0.0 < share < 1.0
    else:
        assert share == 1.0


def _compare_wide(h, meta, mus, collect, lanes=LANES):
    """K1 against the plain version on every slot: segmentation equal; the
    slots past the count (mask False) bit for bit, as the wide build fills
    them; every masked slot, of valid and invalid points, within 1e-10.
    Returns the outputs by G."""
    want = {k: v.cpu() for k, v in TP.mu_sweep_thermo(h, meta, mus, props=True, collect=collect, engine="torch").items()}
    outs = {}
    for G in lanes:
        got = {k: v.cpu() for k, v in TP.mu_sweep_thermo(h, meta, mus, props=True, collect=collect, engine="cuda", _lanes=G).items()}
        for k in SEG:
            assert torch.equal(got[k], want[k]), (G, k)
        for k in ("fe",) + PROPS:
            m = want["mask"] if got[k].dim() == 2 else want["mask"][..., None].expand_as(got[k])
            assert torch.equal(got[k][~m], want[k][~m]), (G, k, "fill")
            assert worst_abs_diff(got[k], want[k], want["mask"]) <= 1e-10, (G, k)
        outs[G] = got
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("max_phases", [16, 32, 64])
def test_kernel_wide_fill_multi573(cuda, max_phases, collect):
    """The wide build on multi573 (11-25 maxima; janus collect included):
    the slots past each point's count equal the plain version's bit for
    bit at every G, and G = 1 and G = 32 agree in segmentation and fill."""
    d, mk, mus = capacity_cell("multi573", 2048, max_phases=max_phases)
    outs = _compare_wide(TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, collect)
    g1, g32 = outs[1], outs[32]
    for k in SEG:
        assert torch.equal(g1[k], g32[k]), k
    fill = ~g1["mask"]
    assert torch.equal(g1["fe"][fill], g32["fe"][fill]) and bool(fill.any())


def _n_peak_surface(n_peaks):
    """n_peaks maxima at the odd bins of 2 n_peaks + 1 bins, minima at the
    even ones (both ends), a slight tilt so no two bins tie."""
    t = np.arange(2 * n_peaks + 1, dtype=np.float64)
    return (t % 2) + 1e-3 * t


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("n_peaks", [63, 64, 65])
def test_kernel_wide_every_slot_and_overflow(cuda, n_peaks, collect):
    """A surface with exactly 64 maxima fills every slot of the widest
    build (valid); one with 65 overflows it (valid False, n_phases 65,
    every slot masked as the plain version writes it); 63 leaves one
    slot to the fill.  K1 at every G, and K2 at identity targets."""
    lnpi = _n_peak_surface(n_peaks)
    d, mk, _ = cell("n31", max_order=3)
    N = lnpi.size
    d = dict(d, lnpi=lnpi, op=np.arange(N, dtype=np.float64), mom=np.broadcast_to(d["mom"][..., :1], d["mom"].shape[:-1] + (N,)).copy())
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**dict(mk, smooth=1, max_phases=64))
    mus = h.curr_mu[0].item() + np.linspace(-1e-6, 1e-6, 96)
    outs = _compare_wide(h, meta, mus, collect)
    got = outs[None]
    if collect is None:
        assert bool((got["n_phases"] == n_peaks).all() if n_peaks <= 64 else (got["n_phases"] > 64).all())
        assert bool(got["valid"].all()) == (n_peaks <= 64)
        assert int(got["mask"].sum(-1).max()) == min(n_peaks, 64)
    else:  # janus merges all peaks but the last into one
        assert bool((got["n_phases"] == 2).all())
    dref = (h.curr_mu[1:] - h.curr_mu[0]).cpu().numpy()[None]
    for G in LANES:
        k2 = TP.mu_beta_sweep_thermo(h, meta, mus, h.curr_beta.reshape(1).cpu().numpy(), dref, order=1, props=True, collect=collect, engine="cuda", _lanes=G)
        for k in outs[G]:
            assert torch.equal(k2[k][:, 0].cpu(), outs[G][k]), (G, k)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("name", ["tern573", "quat573"])
def test_kernel_nspec_3_4(cuda, name, props, collect):
    """K1's build of 6 per-phase sums on three and four species, and at
    16 slots (the build of 64 slots and 6 sums)."""
    for max_phases in (4, 16):
        d, mk, mus = capacity_cell(name, 2048, max_phases=max_phases)
        _compare(TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, props, collect)


def _mb_inputs(cuda, name, used_ke=False, M=256, A=8):
    d, mk, mus = cell(name, M, max_order=3, used_ke=used_ke)
    dref = d["curr_mu"][1:] - d["curr_mu"][0]
    dmus = dref + np.linspace(-0.5, 0.5, A)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
    return TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, np.linspace(0.92, 1.08, A), dmus


def _mb_compare(h, meta, mus, betas, dmus, **kw):
    want = TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, engine="torch", **kw)
    ok = (want["mask"] & want["valid"][..., None]).cpu()
    for G in LANES:
        n0 = counters().get("launches.k2", 0)
        got = TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, engine="cuda", _lanes=G, **kw)
        torch.cuda.synchronize()
        assert counters().get("launches.k2", 0) == n0 + 1
        assert set(got) == set(want)
        for k in SEG:
            assert torch.equal(got[k], want[k]), (G, k)
        for k in ("fe",) + (PROPS if kw.get("props", True) else ()):
            assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, (G, k)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("order,first_order_mom", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("name,used_ke", [("n31", False), ("n31", True), ("n573", False), ("n1400", False)])
def test_mb_kernel_matches_plain(cuda, name, used_ke, order, first_order_mom, props, collect):
    h, meta, mus, betas, dmus = _mb_inputs(cuda, name, used_ke)
    _mb_compare(h, meta, mus, betas, dmus, order=order, props=props, first_order_mom=first_order_mom, collect=collect)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_mb_identity_targets_equal_k1(cuda, name, props, collect):
    """At beta = beta_ref, dMu = dMu_ref K2 returns K1's output bit for bit,
    at the rule's G and at every G forced on both."""
    h, meta, mus, _, _ = _mb_inputs(cuda, name)
    dref = (h.curr_mu[1:] - h.curr_mu[0]).cpu().numpy()[None]
    for G in LANES:
        k1 = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda", _lanes=G)
        for order in (1, 2):
            k2 = TP.mu_beta_sweep_thermo(h, meta, mus, h.curr_beta.reshape(1).cpu().numpy(), dref, order=order, props=props, collect=collect, engine="cuda", _lanes=G)
            for k in k1:
                assert torch.equal(k2[k][:, 0], k1[k]), (G, order, k)


@pytest.mark.gpu
def test_mb_main_path_through_k2(cuda):
    """engine='auto' on CUDA tensors launches K2 once; it never runs the
    plain version, and it raises for what K2 does not take."""
    d, mk, mus, betas, dmus = mb_grid(M=512, A=16)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n0 = counters().get("launches.k2", 0)
    out = TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2)
    assert counters().get("launches.k2", 0) == n0 + 1 and out["fe"].is_cuda and out["fe"].shape == (512, 16, meta.max_phases)
    with pytest.raises(ValueError, match="max_phases=65 outside the kernels' 1..64"):
        TP.mu_beta_sweep_thermo(h, TS.HistMeta(**dict(mk, max_phases=65)), mus, betas, dmus)
    assert counters().get("launches.k2", 0) == n0 + 1
    out = TP.mu_beta_sweep_thermo(h, TS.HistMeta(**dict(mk, max_phases=9)), mus, betas, dmus, order=2)
    assert counters().get("launches.k2", 0) == n0 + 2 and out["fe"].shape == (512, 16, 9)


# The row former (cuda_mb.mb_rows): _mb_rows in one launch, bit for bit.


def _bits_equal(got, want):
    """Equal bit for bit (floats through their int64 view, so -0.0 and a
    NaN's payload count too)."""
    if isinstance(got, np.ndarray):
        return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    if got.dtype == torch.float64:
        return got.shape == want.shape and torch.equal(got.contiguous().view(torch.int64), want.contiguous().view(torch.int64))
    return torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("used_ke", [False, True])
@pytest.mark.parametrize("max_order", ROW_MAX_ORDERS)
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_mb_rows_equal_plain_bit_for_bit(cuda, name, max_order, used_ke):
    """One launch of the row former writes _mb_rows' rows bit for bit on
    the card, at N = 31, 573 and 1400, over orders 1-2, props, first_order_mom,
    used_ke and max_order 1-4, on the cell's composite and on moments of
    random normals; where _mb_rows raises, it raises the same before any
    launch."""
    xs, mk = row_inputs(name, max_order, used_ke)
    meta = TS.HistMeta(**mk)
    for x in xs:
        h = TS.from_host(x, device=cuda)
        for order, props, fom in ROW_CASES:
            n0 = counters().get("launches.mb_rows", 0)
            try:
                want = TP._mb_rows(h, meta, order, props, fom)
            except (ValueError, IndexError) as e:
                with pytest.raises(type(e)):
                    CM.mb_rows(h, meta, order, props, fom)
                assert counters().get("launches.mb_rows", 0) == n0
                continue
            got = CM.mb_rows(h, meta, order, props, fom)
            assert counters().get("launches.mb_rows", 0) == n0 + 1
            assert _bits_equal(got[0], want[0]), (order, props, fom)
            assert (got[1] is None) == (not props) and (not props or _bits_equal(got[1], want[1])), (order, props, fom)


@pytest.mark.gpu
def test_mb_rows_once_a_sweep(cuda):
    """mu_beta_sweep_thermo on CUDA launches the row former once a call
    ("cuda" and "auto"), the plain version ("torch") never; a Hist of more
    than one state is refused before any launch."""
    d, mk, mus, betas, dmus = mb_grid(M=64, A=4)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    for engine, launches in (("cuda", 1), ("auto", 1), ("torch", 0)):
        n0 = counters().get("launches.mb_rows", 0)
        TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2, engine=engine)
        assert counters().get("launches.mb_rows", 0) == n0 + launches, engine
    n0 = counters().get("launches.mb_rows", 0)
    with pytest.raises(ValueError, match="mb_rows: needs one state"):
        CM.mb_rows(h.replace(lnpi=h.lnpi[None].expand(2, -1)), meta, 2, True, False)
    assert counters().get("launches.mb_rows", 0) == n0


def _plain_rows(monkeypatch):
    """Route every caller of pipeline._rows to the plain _mb_rows."""
    monkeypatch.setattr(TP, "_rows", lambda h, meta, order, props, fom, kernel: TP._mb_rows(h, meta, order, props, fom))


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_mb_rows_in_the_solver(cuda, order, monkeypatch):
    """trace_coexistence on the kernel route builds its rows with the row
    former, and its outputs equal those from the plain rows bit for bit."""
    d, mk, betas, guess, kw = coex_grid(16)
    kw = dict(kw, order=order)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n0 = counters().get("launches.mb_rows", 0)
    got = TSV.trace_coexistence(h, meta, betas, guess, **kw)
    torch.cuda.synchronize()
    assert counters().get("launches.mb_rows", 0) - n0 >= 1
    _plain_rows(monkeypatch)
    n0 = counters().get("launches.mb_rows", 0)
    want = TSV.trace_coexistence(h, meta, betas, guess, **kw)
    assert counters().get("launches.mb_rows", 0) == n0
    assert set(got) == set(want)
    for k in got:
        assert _bits_equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_mb_rows_in_the_isopleth(cuda, order, monkeypatch):
    """make_grid on the kernel route forms each source's rows with one
    launch of the row former, and its grid equals the one from the plain
    rows bit for bit."""
    grid = iso_grid_args(ISO31, NX=48, NY=12)
    mu1_v, dmu2_v = np.linspace(*grid[0], 48), np.linspace(*grid[1], 12)
    iso, srcs, _, lr, _ = _iso(cuda, "n31", order, 1.02, mu1_v, dmu2_v)
    keys = ("Z", "density", "F.E./kT", "valid", "fail_code")
    n0 = counters().get("launches.mb_rows", 0)
    iso.make_grid(*grid, engine="cuda")
    assert counters().get("launches.mb_rows", 0) - n0 == len(set(np.asarray(lr).ravel().tolist())) == len(srcs)
    got = {k: iso.data[k].copy() for k in keys}
    _plain_rows(monkeypatch)
    iso.make_grid(*grid, engine="cuda")
    assert got["valid"].mean() > 0.3
    for k in keys:
        assert _bits_equal(got[k], iso.data[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("max_phases", [9, 16, 64])
def test_mb_kernel_phase_slots_multi573(cuda, max_phases, order, collect):
    """K2's build of 64 slots on multi573, 256 mu x 8 targets, against
    the plain version at the rule's G and at every G."""
    d, mk, mus = capacity_cell("multi573", 256, max_order=3, max_phases=max_phases)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, 8)[:, None]
    _mb_compare(TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, np.linspace(0.95, 1.05, 8), dmus, order=order, collect=collect)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("max_phases", [16, 64])
def test_mb_identity_targets_equal_k1_wide(cuda, max_phases, props, collect):
    """At identity targets K2's build of 64 slots returns K1's (64 slots,
    6 sums) output bit for bit, at the rule's G and at every G."""
    d, mk, mus = capacity_cell("multi573", 2048, max_order=3, max_phases=max_phases)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    dref = (h.curr_mu[1:] - h.curr_mu[0]).cpu().numpy()[None]
    for G in LANES:
        k1 = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda", _lanes=G)
        for order in (1, 2):
            k2 = TP.mu_beta_sweep_thermo(h, meta, mus, h.curr_beta.reshape(1).cpu().numpy(), dref, order=order, props=props, collect=collect, engine="cuda", _lanes=G)
            for k in k1:
                assert torch.equal(k2[k][:, 0], k1[k]), (G, order, k)


@pytest.mark.gpu
@pytest.mark.parametrize("max_phases", [16, 64])
def test_mb_paired_wide_equals_product_and_plain(cuda, max_phases):
    """K2's paired mode in the build of 64 slots: the product mode's
    point (m, tix[m]) bit for bit at every G, and the plain version."""
    d, mk, mus = capacity_cell("multi573", 1024, max_order=3, max_phases=max_phases)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    A = 16
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.4, 0.4, A)[:, None]
    inputs = TP._mb_inputs(h, meta, mus, np.linspace(0.95, 1.05, A), dmus, 1, True, False)
    t = torch.as_tensor(np.random.default_rng(max_phases).integers(0, A, size=1024), dtype=torch.int32, device=cuda)
    rows = torch.arange(1024, device=cuda) * A + t.long()
    want = TP._mb_paired_body(h, meta, *inputs, t, 1, True, None)
    ok = (want["mask"] & want["valid"][:, None]).cpu()
    for G in CS.LANES:
        prod, got = _k2(h, meta, inputs, 1, True, None, _lanes=G), _k2(h, meta, inputs, 1, True, None, tix=t, _lanes=G)
        torch.cuda.synchronize()
        for k in prod:
            assert torch.equal(got[k], prod[k][rows]), (G, k)
        for k in SEG:
            assert torch.equal(got[k], want[k]), (G, k)
        for k in ("fe",) + PROPS:
            assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, (G, k)


def _surface(name):
    d, mk, _ = cell("n31", max_order=3)
    return (dict(d, lnpi=-d["lnpi"]) if name == "negated" else d), mk


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("surface", ["n31", "negated"])
def test_kernel_shuffled_grid(cuda, surface, props, collect):
    """K1 on the shuffled mu grid: every warp mixes segmentation cases
    (tests/test_torch_layout.py checks that), and 1,003 points leave a
    partial block and a partial warp at every G."""
    d, mk = _surface(surface)
    _compare(TS.from_host(d, device=cuda), TS.HistMeta(**mk), shuffled_mu_grid(1003, seed=3), props, collect)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order,first_order_mom", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("surface", ["n31", "negated"])
def test_mb_kernel_shuffled_grid(cuda, surface, order, first_order_mom, collect):
    """K2 on the shuffled mu grid, 167 mu x 3 targets = 501 points."""
    d, mk = _surface(surface)
    h = TS.from_host(d, device=cuda)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.array([[-0.3], [0.0], [0.4]])
    _mb_compare(h, TS.HistMeta(**mk), shuffled_mu_grid(167, seed=4), np.array([0.95, 1.0, 1.05]), dmus, order=order, first_order_mom=first_order_mom, collect=collect)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7, 33, 255, 257, 1000])
def test_kernel_partial_blocks(cuda, B):
    """Point counts that fill no block and no warp whole, at every G."""
    d, mk, mus = cell("n31", B)
    _compare(TS.from_host(d, device=cuda), TS.HistMeta(**mk), mus, True, None)


@pytest.mark.gpu
def test_kernel_rejects_invalid_lanes(cuda):
    """A forced G the kernels do not build raises before any launch."""
    d, mk, mus = cell("n31", 8, max_order=3)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n1, n2 = counters().get("launches.k1", 0), counters().get("launches.k2", 0)
    for G in (0, 3, 4, 64):
        with pytest.raises(ValueError, match="lanes per point"):
            TP.mu_sweep_thermo(h, meta, mus, _lanes=G)
        with pytest.raises(ValueError, match="lanes per point"):
            TP.mu_beta_sweep_thermo(h, meta, mus, [1.0], [[-5.0]], _lanes=G)
    assert (counters().get("launches.k1", 0), counters().get("launches.k2", 0)) == (n1, n2)


def _iso(cuda, name, order, beta, mu1_v, dmu2_v, **kw):
    ds, mk = iso_sources(name, **kw)
    iso = isopleth([port_histogram(d, mk, device=cuda) for d in ds], beta, order=order)
    lr, wts = iso._bracket(dmu2_v, 2.5)
    return iso, [h._hist() for h in iso.data["histograms"]], mk, lr, wts


def _iso_equal(got, want, min_ok=0.3):
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    ok = want[3].cpu()
    assert float(ok.double().mean()) >= min_ok, "grid mostly invalid: the comparison would be vacuous"
    for k in range(3):
        assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, k


def _iso_compare(args, min_ok=0.3):
    """K3 at the rule's G and at every G forced against one plain run."""
    want = IB.iso_grid(*args, engine="torch")
    for G in LANES:
        n0 = counters().get("launches.k3", 0)
        got = IB.iso_grid(*args, engine="cuda", _lanes=G)
        torch.cuda.synchronize()
        assert counters().get("launches.k3", 0) == n0 + 1, G
        _iso_equal(got, want, min_ok)


_X31 = np.linspace(0.0, 1.0, 31)
_THREE_PEAK = 11.5 * np.exp(-((_X31 - 0.15) ** 2) / 0.004) + 11.3 * np.exp(-((_X31 - 0.45) ** 2) / 0.003) + 12 * np.exp(-((_X31 - 0.8) ** 2) / 0.006)


@pytest.mark.gpu
@pytest.mark.parametrize("max_phases", [4, 8])
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize(
    "name,kw",
    [
        ("n31", {}),
        ("n31", {"dmu2s": (-5.0, -4.6, -4.2)}),
        ("n31", {"used_ke": True}),
        ("n31", {"lnpi": _THREE_PEAK}),
        ("n1400", {}),
    ],
)
def test_iso_kernel_matches_plain(cuda, name, kw, order, collect, max_phases):
    """K3 vs its plain version at the rule's G and at G = 1 and 32 (N =
    1400 at G = 1 reads its rows from global memory: they do not fit in
    shared memory); the dMu_2 rows reach past the sources, so the end rows
    are clamped to one source (L == R)."""
    three = "lnpi" in kw
    beta = 1.001 if three else (1.0 if name == "n1400" else 1.02)
    mu1_v = np.linspace(*((4.9, 5.1) if three else mu_window(**CELLS[name])), 64)
    dmu2_v = np.linspace(-4.9, -4.1, 16) if three else np.linspace(-5.3, -3.7, 32)
    iso, srcs, mk, lr, wts = _iso(cuda, name, order, beta, mu1_v, dmu2_v, **kw)
    metas = [TS.HistMeta(**dict(mk, max_phases=max_phases))] * len(srcs)
    _iso_compare((srcs, metas, mu1_v, dmu2_v, lr, wts, beta, order, 10.0, collect))
    if name == "n1400":
        assert CI.staged_sources(1, len(srcs), 64, 32, 1400, order) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("grid", ["narrow", "partial"])
def test_iso_kernel_shapes(cuda, grid, order, collect):
    """K3 on torch_composites' shape grids at every G: the narrow grid over
    five sources, where a block at one cell per lane stages every source
    it names, and 7 x 256 + 13 cells, whose last block is partial."""
    g, dmu2s = (ISO_NARROW, ISO_FIVE_DMU2) if grid == "narrow" else (ISO_PARTIAL, (-5.0, -4.0))
    mu1, dmu2, _ = iso_grid_args(g)
    mu1_v, dmu2_v = np.linspace(*mu1, g["NX"]), np.linspace(*dmu2, g["NY"])
    iso, srcs, mk, lr, wts = _iso(cuda, g["name"], order, g["beta"], mu1_v, dmu2_v, dmu2s=dmu2s)
    if grid == "narrow":
        assert len(srcs) == 5 and CI.staged_sources(1, 5, g["NX"], g["NY"], 31, order) == 5
    else:
        assert g["NX"] * g["NY"] % 256 == 13
    _iso_compare((srcs, [TS.HistMeta(**dict(mk, max_phases=8))] * len(srcs), mu1_v, dmu2_v, lr, wts, g["beta"], order, 10.0, collect))


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_make_grid_cuda_matches_torch(cuda, order):
    """make_grid(engine="cuda") against engine="torch" on the same
    histograms; "auto" on CUDA histograms launches K3 once."""
    grid = iso_grid_args(ISO31, NX=96, NY=24)
    mu1_v, dmu2_v = np.linspace(*grid[0], 96), np.linspace(*grid[1], 24)
    iso, _, _, _, _ = _iso(cuda, "n31", order, 1.02, mu1_v, dmu2_v)
    out = {}
    for engine in ("cuda", "torch", "auto"):
        n0 = counters().get("launches.k3", 0)
        iso.make_grid(*grid, engine=engine)
        assert counters().get("launches.k3", 0) == n0 + (engine != "torch")
        out[engine] = {k: iso.data[k] for k in ("Z", "density", "F.E./kT", "valid", "fail_code")}
    for k in ("valid", "fail_code"):
        assert np.array_equal(out["cuda"][k], out["torch"][k]) and np.array_equal(out["auto"][k], out["cuda"][k]), k
    ok = out["torch"]["valid"]
    assert ok.mean() > 0.5
    for k in ("Z", "density", "F.E./kT"):
        assert worst_abs_diff(out["cuda"][k], out["torch"][k], ok) <= 1e-10, k


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_iso_kernel_sources_with_their_own_op(cuda, order):
    """Each source keeps its own order parameter in K3 (source 1's op
    skips one value past its middle)."""
    ds, mk = iso_sources()
    hs = [port_histogram(d, mk, device=cuda) for d in ds]
    hs[1].data["ntot"] = hs[1].data["ntot"] + (hs[1].data["ntot"] >= 15)
    iso = isopleth(hs, 1.02, order=order)
    mu1_v, dmu2_v = np.linspace(*mu_window(**CELLS["n31"]), 64), np.linspace(-5.3, -3.7, 32)
    lr, wts = iso._bracket(dmu2_v, 2.5)
    srcs = [h._hist() for h in iso.data["histograms"]]
    assert not torch.equal(srcs[0].op, srcs[1].op)
    _iso_compare((srcs, [TS.HistMeta(**dict(mk, max_phases=8))] * 2, mu1_v, dmu2_v, lr, wts, 1.02, order, 10.0))


@pytest.mark.gpu
def test_iso_kernel_rejects_unsupported(cuda):
    mu1_v, dmu2_v = np.linspace(-50, 10, 8), np.linspace(-4.9, -4.1, 4)
    iso, srcs, mk, lr, wts = _iso(cuda, "n31", 1, 1.02, mu1_v, dmu2_v)
    with pytest.raises(ValueError, match="max_phases=65 outside the kernels' 1..64"):
        IB.iso_grid(srcs, [TS.HistMeta(**dict(mk, max_phases=65))] * 2, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0)
    n9 = counters().get("launches.k3", 0)
    _iso_equal(IB.iso_grid(srcs, [TS.HistMeta(**dict(mk, max_phases=9))] * 2, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0),
               IB.iso_grid(srcs, [TS.HistMeta(**dict(mk, max_phases=9))] * 2, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0, engine="torch"), min_ok=0.0)
    assert counters().get("launches.k3", 0) == n9 + 1
    with pytest.raises(KeyError):
        IB.iso_grid(srcs, [TS.HistMeta(**mk)] * 2, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0, collect="nope")
    n0 = counters().get("launches.k3", 0)
    for G in (0, 2, 16, 64):
        with pytest.raises(ValueError, match="lanes per point"):
            IB.iso_grid(srcs, [TS.HistMeta(**mk)] * 2, mu1_v, dmu2_v, lr, wts, 1.02, 1, 10.0, _lanes=G)
    assert counters().get("launches.k3", 0) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("max_phases", [8, 16, 64])
def test_iso_kernel_overflow31(cuda, max_phases, order):
    """The fail-code test's ten-peak sources: fail code 3 on every cell
    at 8 slots, every cell ok at 16 and 64 (the remedy the code names),
    kernel against plain at the rule's G and at every G."""
    mu1_v, dmu2_v = np.linspace(4.9, 5.1, 64), np.linspace(-4.9, -4.1, 32)
    iso, srcs, mk, lr, wts = _iso(cuda, "n31", order, 1.001, mu1_v, dmu2_v, lnpi=ten_peak())
    args = (srcs, [TS.HistMeta(**dict(mk, max_phases=max_phases))] * 2, mu1_v, dmu2_v, lr, wts, 1.001, order, 10.0)
    _iso_compare(args, min_ok=0.0 if max_phases == 8 else 1.0)
    code = IB.iso_grid(*args)[4]
    assert bool((code == (3 if max_phases == 8 else 0)).all())


@pytest.mark.gpu
def test_iso_staged_sources_host_count_equals_library(cuda):
    """cuda_iso.staged_sources (the host's count) equals what the built
    kernel library decides, for both builds, both G and grids around the
    48 KB edge."""
    n = 0
    for G in CS.LANES:
        for P in (8, 64):
            for order in (1, 2):
                for W, NX, NY in ((2, 834, 301), (5, 12, 40), (3, 95, 19), (40, 1, 300)):
                    for N in (31, 63, 127, 190, 200, 250, 299, 300, 400, 1400):
                        built = CI._lib().iso_grid_staged_sources(G, CS.capacity(P), W, NX, NY, N, CM.n_xrows(2, order), CM.n_groups(2, order, False))
                        assert CI.staged_sources(G, W, NX, NY, N, order, P) == built, (G, P, order, W, NX, NY, N)
                        n += 1
    assert n == 320


def _iso_kin(srcs, meta, mu1_v, dmu2_v, lr, wts, beta, order):
    pro = IB._iso_prologue(srcs, meta, mu1_v, dmu2_v, lr, wts, beta, order, 10.0)
    return [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("max_phases", [16, 64])
@pytest.mark.parametrize("surface", ["overflow31", "overflow1400"])
def test_iso_kernel_wide_xm(cuda, surface, max_phases, order, collect):
    """K3's wide build with each cell's x_m formed once in shared memory
    (at G = 1 and N = 31, at G = 32 at both N) against its plain version at
    the rule's G and at G = 1 and 32, and bit for bit against the same
    build with x_m formed on read at each G."""
    if surface == "overflow31":
        beta, mu1_v, dmu2_v = 1.001, np.linspace(4.9, 5.1, 64), np.linspace(-5.3, -3.7, 32)
        iso, srcs, mk, lr, wts = _iso(cuda, "n31", order, beta, mu1_v, dmu2_v, lnpi=ten_peak())
    else:
        beta, mu1_v, dmu2_v = ISO1400["beta"], np.linspace(*mu_window(**CELLS["n1400"]), 32), np.linspace(-5.3, -3.7, 16)
        iso, srcs, mk, lr, wts = _iso(cuda, "n1400", order, beta, mu1_v, dmu2_v, lnpi=ripple1400())
    meta = TS.HistMeta(**dict(mk, max_phases=max_phases))
    _iso_compare((srcs, [meta] * len(srcs), mu1_v, dmu2_v, lr, wts, beta, order, 10.0, collect), min_ok=0.0 if max_phases == 16 else 0.5)
    kin = _iso_kin(srcs, meta, mu1_v, dmu2_v, lr, wts, beta, order)
    N, W, NX, NY = srcs[0].nbins, len(srcs), len(mu1_v), len(dmu2_v)
    for G in CS.LANES:
        area = CI.xm_bytes(G, W, NX, NY, N, order, max_phases)
        assert (area > 0) == (G == 32 or N == 31)
        off = CI.iso_grid(*kin, mk["smooth"], max_phases, order, 10.0, collect, _lanes=G, _xm=False)
        for xm in (None, True) if area else (None,):
            got = CI.iso_grid(*kin, mk["smooth"], max_phases, order, 10.0, collect, _lanes=G, _xm=xm)
            torch.cuda.synchronize()
            for k in range(5):
                assert torch.equal(got[k], off[k]), (G, xm, k)


@pytest.mark.gpu
def test_iso_xm_bytes_host_count_equals_library(cuda):
    """cuda_iso.xm_bytes (the host's count of K3's x_m area) equals what
    the built kernel library decides, for both builds and both G, around
    the edges where the area stops fitting."""
    n = 0
    for G in CS.LANES:
        for P in (8, 64):
            for order in (1, 2):
                for W, NX, NY in ((2, 834, 301), (40, 1, 300), (2, 128, 128)):
                    for N in (31, 94, 95, 102, 103, 113, 114, 1400, 3567, 3568):
                        built = CI._lib().iso_grid_xm_bytes(G, CS.capacity(P), W, NX, NY, N, CM.n_xrows(2, order), CM.n_groups(2, order, False))
                        assert CI.xm_bytes(G, W, NX, NY, N, order, P) == built, (G, P, order, W, NX, NY, N)
                        n += 1
    assert n == 240


@pytest.mark.gpu
def test_iso_xm_area_past_the_card_raises(cuda):
    """An x_m area forced past what the card grants a block (G = 1 at N =
    1400: 2.8 MB) fails the launch, which raises and counts no launch; the
    refused opt-in leaves nothing behind (the next launch runs), and the
    first build has no area to force."""
    mu1_v, dmu2_v = np.linspace(*mu_window(**CELLS["n1400"]), 16), np.linspace(-4.9, -4.1, 8)
    iso, srcs, mk, lr, wts = _iso(cuda, "n1400", 1, ISO1400["beta"], mu1_v, dmu2_v, lnpi=ripple1400())
    kin = _iso_kin(srcs, TS.HistMeta(**dict(mk, max_phases=16)), mu1_v, dmu2_v, lr, wts, ISO1400["beta"], 1)
    n0 = counters().get("launches.k3", 0)
    with pytest.raises(RuntimeError, match="iso_grid kernel launch failed"):
        CI.iso_grid(*kin, mk["smooth"], 16, 1, 10.0, _lanes=1, _xm=True)
    with pytest.raises(ValueError, match="x_m area"):
        CI.iso_grid(*kin, mk["smooth"], 8, 1, 10.0, _xm=True)
    assert counters().get("launches.k3", 0) == n0
    got = CI.iso_grid(*kin, mk["smooth"], 16, 1, 10.0, _lanes=1)
    want = IB.iso_grid(srcs, [TS.HistMeta(**dict(mk, max_phases=16))] * len(srcs), mu1_v, dmu2_v, lr, wts, ISO1400["beta"], 1, 10.0, engine="torch")
    _iso_equal(got, want, min_ok=0.0)
    assert counters().get("launches.k3", 0) == n0 + 1


def _paired_inputs(cuda, name, order, props, M, A=64):
    """(h, meta, K2 inputs) of an M mu x A target product on a cell."""
    d, mk, mus = cell(name, M, max_order=3)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.4, 0.4, A)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
    return h, meta, TP._mb_inputs(h, meta, mus, np.linspace(0.92, 1.08, A), dmus, order, props, False)


def _k2(h, meta, inputs, order, props, collect, **kw):
    mu, a, xrows, krows, tg = inputs
    return CM.mb_sweep_thermo(h.lnpi, h.op, xrows, krows if props else None, h.volume, mu, a, tg, meta.nspec, meta.smooth, meta.max_phases, order, props, False, collect, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["n31", "n573"])
def test_mb_paired_equals_product(cuda, name, order, props, collect):
    """K2's paired mode against the product mode's points (m, tix[m]) bit
    for bit on every field, at G = 1 and 32: the diagonal of a 64 x 64
    product, and random targets of a 1024 x 64 one."""
    A = 64
    h, meta, inputs = _paired_inputs(cuda, name, order, props, 1024, A)
    mu, a, xrows, krows, tg = inputs
    rng = np.random.default_rng(order + 2 * props)
    for M, tix in ((A, np.arange(A)), (1024, rng.integers(0, A, size=1024))):
        t = torch.as_tensor(tix, dtype=torch.int32, device=cuda)
        sub = (mu[:M], a[:M], xrows, krows, tg)
        for G in CS.LANES:
            n0 = counters().get("launches.k2", 0)
            prod = _k2(h, meta, sub, order, props, collect, _lanes=G)
            got = _k2(h, meta, sub, order, props, collect, tix=t, _lanes=G)
            torch.cuda.synchronize()
            assert counters().get("launches.k2", 0) == n0 + 2
            rows = torch.arange(M, device=cuda) * A + t.long()
            for k in prod:
                assert torch.equal(got[k], prod[k][rows]), (M, G, k)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_mb_paired_matches_plain(cuda, name, order, props, collect):
    """K2's paired mode against its plain version at the rule's G and at
    every G: segmentation equal, floats within 1e-10."""
    h, meta, inputs = _paired_inputs(cuda, name, order, props, 2048)
    mu, a, xrows, krows, tg = inputs
    t = torch.as_tensor(np.random.default_rng(7).integers(0, tg.shape[0], size=mu.shape[0]), dtype=torch.int32, device=cuda)
    want = TP._mb_paired_body(h, meta, mu, a, xrows, krows, tg, t, order, props, collect)
    ok = (want["mask"] & want["valid"][:, None]).cpu()
    for G in LANES:
        got = _k2(h, meta, inputs, order, props, collect, tix=t, _lanes=G)
        torch.cuda.synchronize()
        assert set(got) == set(want)
        for k in SEG:
            assert torch.equal(got[k], want[k]), (G, k)
        for k in ("fe",) + (PROPS if props else ()):
            assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, (G, k)


@pytest.mark.gpu
def test_mb_paired_rejects_bad_tix(cuda):
    """tix out of range, of another dtype or shape, strided, or on the CPU
    raises before any launch; a tix written in place after a launch is read
    again; an entry written past that check (through .data, which the
    version counter does not see) comes back from the kernel as an invalid
    point."""
    h, meta, inputs = _paired_inputs(cuda, "n31", 1, True, 16, 8)
    good = torch.zeros(16, dtype=torch.int32, device=cuda)
    n0 = counters().get("launches.k2", 0)
    bad = [
        (ValueError, "outside", torch.full((16,), 8, dtype=torch.int32, device=cuda)),
        (ValueError, "outside", torch.full((16,), -1, dtype=torch.int32, device=cuda)),
        (TypeError, "int32", good.long()),
        (ValueError, "CUDA tensors", good.cpu()),
        (ValueError, "contiguous", torch.zeros(32, dtype=torch.int32, device=cuda)[::2]),
        (ValueError, "like mu", good[:8]),
    ]
    for exc, msg, tix in bad:
        with pytest.raises(exc, match=msg):
            _k2(h, meta, inputs, 1, False, None, tix=tix)
    assert counters().get("launches.k2", 0) == n0
    _k2(h, meta, inputs, 1, False, None, tix=good)
    good[3] = 8
    with pytest.raises(ValueError, match="outside"):
        _k2(h, meta, inputs, 1, False, None, tix=good)
    assert counters().get("launches.k2", 0) == n0 + 1
    good[3] = 0
    for G in CS.LANES:
        want = _k2(h, meta, inputs, 1, True, None, tix=good, _lanes=G)
        version = good._version
        good.data[3], good.data[5] = 8, -1
        assert good._version == version
        got = _k2(h, meta, inputs, 1, True, None, tix=good, _lanes=G)
        torch.cuda.synchronize()
        good.data[3] = good.data[5] = 0
        hit = torch.zeros(16, dtype=torch.bool, device=cuda)
        hit[[3, 5]] = True
        assert not got["valid"][hit].any() and not got["n_phases"][hit].any() and not got["mask"][hit].any()
        for k in ("fe",) + PROPS:
            assert got[k][hit].isnan().all(), (G, k)
        for k in got:
            assert torch.equal(got[k][~hit], want[k][~hit]), (G, k)


def _props_at(h, meta, res, betas, order, engine):
    """The per-phase properties at the trace's own mu_star, through one
    engine."""
    T = len(betas)
    obj = TSV._Objective(h, meta, torch.as_tensor(betas, device=h.device), (h.curr_mu[1:] - h.curr_mu[0])[None].expand(T, -1), order, 0, True, None, engine, props_rows=True)
    return obj.segment(res["mu_star"], torch.arange(T, dtype=torch.int32, device=h.device), props=True)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_trace_kernels_match_torch(cuda, order):
    """trace_coexistence through K2's paired mode against engine="torch" on
    the coex573 cell (32 of its betas)."""
    d, mk, betas, guess, kw = coex_grid(32)
    kw = dict(kw, order=order)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n0 = counters().get("launches.k2", 0)
    got = TSV.trace_coexistence(h, meta, betas, guess, **kw)
    torch.cuda.synchronize()
    assert counters().get("launches.k2", 0) - n0 >= 3  # the start, the steps, the properties
    want = TSV.trace_coexistence(h, meta, betas, guess, engine="torch", **kw)
    assert torch.equal(got["converged"], want["converged"]) and got["converged"].all()
    assert float((got["mu_star"] - want["mu_star"]).abs().max()) <= 1e-9
    assert float(got["err"].max()) <= kw["lnZ_tol"] ** 2
    at_k, at_p = _props_at(h, meta, got, betas, order, "cuda"), _props_at(h, meta, got, betas, order, "torch")
    ok = (at_p["mask"] & at_p["valid"][:, None]).cpu()
    assert torch.equal(at_k["mask"], got["mask"]) and torch.equal(at_p["mask"], got["mask"])
    for k in ("fe", "x_i", "ntot", "u", "density"):  # the trace's keys
        assert torch.equal(at_k[k], got[k]), k
        assert worst_abs_diff(got[k].cpu(), at_p[k].cpu(), ok) <= 1e-10, k


@pytest.mark.gpu
def test_find_phase_eq_state_k1_matches_torch(cuda):
    """find_phase_eq_state without extrapolation over a batch of mu
    guesses: K1's objective against the plain one."""
    d, mk, guesses, kw = coex31_guesses(64)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n0 = counters().get("launches.k1", 0)
    out, mus, err, conv = TSV.find_phase_eq_state(h, meta, kw["lnZ_tol"], guesses, min_width=kw["min_width"])
    torch.cuda.synchronize()
    assert counters().get("launches.k1", 0) - n0 >= 2 and out.lnpi.shape == (64, h.nbins) and out.lnpi.is_cuda
    _, mus_t, err_t, conv_t = TSV.find_phase_eq_state(h, meta, kw["lnZ_tol"], guesses, min_width=kw["min_width"], engine="torch")
    assert torch.equal(conv, conv_t) and conv.all()
    assert float((mus - mus_t).abs().max()) <= 1e-9 and float(err.max()) <= kw["lnZ_tol"] ** 2


# ---------------------------------------------------------------------------
# K2's x' area: where cuda_mb.xarea_fits holds (G = 1, small N), each point's
# x' is formed once a bin into shared memory; elsewhere it is re-formed at
# every read.  The two routes return the same bits; both hold against the
# plain version at the kernels' bar.
# ---------------------------------------------------------------------------


def _xarea_inputs(cuda, N, nspec, max_phases, M=256, A=8):
    """(h, meta, mus, betas, dmus) of a two-phase composite of N bins and
    nspec species, max_order 3, smooth 1, with M mu over its window and A
    (beta, dMu) targets."""
    c = dict(CELLS["n31"], N=N, nspec=nspec, mu0=(5.0, 0.0)[:nspec])
    d = make_composite(**dict(c, max_order=3))
    mus = np.linspace(*mu_window(**c), M)
    meta = TS.HistMeta(nspec=nspec, max_order=3, used_ke=False, smooth=1, max_phases=max_phases)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, A)[:, None] if nspec == 2 else np.zeros((1, 0))
    return TS.from_host(d, device=cuda), meta, mus, np.linspace(0.92, 1.08, A), dmus


def _k2_launch(h, meta, inputs, order, props, fom, collect, **kw):
    mu, a, xrows, krows, tg = inputs
    return CM.mb_sweep_thermo(h.lnpi, h.op, xrows, krows if props else None, h.volume, mu, a, tg, meta.nspec, meta.smooth, meta.max_phases, order, props, fom, collect, **kw)


@pytest.mark.gpu
def test_mb_xarea_rule_host_equals_library(cuda):
    """cuda_mb.xarea_fits (the host's rule) equals the library's for every
    G, build and N up to 2,048, and where it holds the area's build keeps
    at least two blocks an SM with the most rows a block stages; the
    re-form route at G = 1 keeps its three."""
    lib = CM._lib()
    for G in CS.LANES:
        for cap in CS.CAPACITIES:
            for N in list(range(1, 2049)) + [4096]:
                assert bool(lib.mb_sweep_thermo_xarea_fits(G, cap, N)) == CM.xarea_fits(G, cap, N), (G, cap, N)
    for cap in CS.CAPACITIES:
        top = CM.xarea_limit(1, cap)
        assert top >= 31
        for paired in (0, 1):
            for N in (31, top):
                assert lib.mb_sweep_thermo_blocks_per_sm(0, 1, cap, -1, paired, N, 2, 2, 1, 0) >= CM.XAREA_MIN_BLOCKS, (cap, paired, N)
            assert lib.mb_sweep_thermo_blocks_per_sm(0, 1, cap, 0, paired, 31, 2, 2, 1, 0) >= 3, (cap, paired)


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("order,fom", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("nspec", [1, 2])
@pytest.mark.parametrize("at", ["31", "top"])
@pytest.mark.parametrize("max_phases", [4, 16])
def test_mb_xarea_bits_equal_reform(cuda, max_phases, at, nspec, order, fom, props, collect):
    """At G = 1 the area route and the re-form route return every output
    field bit for bit, in the product and the paired mode, in the build of
    8 slots and of 64, at N = 31 and at the largest N the rule admits
    (where the rule picks the area, and one bin more it does not); both
    agree with the plain version."""
    cap = CS.capacity(max_phases)
    N = 31 if at == "31" else CM.xarea_limit(1, cap)
    h, meta, mus, betas, dmus = _xarea_inputs(cuda, N, nspec, max_phases)
    inputs = TP._mb_inputs(h, meta, mus, betas, dmus, order, props, fom, kernel=True)
    M, A = len(mus), len(betas)
    tix = torch.as_tensor(np.random.default_rng(N + nspec).integers(0, A, size=M), dtype=torch.int32, device=cuda)
    want = TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=props, first_order_mom=fom, collect=collect, engine="torch")
    want_p = TP._mb_paired_body(h, meta, *inputs, tix, order, props, collect)
    for mode, t, ref in (("product", None, {k: v.reshape(M * A, *v.shape[2:]) for k, v in want.items()}), ("paired", tix, want_p)):
        n0, x0 = counters().get("launches.k2", 0), counters().get("launches.k2_xarea", 0)
        area = _k2_launch(h, meta, inputs, order, props, fom, collect, tix=t, _lanes=1)
        reform = _k2_launch(h, meta, inputs, order, props, fom, collect, tix=t, _lanes=1, _xarea=False)
        forced = _k2_launch(h, meta, inputs, order, props, fom, collect, tix=t, _lanes=1, _xarea=True)
        torch.cuda.synchronize()
        assert counters().get("launches.k2", 0) == n0 + 3 and counters().get("launches.k2_xarea", 0) == x0 + 2, mode
        assert set(area) == set(ref)
        for k in area:
            assert _bits_equal(area[k], reform[k]) and _bits_equal(forced[k], area[k]), (mode, k)
        ok = (ref["mask"] & ref["valid"][:, None]).cpu()
        for k in SEG:
            assert torch.equal(area[k], ref[k]), (mode, k)
        for k in ("fe",) + (PROPS if props else ()):
            assert worst_abs_diff(area[k].cpu(), ref[k].cpu(), ok) <= 1e-10, (mode, k)
    if at == "top":
        # one bin more: the rule re-forms on read
        h, meta, mus, betas, dmus = _xarea_inputs(cuda, N + 1, nspec, max_phases)
        inputs = TP._mb_inputs(h, meta, mus, betas, dmus, order, props, fom, kernel=True)
        x0 = counters().get("launches.k2_xarea", 0)
        reform = _k2_launch(h, meta, inputs, order, props, fom, collect, _lanes=1)
        area = _k2_launch(h, meta, inputs, order, props, fom, collect, _lanes=1, _xarea=True)
        torch.cuda.synchronize()
        assert counters().get("launches.k2_xarea", 0) == x0 + 1
        for k in area:
            assert _bits_equal(area[k], reform[k]), k


@pytest.mark.gpu
def test_mb_xarea_refused_where_it_cannot_run(cuda):
    """The area is the layout of one lane a point: forced at G = 32 it
    raises before any launch; forced past what a block may opt in to
    (N = 1400 at G = 1) the launch fails and raises."""
    h, meta, mus, betas, dmus = _mb_inputs(cuda, "n1400", M=64, A=2)
    inputs = TP._mb_inputs(h, meta, mus, betas, dmus, 1, True, False, kernel=True)
    n0 = counters().get("launches.k2", 0)
    with pytest.raises(ValueError, match="one lane a point"):
        _k2_launch(h, meta, inputs, 1, True, False, None, _lanes=32, _xarea=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        _k2_launch(h, meta, inputs, 1, True, False, None, _lanes=1, _xarea=True)
    with pytest.raises(ValueError, match="_xarea must be"):
        _k2_launch(h, meta, inputs, 1, True, False, None, _xarea="on")
    assert counters().get("launches.k2", 0) == n0


@pytest.mark.gpu
def test_mb_xarea_counter_by_route(cuda):
    """launches.k2_xarea advances once for each sweep at N = 31 (G = 1 by the
    rule), and not for a sweep at N = 573 at G = 1 nor for the solver's
    paired steps (G = 32)."""
    d, mk, mus, betas, dmus = mb_grid(M=512, A=16)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    for _ in range(2):
        n0, x0 = counters().get("launches.k2", 0), counters().get("launches.k2_xarea", 0)
        TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2)
        assert counters().get("launches.k2", 0) - n0 == counters().get("launches.k2_xarea", 0) - x0 == 1
    h, meta, mus, betas, dmus = _mb_inputs(cuda, "n573", M=1024, A=64)
    assert CS.lanes_per_point(h.nbins, 1024 * 64, CS.sm_count(0)) == 1
    n0, x0 = counters().get("launches.k2", 0), counters().get("launches.k2_xarea", 0)
    TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2)
    assert counters().get("launches.k2", 0) - n0 == 1 and counters().get("launches.k2_xarea", 0) == x0
    d, mk, betas, guess, kw = coex_grid(16)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n0 = counters().get("launches.k2", 0)
    TSV.trace_coexistence(h, meta, betas, guess, **kw)
    torch.cuda.synchronize()
    assert counters().get("launches.k2", 0) - n0 >= 3 and counters().get("launches.k2_xarea", 0) == x0


# ---------------------------------------------------------------------------
# The 2-D surface path (core.segment2d under two_dim): plain PyTorch on the
# card, no kernel of its own.  The device watershed against the host flood,
# the class on the card against its numpy engine, the tie fallback, and the
# watershed and boundary integrals on the card against the same functions
# on the CPU (which tests/test_torch_segment2d.py holds against JAX):
# integers equal, floats within 1e-10 (the card's exp and log).
# ---------------------------------------------------------------------------


def _same_2d(a, b, where, atol=1e-10):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, where
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=where)
    np.testing.assert_array_equal(np.where(np.isinf(a), a, 0), np.where(np.isinf(b), b, 0), err_msg=where)
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol, err_msg=where)


def _same_sweep_2d(a, b, where):
    assert set(a) == set(b) and a["prop_names"] == b["prop_names"]
    for x, y in zip(a["local_maxima"], b["local_maxima"]):
        np.testing.assert_array_equal(x, y, err_msg=where)
    for k in a:
        if k not in ("prop_names", "local_maxima", "elev_tie"):
            _same_2d(a[k], b[k], f"{where}: {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("return_surfaces", [True, False])
@pytest.mark.parametrize("surface", ["pore13", "joint24x97"])
def test_2d_device_engine_matches_host_flood(cuda, surface, return_surfaces):
    from fhmcanalysis_torch import two_dim
    from torch_composites import FH_COEFFS, JOINT_BETA, JOINT_MU_REF, joint, joint_prod_entries, joint_states, pore13_entries, pore_states

    if surface == "pore13":
        jh, fh = joint(pore13_entries()), two_dim.free_energy_profile.polynomial(FH_COEFFS)
        ps, bs = pore_states(16)

        def sweep(**kw):
            return two_dim.pore_state_sweep(jh, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, device=cuda, **kw)
    else:
        jh = joint(joint_prod_entries(24, 97))

        def sweep(**kw):
            return two_dim.joint_state_sweep(jh, JOINT_BETA, JOINT_MU_REF, joint_states(16), nnebr=1, max_peaks=4, device=cuda, **kw)

    dev = sweep(return_surfaces=return_surfaces)  # "auto" is the device engine on the card
    host = sweep(segment_engine="host")
    assert torch.is_tensor(dev["labels"]) == (not return_surfaces)
    assert not torch.is_tensor(dev["labels"]) or dev["labels"].is_cuda
    assert not dev["elev_tie"].any() and (dev["fail_code"] == 0).all()
    _same_sweep_2d(host, dev, surface)


@pytest.mark.gpu
def test_2d_class_on_card_matches_numpy_engine(cuda):
    from fhmcanalysis_torch import two_dim
    from torch_composites import FH_COEFFS, joint, pore13_entries

    fh = two_dim.free_energy_profile.polynomial(FH_COEFFS)
    for p, beta in ((0.0, 1.0), (0.08, 0.95)):
        card = two_dim.pore_hist(joint(pore13_entries()), fh, p, 1.0, beta, device=cuda)
        host = two_dim.pore_hist(joint(pore13_entries()), fh, p, 1.0, beta, engine="numpy")
        _same_2d(host.data["ln(PI)"], card.data["ln(PI)"], "ln(PI)")
        a, b = host.phase_average(nnebr=1, max_peaks=4), card.phase_average(nnebr=1, max_peaks=4)
        assert sorted(k for k in a if isinstance(k, int)) == sorted(k for k in b if isinstance(k, int)) == [0, 1]
        for k in (0, 1):
            for prop in ("N_tot", "U", "F.E./kT"):
                assert abs(a[k][prop] - b[k][prop]) <= 1e-10, (k, prop)
        for m in ("activation_kT", "activation_kT_diff"):
            _same_2d(a[m], b[m], m)
        _same_2d(host.data["seg"]["transition_state_kT"], card.data["seg"]["transition_state_kT"], "ts")
        mask = card.data["seg"]["phase_labels"] == 1
        for prop in ("N_tot", "U"):
            assert abs(card.thermo(mask)[prop] - host.thermo(mask)[prop]) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("return_surfaces", [True, False])
def test_2d_tie_fallback_on_card(cuda, return_surfaces):
    from fhmcanalysis_torch import two_dim
    from torch_composites import FH_COEFFS, joint, pore13_entries, pore_states, tie_joint

    jt, fh = tie_joint(joint(pore13_entries())), two_dim.free_energy_profile.polynomial(FH_COEFFS)
    ps, bs = pore_states(6)
    kw = dict(nnebr=1, max_peaks=4, device=cuda, return_surfaces=return_surfaces)
    flagged = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, **kw)
    assert flagged["elev_tie"].all() and (flagged["fail_code"] == 4).all()
    fb = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, tie_fallback=True, **kw)
    host = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, segment_engine="host", **kw)
    assert fb["elev_tie"].all() and (fb["fail_code"] == 0).all()
    assert torch.is_tensor(fb["labels"]) == (not return_surfaces)
    _same_sweep_2d(host, fb, "tie fallback")


@pytest.mark.gpu
@pytest.mark.parametrize("H,N", [(13, 21), (5, 29), (3, 149), (96, 385)], ids=["fp3x5", "fp3x15", "fp3x149", "fp3x9-96x385"])
def test_2d_watershed_on_card_matches_cpu(cuda, H, N):
    """Pointer jumping on the card at every footprint, > 40 cells included:
    labels, peaks and flags equal to the CPU's."""
    import fhmcanalysis_torch.core.segment2d as S2
    from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint
    from torch_composites import rand_surface

    rng = np.random.RandomState(H * N)
    lnpi = np.stack([rand_surface(rng, H, N, rng.randint(1, 6)) for _ in range(8)])
    valid = np.arange(N)[None, :] <= np.clip(rng.randint(N // 2, N, size=H), 1, N - 1)[:, None]
    fp = _footprint(H, N, 1).shape
    cpu = S2.hillclimb_segment_batch(torch.as_tensor(lnpi), torch.as_tensor(valid), fp, 6)
    card = S2.hillclimb_segment_batch(torch.as_tensor(lnpi, device=cuda), torch.as_tensor(valid, device=cuda), fp, 6)
    for k in cpu:
        assert card[k].is_cuda and torch.equal(cpu[k], card[k].cpu()), k


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_2d_boundary_engines_on_card(cuda, engine):
    import fhmcanalysis_torch.core.segment2d as S2
    from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint
    from torch_composites import rand_surface

    rng = np.random.RandomState(9)
    H, N = 24, 97
    lnpi = np.stack([rand_surface(rng, H, N, 4) for _ in range(6)])
    lab = S2.hillclimb_segment_batch(torch.as_tensor(lnpi), torch.ones(H, N, dtype=torch.bool), _footprint(H, N, 1).shape, 6)["labels"]
    cpu = S2.boundary_pair_integrals(torch.as_tensor(lnpi), lab, 6, engine=engine)
    card = S2.boundary_pair_integrals(torch.as_tensor(lnpi, device=cuda), lab.to(cuda), 6, engine=engine)
    for a, b, k in zip(cpu, card, ("min_df", "max_val")):
        assert b.is_cuda
        _same_2d(a, b, f"{engine} {k}")
    assert (cpu[0] > S2._BIGNEG).any()


# ---------------------------------------------------------------------------
# parallel/ on the card: four shards of card 0 (grid_mesh(4, devices=
# ["cuda:0"] * 4)) and every card of the machine (grid_mesh()), each
# sharded route against its one-device call on the same card.  Each shard
# launches its kernel once; segmentation (and fail codes, labels, peaks,
# flags) equal; floats bit for bit where every shard ran the one-device
# call's G, else within 1e-10; the thread's current device unchanged.
# ---------------------------------------------------------------------------


def _meshes(cuda):
    from fhmcanalysis_torch.parallel import grid_mesh

    return {"4 shards of card 0": grid_mesh(4, devices=[cuda] * 4), "every card": grid_mesh()}


def _close(got, want, same_g, where, atol=1e-10):
    """Dicts of tensors: integers equal; floats equal when same_g, else
    within atol with NaN and +-inf in the same places."""
    assert set(got) == set(want), where
    for k in want:
        if same_g or not want[k].is_floating_point():
            assert torch.equal(got[k].to(want[k].device), want[k]), (where, k)
        else:
            _same_2d(got[k], want[k], f"{where}: {k}", atol)


def _counted(kernel, fn):
    """(fn(), launches of kernel ("k1", "k2", "k3") it made, the current device unchanged)"""
    before, n0 = torch.cuda.current_device(), counters().get(f"launches.{kernel}", 0)
    out = fn()
    torch.cuda.synchronize()
    assert torch.cuda.current_device() == before, "a sharded call left another card current"
    return out, counters().get(f"launches.{kernel}", 0) - n0


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_name", ["4 shards of card 0", "every card"])
def test_parallel_mu_sweeps_on_card(cuda, mesh_name):
    from fhmcanalysis_torch import parallel

    mesh = _meshes(cuda)[mesh_name]
    d, mk, mus = cell("n31", 2048, max_order=3)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    n_sm = CS.sm_count(cuda.index)
    same_g = CS.lanes_per_point(h.nbins, 2048 // mesh.size, n_sm) == CS.lanes_per_point(h.nbins, 2048, n_sm)
    (got, fe_min), n = _counted("k1", lambda: parallel.shard_map_mu_sweep(mesh, h, meta, mus))
    want = TP.mu_sweep_thermo(h, meta, mus)
    assert n == mesh.size
    _close(got, want, same_g, "K1 sharded")
    assert float(fe_min) == float(torch.where(want["mask"], want["fe"], torch.inf).min()) or not same_g
    betas = np.linspace(0.92, 1.08, 8)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, 8)[:, None]
    same_g = CS.lanes_per_point(h.nbins, 2048 // mesh.size * 8, n_sm) == CS.lanes_per_point(h.nbins, 2048 * 8, n_sm)
    for order in (1, 2):
        (got, _), n = _counted("k2", lambda: parallel.sharded_mu_beta_sweep(mesh, h, meta, mus, betas, dmus, order=order))
        assert n == mesh.size
        _close(got, TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order), same_g, f"K2 sharded order {order}")


@pytest.mark.gpu
def test_parallel_trace_on_card(cuda):
    from fhmcanalysis_torch import parallel

    d, mk, _ = cell("n31", 1, max_order=3)
    d, mk = dict(d, lnpi=np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0], dtype=float)), dict(mk, max_phases=8)
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    betas = np.linspace(0.99, 1.01, 8)
    want = TSV.trace_coexistence(h, meta, betas, 5.0, lnZ_tol=1e-6, min_width=2)
    for mesh in _meshes(cuda).values():
        got, n = _counted("k2", lambda: parallel.sharded_trace_coexistence(mesh, h, meta, betas, 5.0, lnZ_tol=1e-6, min_width=2))
        assert n >= 3 * mesh.size  # each shard: the start, its steps, the properties
        _close(got, want, True, "trace")  # a step's points stay at G = 32 in every shard


@pytest.mark.gpu
def test_parallel_make_grid_on_card(cuda):
    from fhmcanalysis_torch import parallel

    ds, mk = iso_sources("n31")
    grid = iso_grid_args(ISO31, NX=64, NY=32)
    one = isopleth([port_histogram(d, mk, device=cuda) for d in ds], ISO31["beta"], order=1)
    one.make_grid(*grid)
    for name, mesh in _meshes(cuda).items():
        iso = isopleth([port_histogram(d, mk, device=cuda) for d in ds], ISO31["beta"], order=1)
        _, n = _counted("k3", lambda: parallel.sharded_make_grid(mesh, iso, *grid))
        assert n == min(mesh.size, 64)
        for k in ("Z", "density", "F.E./kT", "valid", "fail_code"):
            assert np.array_equal(iso.data[k], one.data[k]) or (k in ("Z", "density", "F.E./kT") and np.abs(iso.data[k] - one.data[k]).max() <= 1e-10), (name, k)


@pytest.mark.gpu
def test_parallel_2d_sweeps_on_card(cuda):
    from fhmcanalysis_torch import parallel, two_dim
    from torch_composites import FH_COEFFS, JOINT_BETA, JOINT_MU_REF, joint, joint_prod_entries, joint_states, pore13_entries, pore_states

    jh, fh = joint(pore13_entries()), two_dim.free_energy_profile.polynomial(FH_COEFFS)
    ps, bs = pore_states(18)
    jj = joint(joint_prod_entries(24, 97))
    for name, mesh in _meshes(cuda).items():
        got = parallel.sharded_pore_state_sweep(mesh, jh, fh, ps, bs, 1.0, nnebr=1, max_peaks=4)
        _same_sweep_2d(two_dim.pore_state_sweep(jh, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, device=cuda), got, f"pore {name}")
        got = parallel.sharded_joint_state_sweep(mesh, jj, JOINT_BETA, JOINT_MU_REF, joint_states(18), nnebr=1, max_peaks=4)
        _same_sweep_2d(two_dim.joint_state_sweep(jj, JOINT_BETA, JOINT_MU_REF, joint_states(18), nnebr=1, max_peaks=4, device=cuda), got, f"joint {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("smooth", [2, 60])
def test_parallel_surfaces_on_card(cuda, smooth):
    import fhmcanalysis_torch.core.numerics as TN
    import fhmcanalysis_torch.core.segment as TSg
    import fhmcanalysis_torch.core.segment2d as S2
    from fhmcanalysis_torch import parallel

    d, _, _ = cell("n1400", 1)
    x = torch.as_tensor(d["lnpi"], device=cuda)
    fm, fn = TSg.stencil_flags(x[None], smooth)
    ext = TSg.relextrema(x[None], smooth, 8)
    rng = np.random.default_rng(smooth)
    x2 = torch.as_tensor(rng.normal(size=(96, 120)) * 3.0, device=cuda)
    m2 = torch.as_tensor(np.arange(120)[None, :] <= rng.integers(60, 120, size=96)[:, None], device=cuda)
    for mesh in _meshes(cuda).values():
        gm, gn = parallel.sharded_stencil_flags(mesh, x, smooth)
        assert torch.equal(torch.cat(gm), fm[0]) and torch.equal(torch.cat(gn), fn[0])
        got = parallel.sharded_relextrema(mesh, x, smooth, 8)
        for f in ("maxima", "n_max", "minima", "n_min", "valid"):
            assert torch.equal(getattr(got, f), getattr(ext, f)[0]), f
        assert (torch.cat(parallel.sharded_normalize_long(mesh, x)) - TN.normalize_lnpi(x)).abs().max() <= 1e-12
        got2 = torch.cat(parallel.sharded_normalize_2d(mesh, x2, m2))
        assert (got2 - S2.normalize_2d(x2, m2))[m2].abs().max() <= 1e-12


# ---------------------------------------------------------------------------
# Batched coexistence states and the example workflows on the card.  The T
# states of find_phase_eq_state(extrapolate=True) are built in one pass
# (ops.reweight over the batch, the paired temp_dmu_extrap); thermo of a
# batch segments each state with its own moments.  Each is held against
# its per-target call on the card: segmentation equal, lnPI within 1e-12,
# moments and floats within 1e-12 relative to max(1, |value|) (the batch
# sums each state's bins in one reduction over rows, a single state in a
# reduction of its own).  Each example's run on the card equals its run on
# the CPU: segmentation, validity and fail codes equal, floats within
# 1e-10 relative (the card's exp and log; K2 and K3 on the card against
# their plain versions on the CPU), mu* within 1e-9.
# ---------------------------------------------------------------------------

EXAMPLE_NAMES = ("square_well_phase_diagram", "binary_isopleth", "combining_simulations", "multivariable_extrapolation", "mutual_diffusion", "square_well_notebook")


def _rel_close(a, b, tol, where):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, where
    if a.dtype.kind in "biuO":
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=where)
    d = np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(b[fin]))
    assert np.max(d, initial=0.0) <= tol, (where, float(np.max(d, initial=0.0)))


@pytest.mark.gpu
@pytest.mark.parametrize("cellname", ["coex573", "coex31"])
def test_batched_states_and_thermo_on_card(cuda, cellname):
    """find_phase_eq_state(extrapolate=True) over 32 betas: each state
    equals reweight -> temp_dmu_extrap of its own target on the card, and
    thermo / thermo_props of the batch equal the per-state calls."""
    from fhmcanalysis_torch.core import extrap, ops, segment

    if cellname == "coex573":
        d, mk, betas, guess, kw = coex_grid(32)
        dmu = None
    else:
        d, mk, _, kw = coex31_guesses(32)
        betas, guess, kw = np.linspace(0.99, 1.01, 32), 5.5, dict(kw, order=1)
        dmu = [-5.0]
    h, meta = TS.from_host(d, device=cuda), TS.HistMeta(**mk)
    out, mus, _, conv = TSV.find_phase_eq_state(h, meta, kw["lnZ_tol"], guess, beta=betas, dmu=dmu, order=kw["order"], min_width=kw["min_width"], extrapolate=True)
    torch.cuda.synchronize()
    assert out.lnpi.is_cuda and out.lnpi.shape == (32, h.nbins) and out.mom.shape == (32,) + h.mom.shape
    dmus = (h.curr_mu[1:] - h.curr_mu[0]) if dmu is None else torch.as_tensor(dmu, dtype=torch.float64, device=cuda)
    _, pt = segment.thermo(out, meta)
    _, kp, kprops = segment.thermo_props(out, meta)
    for t in range(0, 32, 5):
        one = extrap.temp_dmu_extrap(ops.reweight(h, mus[t]), meta, float(betas[t]), dmus, order=kw["order"])
        _rel_close(out.lnpi[t], one.lnpi, 1e-12, f"lnpi {t}")
        _rel_close(out.mom[t], one.mom, 1e-12, f"mom {t}")
        _, p1 = segment.thermo(one, meta)
        _, k1, props1 = segment.thermo_props(one, meta)
        for k in SEG[1:] + ("fe",):
            _rel_close(getattr(pt, k)[t], getattr(p1, k), 1e-12, f"thermo {k} {t}")
            _rel_close(getattr(kp, k)[t], getattr(k1, k), 1e-12, f"thermo_props {k} {t}")
        _rel_close(pt.mom_avg[t], p1.mom_avg, 1e-12, f"mom_avg {t}")
        for k in PROPS:
            _rel_close(kprops[k][t], props1[k], 1e-12, f"{k} {t}")
    # the batch's thermo on the card against the same batch's on the CPU
    cpu = TS.Hist(**{f: getattr(out, f).cpu() for f in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume")})
    _, pc = segment.thermo(cpu, meta)
    for k in SEG[1:] + ("fe",):
        _rel_close(getattr(pt, k), getattr(pc, k), 1e-10, f"card vs cpu {k}")


def _example(name):
    import importlib

    examples = str(__import__("pathlib").Path(__file__).resolve().parents[1] / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module("torch_" + name)


def _same_result(a, b, tol, where):
    """Two runs' result values (dicts, lists, tuples, arrays, scalars)."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _same_result(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(b, (list, tuple)) and not all(isinstance(v, (int, float, np.number)) for v in b):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_result(x, y, tol, f"{where}[{i}]")
    elif b is None:
        assert a is None, where
    else:
        _rel_close(a, b, tol, where)


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_example_workflow_on_card(cuda, name, tmp_path):
    """Each example workflow's run on the card with in-memory inputs (the
    card's machine has no h5py) against its run on the CPU; the kernels
    of its path launched (K2 paired for the phase diagram's solve, K3 for
    the isopleth surfaces)."""
    import torch_windows as TW

    mod = _example(name)
    inputs = TW.example_inputs(name, str(tmp_path))
    kernels = ("launches.k1", "launches.k2", "launches.k3")
    n0 = [counters().get(k, 0) for k in kernels]
    got = mod.run(inputs, cuda)
    torch.cuda.synchronize()
    launched = [counters().get(k, 0) - n for k, n in zip(kernels, n0)]
    want = mod.run(inputs, "cpu")
    if name == "square_well_phase_diagram":
        assert launched[1] >= 2, launched
        assert np.abs(got["mu_star"] - want["mu_star"]).max() <= 1e-9
        got, want = dict(got, mu_star=want["mu_star"]), dict(want)
    if name in ("binary_isopleth", "combining_simulations", "mutual_diffusion"):
        assert launched[2] == 1, launched
    if name == "square_well_notebook":
        assert abs(got["mu_kt"] - want["mu_kt"]) <= 1e-9
        got = dict(got, mu_kt=want["mu_kt"])
    _same_result(got, want, 1e-10 if name != "square_well_phase_diagram" else 1e-9, name)
    if name not in ("multivariable_extrapolation", "square_well_notebook"):  # their checks do not hold on in-repo data
        mod.check(got)
