"""PyTorch port: core/segment2d.py (the 2-D surface engine) against the JAX
package's, function by function, on the same numpy inputs.

Segmentation outputs (labels, n_labels, peak_rc, peak_sat, elev_tie,
phase_ok, peak_flat) are equal bit for bit; every float agrees within
1e-12 absolute, with NaN and +-inf (the _BIGNEG sentinel included) in the
same places.  The port resolves the watershed's steepest-ascent chains by
pointer jumping at every footprint; the JAX package does so only above 40
footprint cells and follows the chains with a while_loop below, so the
labels are held against both of its branches (13 x 21: a 3 x 5 footprint;
5 x 29: 3 x 15, 45 cells; 3 x 149: 3 x 149, 447 cells, past 441 the
sorted tie scan).  Inputs: test_device_watershed.py's random tilted
surfaces (tests/torch_composites.py rand_surface), ragged valid masks,
random label fields, and the watershed labels of the bench surfaces.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.segment2d as T
import fhmcanalysis_tpu.core.segment2d as J
from fhmcanalysis_tpu.two_dim.imaging import peak_local_max, watershed
from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint
from torch_composites import joint, pore13_entries, rand_surface, two_basin_entries

import jax
import jax.numpy as jnp

torch.set_num_threads(1)
ATOL = 1e-12

# the JAX functions run jitted (one compile per shape and static argument;
# eager dispatch of their unrolled loops costs minutes on the CPU)
J_hill = jax.jit(J.hillclimb_segment, static_argnums=(2, 3))
J_boundary = jax.jit(J.boundary_pair_integrals, static_argnames=("max_labels", "engine"))
J_phase = jax.jit(J.pore_phase_batch, static_argnames=("max_phases", "boundary_engine"))
J_pore_fused = jax.jit(J.pore_sweep_fused, static_argnames=("fp_shape", "max_phases", "boundary_engine"))
J_joint_fused = jax.jit(J.joint_sweep_fused, static_argnames=("fp_shape", "max_phases", "boundary_engine"))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b, where, atol=ATOL):
    """Equal integer/bool arrays; floats within atol, NaN and +-inf alike."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=where)
    np.testing.assert_array_equal(np.where(np.isinf(a), a, 0), np.where(np.isinf(b), b, 0), err_msg=where)
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol, err_msg=where)


def _same_dict(j, t, where, atol=ATOL):
    assert set(j) == set(t), (where, set(j) ^ set(t))
    for k in j:
        _same(j[k], t[k], f"{where}: {k}", atol)


def _ragged(rng, H, N):
    edge = np.clip(rng.randint(N // 2, N, size=H), 1, N - 1)
    return edge, np.arange(N)[None, :] <= edge[:, None]


def _watershed_case(seed, H, N, P=6, nnebr=1):
    """A random tilted surface on a ragged mask, its footprint, and the
    host flood's labels and peaks (the pipelines' host arm)."""
    rng = np.random.RandomState(seed)
    lnpi = rand_surface(rng, H, N, rng.randint(1, 6))
    edge, valid = _ragged(rng, H, N)
    lnpi = np.where(valid, lnpi, -np.inf)
    fp = _footprint(H, N, nnebr)
    x = np.where(valid, lnpi - lnpi[valid].min(), 0.0)
    lm = peak_local_max(x, min_distance=nnebr, exclude_border=0, num_peaks=P, footprint=fp)
    markers = np.zeros((H, N), int)
    for i, (r, c) in enumerate(lm):
        markers[r, c] = i + 1
    labels = watershed(-x, markers=markers, mask=valid, connectivity=fp)
    return lnpi, valid, edge, fp, labels, lm


# ---------------------------------------------------------------- surfaces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surface_builders(seed):
    rng = np.random.RandomState(seed)
    H, N = 9, 17
    raw = rng.randn(H, N) * 3.0
    edge, valid = _ragged(rng, H, N)
    raw[~valid] = -np.inf
    _same(J.valid_mask_2d(edge, N), T.valid_mask_2d(edge, N), "valid_mask_2d")
    h = np.arange(1.0, H + 1)
    fh = 0.3 * h**2
    for p, beta in ((0.05, 1.1), (0.0, 0.9)):
        jb, tb = J.build_pore_lnpi(raw, h, fh, p, 1.3, beta), T.build_pore_lnpi(torch.as_tensor(raw), h, fh, p, 1.3, beta)
        _same(jb, tb, "build_pore_lnpi")
        _same(J.normalize_2d(jb, valid), T.normalize_2d(tb, torch.as_tensor(valid)), "normalize_2d")
        _same(J.ln_f_2d(jb), T.ln_f_2d(tb), "ln_f_2d")
    ps, bs = rng.rand(5), 0.8 + 0.4 * rng.rand(5)
    for a, b in zip(J.pore_surface_batch(raw, h, fh, ps, 1.3, bs, jnp.asarray(valid)), T.pore_surface_batch(raw, h, fh, torch.as_tensor(ps), 1.3, torch.as_tensor(bs), valid)):
        _same(a, b, "pore_surface_batch")
    op1, op2 = np.arange(H, dtype=float), np.arange(N, dtype=float)
    d1, d2 = rng.randn(5), rng.randn(5)
    for a, b in zip(J.joint_surface_batch(raw, op1, op2, 1.1, d1, d2, jnp.asarray(valid)), T.joint_surface_batch(raw, op1, op2, 1.1, d1, d2, valid)):
        _same(a, b, "joint_surface_batch")


def test_region_thermo(rng):
    H, N = 11, 19
    lnpi = rng.normal(0, 5, size=(H, N))
    props = np.stack([rng.normal(size=(H, N)), np.arange(H * N, dtype=float).reshape(H, N)])
    for _ in range(4):
        region = rng.random((H, N)) < 0.4
        ja, jl = J.region_thermo_2d(lnpi, region, props)
        ta, tl = T.region_thermo_2d(torch.as_tensor(lnpi), torch.as_tensor(region), torch.as_tensor(props))
        _same(ja, ta, "ave")
        _same(jl, tl, "lp")


# ---------------------------------------------------- boundary integrals


@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_boundary_pair_integrals_random_labels(rng, engine):
    """Random label fields: every cell a boundary candidate, background
    cells among them."""
    for i in range(6):
        H, N, P = (9, 14, 3) if i % 2 else (13, 21, 5)
        labels = rng.integers(0, P + 1, size=(H, N)).astype(np.int32)
        sd = rng.normal(0, 10, size=(H, N))
        j = J_boundary(sd, labels, max_labels=P, engine=engine)
        t = T.boundary_pair_integrals(torch.as_tensor(sd), torch.as_tensor(labels), P, engine=engine)
        for a, b, k in zip(j, t, ("min_df", "max_val")):
            _same(a, b, f"{engine} {k}")
            assert (_np(b) == T._BIGNEG).any()  # the diagonal at least


@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_boundary_pair_integrals_watershed_labels(engine):
    """Real watershed label maps of ragged surfaces, batched [S, H, N]
    against JAX state by state."""
    cases = [_watershed_case(s, 14, 31) for s in (3, 4, 5)]
    lnpi = np.stack([c[0] for c in cases])
    labels = np.stack([c[4] for c in cases]).astype(np.int32)
    tb = T.boundary_pair_integrals(torch.as_tensor(lnpi), torch.as_tensor(labels), 6, engine=engine)
    for s in range(3):
        j = J_boundary(lnpi[s], labels[s], max_labels=6, engine=engine)
        for a, b, k in zip(j, tb, ("min_df", "max_val")):
            _same(a, b[s], f"{engine} state {s} {k}")
    assert (_np(tb[0]) > T._BIGNEG).any(), "no shared boundaries"


def test_boundary_engines_agree():
    """The port's one-hot and segment engines on the JAX test's label map."""
    rng = np.random.default_rng(11)
    H, N = 17, 29
    lnpi = torch.as_tensor(np.cumsum(rng.standard_normal((H, N)), axis=1))
    labels = np.zeros((H, N), dtype=np.int32)
    labels[:, : N // 3] = 1
    labels[:, N // 3 : 2 * N // 3] = 2
    labels[: H // 2, 2 * N // 3 :] = 3
    a = T.boundary_pair_integrals(lnpi, torch.as_tensor(labels), 5, engine="segment")
    b = T.boundary_pair_integrals(lnpi, torch.as_tensor(labels), 5, engine="onehot")
    for x, y in zip(a, b):
        _same(x, y, "segment vs onehot")
    assert T.BOUNDARY_SEGMENT_ENGINE == J.BOUNDARY_SEGMENT_ENGINE == "onehot"
    with pytest.raises(ValueError):
        T.boundary_pair_integrals(lnpi, torch.as_tensor(labels), 5, engine="scatter")


@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_boundary_cpu_route_is_plain(rng, engine):
    """CPU tensors take the plain engines, which the tests above hold
    against JAX: _boundary_batch (what pore_phase_batch and the sweeps
    call) returns _boundary_plain's tensors bit for bit, and the kernel of
    core/cuda_b2d.py is never launched (launches.b2d stays 0); its
    wrapper refuses CPU tensors before any launch, and an unknown engine
    still raises."""
    from fhmcanalysis_torch.core import cuda_b2d
    from fhmcanalysis_torch.utils.profiling import counters

    lnpi = torch.as_tensor(rng.normal(0, 10, size=(3, 13, 21)))
    lab = torch.as_tensor(rng.integers(0, 6, size=(3, 13, 21)).astype(np.int32))
    got, want = T._boundary_batch(lnpi, lab, 5, engine), T._boundary_plain(lnpi, lab, 5, engine)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
    t = T.pore_phase_batch(lnpi, lab, torch.ones(13, 21, dtype=torch.bool), np.full(13, 20), torch.ones(1, 13, 21, dtype=torch.float64),
                           torch.zeros(3, 5, dtype=torch.float64), torch.full((3,), 5), 5, boundary_engine=engine)
    assert torch.isfinite(t["ts"][t["ts"] > T._BIGNEG]).all()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_b2d.boundary_pairs(lnpi, lab, 5)
    with pytest.raises(ValueError, match="unknown boundary engine"):
        T._boundary_batch(lnpi, lab, 5, "scatter")
    assert counters().get("launches.b2d", 0) == 0


def test_sweeps_on_cpu_launch_no_kernel():
    """The 2-D sweeps on the CPU (either watershed engine, and the class
    path) run the plain boundary engine: launches.b2d stays 0."""
    from fhmcanalysis_torch import two_dim
    from fhmcanalysis_torch.utils.profiling import counters
    from torch_composites import FH_COEFFS, pore_states

    jh, fh = joint(pore13_entries()), two_dim.free_energy_profile.polynomial(FH_COEFFS)
    ps, bs = pore_states(4)
    for engine in ("device", "host"):
        out = two_dim.pore_state_sweep(jh, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, segment_engine=engine, device="cpu")
        assert (out["fail_code"] == 0).all()
    two_dim.pore_hist(joint(pore13_entries()), fh, 0.0, 1.0, 1.0, device="cpu").phase_average(nnebr=1, max_peaks=4)
    assert counters().get("launches.b2d", 0) == 0


def test_watershed_cpu_route_is_plain():
    """CPU tensors take the plain watershed: hillclimb_segment_batch returns
    _hillclimb_plain's tensors bit for bit, on a shared and on a per-state
    mask, and the kernel of core/cuda_ws2d.py is never launched
    (launches.ws2d stays 0, through the sweeps too); its wrapper refuses
    CPU tensors before any launch."""
    from fhmcanalysis_torch import two_dim
    from fhmcanalysis_torch.core import cuda_ws2d
    from fhmcanalysis_torch.utils.profiling import counters
    from torch_composites import FH_COEFFS, pore_states

    rng = np.random.RandomState(5)
    lnpi = torch.as_tensor(np.stack([rand_surface(rng, 13, 21, 3) for _ in range(3)]))
    for valid in (torch.as_tensor(_ragged(rng, 13, 21)[1]), torch.as_tensor(np.stack([_ragged(rng, 13, 21)[1] for _ in range(3)]))):
        got, want = T.hillclimb_segment_batch(lnpi, valid, (3, 5), 4), T._hillclimb_plain(lnpi, valid, (3, 5), 4)
        for k in want:
            assert got[k].device.type == "cpu" and torch.equal(got[k], want[k]), k
    jh, fh = joint(pore13_entries()), two_dim.free_energy_profile.polynomial(FH_COEFFS)
    two_dim.pore_state_sweep(jh, fh, *pore_states(4), 1.0, nnebr=1, max_peaks=4, segment_engine="device", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ws2d.watershed(lnpi, valid[0], (3, 5), 4)
    assert counters().get("launches.ws2d", 0) == 0


# ------------------------------------------------------------- watershed


def _hill(lnpi, valid, fp, P):
    j = J_hill(jnp.asarray(lnpi), jnp.asarray(valid), tuple(fp), P)
    t = T.hillclimb_segment(torch.as_tensor(lnpi), torch.as_tensor(valid), tuple(fp), P)
    return j, t


@pytest.mark.parametrize(
    "H,N,fp_cells",
    [(13, 21, 15), (5, 29, 45), (3, 149, 447)],
    ids=["fp3x5-jax-while-loop", "fp3x15-jax-pointer-jumping", "fp3x149-sorted-tie-scan"],
)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hillclimb_footprint_regimes(H, N, fp_cells, seed):
    """Each JAX branch of hillclimb_segment: labels, peaks and flags equal,
    and equal to the host flood where the slots do not saturate."""
    lnpi, valid, _, fp, lab_host, lm = _watershed_case(seed, H, N, P=7)
    assert fp.size == fp_cells
    j, t = _hill(lnpi, valid, fp.shape, 6)
    _same_dict(j, t, f"{H}x{N} seed {seed}", atol=0)
    if not bool(j["peak_sat"]):
        np.testing.assert_array_equal(_np(t["labels"]), lab_host)
        np.testing.assert_array_equal(_np(t["peak_rc"])[: len(lm)], lm)


def test_hillclimb_randomized_parity():
    """test_device_watershed.py's random draws (tilted bumps, ragged masks,
    nnebr 1 or 2) on four surface shapes: bit-equal to JAX, and to the
    host flood on every unsaturated draw."""
    rng = np.random.RandomState(7)
    checked = 0
    for i in range(16):
        H, N = ((23, 57), (40, 33), (9, 110), (51, 96))[i % 4]
        lnpi = rand_surface(rng, H, N, rng.randint(1, 6))
        edge, valid = _ragged(rng, H, N)
        nnebr = int(rng.choice([1, 2]))
        fp = _footprint(H, N, nnebr)
        j, t = _hill(lnpi, valid, fp.shape, 8)
        _same_dict(j, t, f"{H}x{N} fp {fp.shape}", atol=0)
        x = np.where(valid, lnpi - np.min(np.where(valid, lnpi, np.inf)), 0.0)
        lm = peak_local_max(x, min_distance=nnebr, exclude_border=0, num_peaks=9, footprint=fp)
        if len(lm) > 8:
            continue
        markers = np.zeros(lnpi.shape, int)
        for i, (r, c) in enumerate(lm):
            markers[r, c] = i + 1
        np.testing.assert_array_equal(_np(t["labels"]), watershed(-x, markers=markers, mask=valid, connectivity=fp))
        checked += 1
    assert checked >= 8


def test_hillclimb_batch_equals_single():
    cases = [_watershed_case(s, 14, 31) for s in (10, 11, 12, 13)]
    lnpi = np.stack([c[0] for c in cases])
    valid = cases[0][1] & cases[1][1] & cases[2][1] & cases[3][1]
    fp = cases[0][3].shape
    b = T.hillclimb_segment_batch(torch.as_tensor(lnpi), torch.as_tensor(valid), fp, 5)
    for s in range(4):
        one = T.hillclimb_segment(torch.as_tensor(lnpi[s]), torch.as_tensor(valid), fp, 5)
        for k in one:
            assert torch.equal(one[k], b[k][s]), k


def test_hillclimb_saturation_and_no_peaks():
    rng = np.random.RandomState(3)
    H, N = 40, 80
    lnpi = rand_surface(rng, H, N, 5) + 0.5 * rng.randn(H, N)  # noisy: many maxima
    valid = np.ones((H, N), bool)
    j, t = _hill(lnpi, valid, _footprint(H, N, 1).shape, 3)
    _same_dict(j, t, "saturated", atol=0)
    assert bool(t["peak_sat"]) and int(t["n_labels"]) == 3
    flat = np.zeros((10, 12))
    j, t = _hill(flat, np.ones((10, 12), bool), _footprint(10, 12, 1).shape, 4)
    _same_dict(j, t, "no peaks", atol=0)
    assert int(t["n_labels"]) == 0 and not bool(t["peak_sat"]) and (_np(t["labels"]) == 0).all()
    assert (_np(t["peak_rc"]) == -1).all()


class TestElevTie:
    """The exact-elevation-tie flag against JAX's on test_device_watershed's cases."""

    def _base(self):
        rng = np.random.RandomState(19)
        return rand_surface(rng, 20, 30, 3), np.ones((20, 30), bool), _footprint(20, 30, 1).shape

    def _tie(self, lnpi, valid, fp):
        j, t = _hill(lnpi, valid, fp, 4)
        assert bool(j["elev_tie"]) == bool(t["elev_tie"])
        return bool(t["elev_tie"])

    def test_cases(self):
        lnpi, valid, fp = self._base()
        assert not self._tie(lnpi, valid, fp)
        l2 = lnpi.copy()
        l2[5, 6] = l2[5, 5]  # horizontal neighbor
        assert self._tie(l2, valid, fp)
        l3 = lnpi.copy()
        l3[6, 3] = l3[5, 5]  # di = 1, dj = -2: the negative-dj half
        assert self._tie(l3, valid, fp)
        l4 = lnpi.copy()
        l4[15, 25] = l4[2, 2]  # farther apart than the footprint
        assert not self._tie(l4, valid, fp)
        v2 = valid.copy()
        v2[5, 6] = False  # the tied neighbor outside the mask
        assert not self._tie(l2, v2, fp)
        l5 = lnpi.copy()
        l5[3, 3] = l5[3, 4] = -np.inf  # two -inf cells are no elevation tie
        assert not self._tie(l5, valid, fp)

    def test_sort_scan_superset(self):
        lnpi, valid, _ = self._base()
        assert not self._tie(lnpi, valid, (23, 23))
        l2 = lnpi.copy()
        l2[15, 25] = l2[2, 2]
        assert self._tie(l2, valid, (23, 23))


# -------------------------------------------------------- phase analysis


@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_pore_phase_batch(engine):
    """Per-phase analysis of watershed-labelled ragged surfaces with more
    slots than phases (dead slots: peak_flat 0, fe 0, ridge_diff NaN, the
    _BIGNEG sentinel in ts)."""
    cases = [_watershed_case(s, 14, 31, P=4) for s in (20, 21, 22)]
    P = 6
    lnpi = np.stack([c[0] for c in cases])
    labels = np.stack([c[4] for c in cases]).astype(np.int32)
    edge = cases[0][2]
    valid = np.arange(31)[None, :] <= edge[:, None]
    props = np.stack([np.arange(14 * 31, dtype=float).reshape(14, 31), np.cos(np.arange(14 * 31)).reshape(14, 31)])
    n_lab = np.array([len(c[5]) for c in cases], dtype=np.int32)
    peak = np.zeros((3, P))
    for s, c in enumerate(cases):
        peak[s, : n_lab[s]] = c[0][c[5][:, 0], c[5][:, 1]]
    jb = J_phase(lnpi, labels, jnp.asarray(valid), edge, props, peak, n_lab, max_phases=P, boundary_engine=engine)
    tb = T.pore_phase_batch(torch.as_tensor(lnpi), torch.as_tensor(labels), valid, edge, props, peak, n_lab, P, boundary_engine=engine)
    _same_dict(jb, tb, f"pore_phase_batch {engine}")
    assert (n_lab < P).all() and (_np(tb["peak_flat"])[:, -1] == 0).all()
    assert (_np(tb["ts"]) == T._BIGNEG).any()
    one = T.pore_phase_core(lnpi[1], labels[1], valid, edge, props, peak[1], int(n_lab[1]), P, boundary_engine=engine)
    _same_dict({k: v[1] for k, v in jb.items()}, one, "pore_phase_core")


@pytest.mark.parametrize("engine", ["onehot", "segment"])
def test_fused_sweeps(engine):
    """pore_sweep_fused and joint_sweep_fused: surfaces, watershed and
    phase analysis, every output, on the bench's 13 x 21 pore surface and
    the tests' 12 x 25 two-basin joint surface."""
    from fhmcanalysis_tpu.two_dim import joint_hist as JH

    jh = joint(pore13_entries(), JH)
    jh.make()
    hd = jh.data
    raw, h = hd["ln(PI)"], hd["op_1"]
    edge = np.asarray(hd["bounds_idx"][:, 1], dtype=int)
    valid = np.arange(raw.shape[1])[None, :] <= edge[:, None]
    props = np.stack([hd["props"][k] for k in hd["props"]])
    fh = 0.1 * h
    ps, bs = np.linspace(0, 0.1, 4), np.linspace(0.9, 1.1, 4)
    fp = _footprint(*raw.shape, 1).shape
    j = J_pore_fused(raw, h, fh, ps, 1.0, bs, jnp.asarray(valid), edge, props, fp_shape=fp, max_phases=5, boundary_engine=engine)
    t = T.pore_sweep_fused(raw, h, fh, torch.as_tensor(ps), 1.0, torch.as_tensor(bs), valid, edge, props, fp, 5, boundary_engine=engine)
    _same(j[0], t[0], "pore lnpi")
    _same_dict(j[1], t[1], "pore seg")
    _same_dict(j[2], t[2], "pore core")

    jh = joint(two_basin_entries(), JH)
    jh.make()
    hd = jh.data
    raw = hd["ln(PI)"]
    valid = np.isfinite(raw)
    edge = np.asarray(hd["bounds_idx"][:, 1], dtype=int)
    props = np.stack([hd["props"][k] for k in hd["props"]])
    d1, d2 = np.linspace(-0.4, 0.5, 4), np.linspace(-0.3, 0.7, 4)
    fp = _footprint(*raw.shape, 1).shape
    j = J_joint_fused(raw, hd["op_1"], hd["op_2"], 1.1, d1, d2, jnp.asarray(valid), edge, props, fp_shape=fp, max_phases=5, boundary_engine=engine)
    t = T.joint_sweep_fused(raw, hd["op_1"], hd["op_2"], 1.1, torch.as_tensor(d1), torch.as_tensor(d2), valid, edge, props, fp, 5, boundary_engine=engine)
    _same(j[0], t[0], "joint lnpi")
    _same_dict(j[1], t[1], "joint seg")
    _same_dict(j[2], t[2], "joint core")


def test_empty_state_batch():
    """S = 0: every batch function returns empty, correctly shaped tensors."""
    H, N, P = 9, 17, 5
    valid = np.ones((H, N), bool)
    empty = torch.zeros(0, H, N, dtype=torch.float64)
    seg = T.hillclimb_segment_batch(empty, valid, (3, 5), P)
    assert seg["labels"].shape == (0, H, N) and seg["peak_rc"].shape == (0, P, 2) and seg["elev_tie"].shape == (0,)
    core = T.pore_phase_batch(empty, seg["labels"], valid, np.full(H, N - 1), np.ones((2, H, N)), seg["peak_lnpi"], seg["n_labels"], P)
    assert core["ave"].shape == (0, P, 2) and core["ts"].shape == (0, P + 1, P + 1)
    ln, x = T.pore_surface_batch(np.zeros((H, N)), np.arange(H, dtype=float), np.zeros(H), torch.zeros(0, dtype=torch.float64), 1.0, torch.zeros(0, dtype=torch.float64), valid)
    assert ln.shape == x.shape == (0, H, N)
