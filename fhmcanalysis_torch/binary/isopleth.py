"""Binary-mixture isopleths over the (mu_1, dmu_2) plane.

Parity target: the reference's moments/histogram/one_dim/ntot/gc_binary.pyx;
the PyTorch port's copy of the JAX package's ``binary/isopleth.py``.

The reference walks the grid pixel by pixel — reweight, extrapolate, mix,
thermo, with gc.collect() every iteration (gc_binary.pyx:243-290,
406-476).  Here ``isopleth.make_grid`` evaluates the whole surface in one
pass on the histograms' device (``iso_grid``): a short torch prologue builds
each source's mu-independent rows once, then kernel K3
(``core/cuda_iso.py``) on the CUDA card, or its plain PyTorch version
``iso_grid_body`` on the CPU, evaluates every (mu_1, dmu_2) cell.

Failed cells (edge effects, invalid segmentation, unsafe tails) surface as
zeros in the output grids with a reason in ``fail_code``, matching the
reference's print-and-continue behavior.  ``get_iso`` uses a native
marching-squares tracer instead of the reference's matplotlib-contour
dependency (gc_binary.pyx:659).  The host helpers are numpy, as in the JAX
package.
"""

from __future__ import annotations

import bisect
import copy
import json
import operator

import numpy as np
import scipy.interpolate
import scipy.ndimage
import torch

from ..core import cuda_iso, ops, pipeline, segment
from ..core.state import HistMeta
from ..histogram import ntot as gch
from ..parallel.mesh import _blocks, _on, replicate
from ..utils import profiling

__all__ = [
    "isopleth",
    "iso_grid",
    "iso_grid_body",
    "get_iso",
    "check_gibbs_duhem",
    "parameterize_mesh",
    "combine_isopleth_grids",
    "FAIL_OK",
    "FAIL_EDGE_UNSAFE",
    "FAIL_SEGMENTATION",
    "FAIL_PHASE_OVERFLOW",
]

# Per-cell failure reason codes (iso.data["fail_code"]): the reference
# prints each failed pixel's exception and moves on (gc_binary.pyx:441-442,
# 453-454, 465-468); the fixed-shape grids here carry the reason as a
# small int alongside the `valid` mask instead.
FAIL_OK = 0  # cell computed; valid=True
FAIL_EDGE_UNSAFE = 1  # segmentation fine, but an edge guard failed: the
#                       reweighted source tail or the mixed surface's last
#                       maximum misses the is_safe cutoff (gc_hist.pyx:556-596)
FAIL_SEGMENTATION = 2  # extrema alternation/order checks failed on the
#                        mixed surface (relextrema repairs could not fix it)
FAIL_PHASE_OVERFLOW = 3  # more maxima than max_phases padding slots; retry
#                          with a larger max_phases in _meta() (K3 holds up
#                          to 64 on the card, launch.MAX_PHASES)


def _find_left_right(ordered_dmu2, val, bound=False):
    """Bracketing indices of val in a sorted dmu2 array
    (gc_binary.pyx:31-79)."""
    tol = 1.0e-9
    ordered_dmu2 = np.asarray(ordered_dmu2)
    if val <= np.min(ordered_dmu2):
        return (0, 0) if bound else (-1, -1)
    elif val >= np.max(ordered_dmu2):
        n = len(ordered_dmu2)
        return (n - 1, n - 1) if bound else (n, n)
    elif np.any([np.isclose(val, x) for x in ordered_dmu2]):
        x = np.where(np.abs(ordered_dmu2 - val) < tol)[0]
        if len(x) != 1:
            raise Exception("dmu2 values repeat, %s , %s , %s" % (x, ordered_dmu2, val))
        return int(x[0]), int(x[0])
    left = bisect.bisect(list(ordered_dmu2), val) - 1
    return left, left + 1


def _get_most_stable_phase(hist):
    """Index of the minimum free-energy phase (gc_binary.pyx:83-107)."""
    free_energy = {p: hist.data["thermo"][p]["F.E./kT"] for p in hist.data["thermo"]}
    return sorted(free_energy.items(), key=operator.itemgetter(1))[0][0]


# ----------------------------------------------------------------------
# device part: every (mu_1, dmu_2) cell in one pass
# ----------------------------------------------------------------------
#
# Per cell the JAX package's XLA engine reweights each bracketing source to
# mu_1 and takes the joint (beta, dMu) Taylor step, grand-canonical
# averages included (_source_derivs), then mixes the two extrapolated
# surfaces by inverse distance and runs the thermo tail, the is_safe guard
# and the most-stable-phase pick (_grid_eval).  Each source's averages
# enter its lnPI' as one constant over the bins (core/pipeline.py says
# why); (c_L w0 + c_R w1) / (w0 + w1) is again a constant, and the tail,
# is_safe (a difference of two lnPI' values) and the edge flag
# (max - tail) all cancel it.  So here each side's x' is formed from the
# mu-independent rows of pipeline._mb_rows, as the extrapolating sweep
# forms it, and the plain version below uses elementwise products, sums
# and one divide in the association of kernel K3 (core/cuda_iso.py):
#
#   x_m = (x'_L w0 + x'_R w1) / (w0 + w1),  key_m the same way
#
# so segmentation, valid and fail_code agree bit for bit.
# tests/test_torch_isopleth.py holds the result against the JAX package's
# XLA engine and against the port's own literal per-cell composition.


@profiling.spanned("fhmc.prologue.iso")
def _iso_prologue(sources, meta: HistMeta, mu1_v, dmu2_v, lr, wts, beta_target, order: int, cutoff: float, kernel: bool = False) -> dict:
    """The tensors both engines read, in cuda_iso's layout, for the W
    sources that ``lr`` names (renumbered 0..W-1 in ``lr``): each source's
    lnpi, op and _mb_rows rows; a = beta_ref (mu_1 - mu_ref) and the edge
    flag per (source, mu_1) -- (max - cutoff) > tail of the normalized
    reweighted surface, as the XLA engine's stage 1 computes it; per row
    the weights and each side's target scalars (_mb_targets); the volume
    of source 0.  kernel: the rows from the row former (pipeline._rows)."""
    lr = np.asarray(lr)
    NY = len(dmu2_v)
    if lr.shape != (NY, 2) or np.shape(wts) != (NY, 2):
        raise ValueError(f"lr and wts must be [{NY}, 2], got {lr.shape} and {np.shape(wts)}")
    needed = sorted(set(lr.ravel().tolist()))
    if needed[0] < 0 or needed[-1] >= len(sources):
        raise ValueError(f"lr names sources outside 0..{len(sources) - 1}")
    h0 = sources[0]
    dev, N = h0.device, h0.nbins
    f64 = dict(dtype=torch.float64, device=dev)
    mu = torch.as_tensor(np.asarray(mu1_v, dtype=np.float64), **f64)
    dmu2 = torch.as_tensor(np.asarray(dmu2_v, dtype=np.float64), **f64)
    betas = torch.full((NY,), float(beta_target), **f64)
    parts = {k: [] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "tg")}
    for j in needed:
        h = sources[j]
        if h.nbins != N or h.device != dev:
            raise Exception("Isopleth source histograms must share the same order-parameter range and device")
        xrows, krows = pipeline._rows(h, meta, order, True, False, kernel)
        rw = ops.reweight(h, mu).lnpi  # [NX, N]
        parts["lnpi"].append(h.lnpi)
        parts["op"].append(h.op)
        parts["xrows"].append(xrows)
        parts["krows"].append(krows)
        parts["a"].append(pipeline._reweight_coeff(h, mu))
        parts["edge"].append((rw.amax(-1) - cutoff) > rw[:, -1])
        parts["tg"].append(pipeline._mb_targets(h, meta, betas, dmu2[:, None], order))  # [NY, T]
    pos = {j: w for w, j in enumerate(needed)}
    lr_w = torch.as_tensor(np.array([[pos[j] for j in row] for row in lr.tolist()], dtype=np.int32).reshape(NY, 2), device=dev)
    pro = {k: torch.stack(v).contiguous() for k, v in parts.items()}
    pro["tg"] = pro["tg"][lr_w.long(), torch.arange(NY, device=dev)[:, None]].contiguous()  # [NY, 2, T]
    pro.update(mu=mu, lr=lr_w, wts=torch.as_tensor(np.asarray(wts, dtype=np.float64), **f64), volume=h0.volume.contiguous())
    return pro


def _iso_surfaces(pro: dict, cols: slice, order: int):
    """The mixed surfaces of the cells in mu_1 columns ``cols``: x_m
    [NY*nx, N] and key_m [NY*nx, 3, N] (cell b = iy*nx + ix), each side's
    x' and key' in K3's association (csrc/extrap_rows.cuh)."""
    mu = pro["mu"][cols]
    xs, ks = [], []
    for s in (0, 1):
        src = pro["lr"][:, s].long()
        tg = pro["tg"][:, s]
        op, xr, kr = pro["op"][src][:, None, :], pro["xrows"][src], pro["krows"][src]
        c = lambda j: tg[:, j, None, None]  # noqa: E731  a row's target scalar against [NY, nx, N] or [NY, 3, N]
        x = pro["lnpi"][src][:, None, :] + pro["a"][src][:, cols, None] * op
        t = xr[:, None, 0, :] + mu[None, :, None] * op
        x = x + c(0) * t
        x = x + c(1) * xr[:, None, 1, :]
        k = kr[:, 0] + c(0) * kr[:, 1]
        k = k + c(1) * kr[:, 2]
        if order >= 2:
            q = c(2) * xr[:, None, 2, :]
            q = q + c(3) * xr[:, None, 3, :]
            q = q + c(4) * xr[:, None, 4, :]
            x = x + 0.5 * q
            q = c(2) * kr[:, 3]
            q = q + c(3) * kr[:, 4]
            q = q + c(4) * kr[:, 5]
            k = k + 0.5 * q
        xs.append(x)
        ks.append(k)
    w0, w1 = pro["wts"][:, 0, None, None], pro["wts"][:, 1, None, None]
    wsum = w0 + w1
    xm = (xs[0] * w0 + xs[1] * w1) / wsum
    km = (ks[0] * w0 + ks[1] * w1) / wsum
    NY, nx, N = xm.shape
    return xm.reshape(NY * nx, N), km[:, None].expand(NY, nx, 3, N).reshape(NY * nx, 3, N)


def _iso_cells(pro: dict, meta: HistMeta, cols: slice, order: int, cutoff: float, collect):
    """The plain cell evaluation over mu_1 columns ``cols``: segment once
    (thermo bounds and the is_safe extremum share it), integrate, guard,
    and pick the most stable phase (the XLA engine's _grid_eval)."""
    xm, km = _iso_surfaces(pro, cols, order)
    P, N = meta.max_phases, xm.shape[-1]
    ext = segment.relextrema(xm, meta.smooth, P)
    if collect is not None:
        ext = segment.COLLECT_TRANSFORMS[collect](ext, P)
    lefts, rights, pmask = segment.phase_bounds(ext, N, P)
    pt, props = segment.thermo_key_core(xm, km, meta, pro["volume"], bounds=(lefts, rights, pmask, ext.n_max, ext.valid))

    stable = torch.argmin(torch.where(pt.mask, pt.fe, torch.inf), dim=-1)
    last_max = segment._take_small(ext.maxima, ext.n_max - 1)
    safe = (segment._take_small(xm, last_max) - xm[:, -1]) >= cutoff
    left, right = pro["lr"][:, 0].long(), pro["lr"][:, 1].long()
    edge = (pro["edge"][left][:, cols] & pro["edge"][right][:, cols]).reshape(-1)
    guard = safe & edge
    ok = pt.valid & guard
    code = torch.where(
        pt.valid,
        torch.where(guard, FAIL_OK, FAIL_EDGE_UNSAFE),
        torch.where(ext.n_max > P, FAIL_PHASE_OVERFLOW, FAIL_SEGMENTATION),
    ).to(torch.int32)

    def pick(v):
        return torch.where(ok, v.gather(1, stable[:, None])[:, 0], 0.0)

    NY = pro["lr"].shape[0]
    out = (pick(props["x_i"][..., 0]), pick(props["density"]), pick(pt.fe), ok, code)
    return tuple(v.reshape(NY, -1) for v in out)


def _iso_check(sources, metas, order: int, collect):
    if not sources or len(sources) != len(metas) or metas[0].nspec != 2:
        raise ValueError("iso_grid: needs one HistMeta per source and nspec 2 (binary mixtures)")
    if order not in (1, 2):
        raise ValueError(f"iso_grid: orders 1-2, got {order}")
    if collect is not None and collect not in segment.COLLECT_TRANSFORMS:
        raise KeyError(collect)


def iso_grid_body(sources, metas, mu1_v, dmu2_v, lr, wts, beta_target, order: int, cutoff: float, collect=None, mu1_chunk=None):
    """The plain PyTorch isopleth surface on any device; see iso_grid.
    mu1_chunk: mu_1 columns per block (default: sized so the [cells, P, N]
    intermediates stay within pipeline._PLAIN_CHUNK_ELEMS)."""
    _iso_check(sources, metas, order, collect)
    meta = metas[0]
    pro = _iso_prologue(sources, meta, mu1_v, dmu2_v, lr, wts, beta_target, order, cutoff)
    NX, NY, N = pro["mu"].shape[0], pro["lr"].shape[0], sources[0].nbins
    per = mu1_chunk or max(1, pipeline._PLAIN_CHUNK_ELEMS // (meta.max_phases * N * max(NY, 1)))
    blocks = [_iso_cells(pro, meta, slice(i, i + per), order, cutoff, collect) for i in range(0, NX, per)]
    return tuple(torch.cat([b[k] for b in blocks], dim=1) for k in range(5))


def iso_grid(sources, metas, mu1_v, dmu2_v, lr, wts, beta_target, order: int, cutoff: float, collect=None, engine: str = "auto", mu1_chunk=None, *, _lanes=None):
    """Evaluate the isopleth surface over mu1_v [NX] x dmu2_v [NY].

    sources: list of port Hist (nspec 2) on one device, metas their
    HistMeta (the first one's smooth / max_phases / max_order apply to
    all, as in the JAX package); lr, wts: per dmu2 row the bracketing
    source indices and mixing weights (isopleth._bracket).  Returns
    (Z, density, fe, ok, fail_code) as [NY, NX] tensors (f64 x3, bool,
    int32), the counterpart of ``iso_grid_ds`` in the JAX package.

    engine: "auto" follows the tensors' device: CUDA launches kernel K3
    (cuda_iso) for the whole grid and raises for what it does not cover,
    CPU runs the plain version.  "torch" forces the plain version on
    either device; "cuda" forces the kernel and raises for CPU tensors.
    Nothing falls back.  mu1_chunk sizes only the plain version's blocks.
    _lanes forces K3's lanes per cell (cuda_iso.lanes_per_cell picks it
    otherwise); tests and chip_smoke.py use it.
    """
    if not pipeline._on_kernel(engine, sources[0].device, lanes=_lanes):
        return iso_grid_body(sources, metas, mu1_v, dmu2_v, lr, wts, beta_target, order, cutoff, collect, mu1_chunk)
    _iso_check(sources, metas, order, collect)
    meta = metas[0]
    pro = _iso_prologue(sources, meta, mu1_v, dmu2_v, lr, wts, beta_target, order, cutoff, kernel=True)
    return cuda_iso.iso_grid(
        pro["lnpi"], pro["op"], pro["xrows"], pro["krows"], pro["a"], pro["edge"], pro["mu"], pro["lr"], pro["wts"],
        pro["tg"], pro["volume"], meta.smooth, meta.max_phases, order, cutoff, collect, _lanes=_lanes,
    )


class isopleth(object):
    """Isopleths from a series of (mu_1, dmu_2) histograms
    (gc_binary.pyx:109-564)."""

    def __init__(self, histograms, beta_target, order=2):
        if not isinstance(histograms, (list, np.ndarray)):
            raise Exception("Expects an array of histograms to construct isopleths")
        for h in histograms:
            if not isinstance(h, gch.histogram):
                raise Exception("Expects a vector of histograms to construct isopleths")
        if beta_target <= 0:
            raise Exception("Illegal beta, cannot construct isopleths")
        if order < 1 or order > 2:
            raise Exception("Illegal order, cannot construct isopleths")

        self.meta = {"beta": beta_target, "tol": 1.0e-9, "order": order, "cutoff": 10.0}
        self.clear()

        t_ = -1.0
        dummy = {}
        for h in histograms:
            if h.data["nspec"] != 2:
                raise Exception("Component mismatch in isopleth generation")
            if len(h.data["curr_mu"]) != 2:
                raise Exception(
                    "Only expects 2 chemical potentials, one for each component, cannot construct isopleth"
                )
            dmu2 = float(h.data["curr_mu"][1] - h.data["curr_mu"][0])
            dummy[dmu2] = h
            if t_ > 0:
                if abs(h.metadata["beta_ref"] - t_) > self.meta["tol"]:
                    raise Exception("Expects all histograms to be performed at the same temperature")
            else:
                if h.metadata["beta_ref"] <= 0:
                    raise Exception("Illegal temperature in histograms")
                t_ = h.metadata["beta_ref"]
        dummy_sorted = sorted(dummy.items(), key=operator.itemgetter(0))

        self.data["dmu2"] = np.array([x[0] for x in dummy_sorted])
        self.data["histograms"] = [copy.deepcopy(x[1]) for x in dummy_sorted]

    def clear(self):
        self.data = {}

    # ------------------------------------------------------------------

    @profiling.spanned("fhmc.prologue.iso_bracket")
    def _bracket(self, dmu2_v, m):
        """Bracketing indices + complementary distance^m weights per row
        (gc_binary.pyx:225-240)."""
        ny = len(dmu2_v)
        lr = np.zeros((ny, 2), dtype=np.int32)
        wts = np.zeros((ny, 2))
        for i in range(ny):
            lr[i, 0], lr[i, 1] = _find_left_right(self.data["dmu2"], dmu2_v[i], True)
            dl = abs(self.data["dmu2"][lr[i, 0]] - dmu2_v[i]) ** m
            dr = abs(self.data["dmu2"][lr[i, 1]] - dmu2_v[i]) ** m
            if dl + dr < 1.0e-9:
                assert lr[i, 0] == lr[i, 1], "Unknown mixing distance error"
                wts[i] = [1.0, 1.0]
            else:
                wts[i] = [dr / (dr + dl), dl / (dr + dl)]
        return lr, wts

    def _grids(self, mu1_bounds, dmu2_bounds, delta):
        for name, b in (("mu1_bound", mu1_bounds), ("dmu2_bound", dmu2_bounds), ("delta", delta)):
            if not isinstance(b, (list, np.ndarray, tuple)):
                raise Exception("Expects an array of %s values to construct isopleths" % name)
            if len(b) != 2:
                raise Exception("%s error in constructing isopleths" % name)
        if mu1_bounds[1] <= mu1_bounds[0]:
            raise Exception("mu1_bound error in constructing isopleths")
        if dmu2_bounds[1] <= dmu2_bounds[0]:
            raise Exception("dmu2_bound error in constructing isopleths")
        if delta[0] <= 0 or delta[1] <= 0:
            raise Exception("delta error in constructing isopleths")
        nx = int(np.ceil((mu1_bounds[1] - mu1_bounds[0]) / delta[0])) + 1
        ny = int(np.ceil((dmu2_bounds[1] - dmu2_bounds[0]) / delta[1])) + 1
        return np.linspace(mu1_bounds[0], mu1_bounds[1], nx), np.linspace(dmu2_bounds[0], dmu2_bounds[1], ny)

    @profiling.spanned("fhmc.entry.make_grid")
    def make_grid(self, mu1_bounds, dmu2_bounds, delta, m=2.5, mu1_chunk=None, mesh=None, engine="auto", collect=None):
        """Compute the discretized 2D (mu_1, dmu_2) isopleth surface in one
        pass on the histograms' device (replaces gc_binary.pyx:355-476).

        Returns (grid_x1, (grid_mu1, grid_dmu2)); failed cells are 0 and
        data["fail_code"] says why (FAIL_*).  data holds numpy "Z",
        "density", "F.E./kT", "valid" and "fail_code" grids.

        engine: "auto" (default) follows the histograms' device: on CUDA
        every grid goes through kernel K3, on the CPU through its plain
        version; "torch" forces the plain version, "cuda" the kernel (it
        raises for CPU histograms).  mu1_chunk sizes only the plain
        version's mu_1 blocks (default: pipeline._PLAIN_CHUNK_ELEMS).
        mesh: a parallel.grid_mesh; the mu_1 columns are split into one
        contiguous block per mesh device (both axes flattened), the
        sources go to each device once, and each device evaluates its
        block through iso_grid (mu1_chunk per block); the bracket runs
        once on the host.  Cells are independent, so the surface is the
        single-device one.
        collect: optional segment.COLLECT_TRANSFORMS key ("janus")
        applied per cell.
        """
        mu1_v, dmu2_v = self._grids(mu1_bounds, dmu2_bounds, delta)
        self.data["X"], self.data["Y"] = np.meshgrid(mu1_v, dmu2_v)

        # validate user data before dispatch: a data error raises the
        # same way from either engine (the reference hits this per pixel
        # and print-continues, gc_binary.pyx:450-452; fail fast instead)
        hs = self.data["histograms"]
        if int(hs[0].data["max_order"]) < self.meta["order"] + 1:
            raise Exception("Maximum order stored in simulation not high enough to calculate this order of extrapolation")
        n0 = len(hs[0].data["ln(PI)"])
        for hj in hs[1:]:
            if len(hj.data["ln(PI)"]) != n0:
                raise Exception("Isopleth source histograms must share the same order-parameter range")

        lr, wts = self._bracket(dmu2_v, m)
        srcs, metas = [h._hist() for h in hs], [h._meta() for h in hs]
        if mesh is None:
            shards = [(None, srcs, mu1_v)]
        else:  # one column block per device, queued before any comes back
            shards = list(zip(mesh.device_list(), replicate(mesh, srcs), _blocks(mu1_v, mesh.size)))
        outs = []
        for d, s, cols in shards:
            with _on(d):
                outs.append(iso_grid(
                    s, metas, cols, dmu2_v, lr, wts,
                    self.meta["beta"], self.meta["order"], self.meta["cutoff"], collect=collect, engine=engine, mu1_chunk=mu1_chunk,
                ))
        keys = ("Z", "density", "F.E./kT", "valid", "fail_code")
        with profiling.span("fhmc.post.iso_copy"):
            for k, key in enumerate(keys):
                self.data[key] = np.concatenate([o[k].cpu().numpy() for o in outs], axis=1)
        profiling.add("host_syncs", len(keys) * len(outs))
        return self.data["Z"], (self.data["X"], self.data["Y"])

    # the chunked variant of the reference is subsumed by the batched path
    make_grid_multi = make_grid

    def get_hist(self, mu1, dmu2, m=2.5):
        """Interpolated histogram at one (mu_1, dmu_2) (gc_binary.pyx:292-353)."""
        left, right = _find_left_right(self.data["dmu2"], dmu2, False)

        if left == right:
            if left < 0:
                h_l = self.data["histograms"][0]
            elif left == len(self.data["dmu2"]):
                h_l = self.data["histograms"][-1]
            else:
                h_l = self.data["histograms"][left]
            try:
                h_l.reweight(mu1)
                h_m = h_l.temp_dmu_extrap(
                    self.meta["beta"], np.array([dmu2], dtype=np.float64), self.meta["order"],
                    self.meta["cutoff"], False, True, False,
                )
            except Exception as e:
                raise Exception("Unable to get histogram : %s" % e)
        else:
            h_l = self.data["histograms"][left]
            h_r = self.data["histograms"][right]
            try:
                h_l.reweight(mu1)
                h_l = h_l.temp_dmu_extrap(
                    self.meta["beta"], np.array([dmu2], dtype=np.float64), self.meta["order"],
                    self.meta["cutoff"], False, True, False,
                )
                h_r.reweight(mu1)
                h_r = h_r.temp_dmu_extrap(
                    self.meta["beta"], np.array([dmu2], dtype=np.float64), self.meta["order"],
                    self.meta["cutoff"], False, True, False,
                )
            except Exception as e:
                raise Exception("Unable to get histogram : %s" % e)
            dl = abs(self.data["dmu2"][left] - dmu2) ** m
            dr = abs(self.data["dmu2"][right] - dmu2) ** m
            wl = dr / (dr + dl)
            wr = dl / (dr + dl)
            h_m = h_l.mix(h_r, [wl, wr])

        return h_m

    def dump(self, fname):
        """JSON persist of the surface (gc_binary.pyx:478-497)."""
        info = {
            "mu_1": self.data["X"].tolist(),
            "dmu_2": self.data["Y"].tolist(),
            "x_1": self.data["Z"].tolist(),
            "density": self.data["density"].tolist(),
            "F.E./kT": self.data["F.E./kT"].tolist(),
        }
        # an extra over gc_binary.pyx:478-497 (which only had the
        # per-pixel console prints): persist the failure reasons too
        if "fail_code" in self.data:
            info["fail_code"] = np.asarray(self.data["fail_code"]).tolist()
        with open(fname, "w") as f:
            json.dump(info, f, sort_keys=True, indent=4)

    def load(self, fname):
        """Load surface from JSON (gc_binary.pyx:499-523)."""
        with open(fname, "r") as f:
            info = json.load(f)
        self.data["X"] = np.array(info["mu_1"], dtype=np.float64)
        self.data["Y"] = np.array(info["dmu_2"], dtype=np.float64)
        self.data["Z"] = np.array(info["x_1"], dtype=np.float64)
        self.data["density"] = np.array(info["density"], dtype=np.float64)
        self.data["F.E./kT"] = np.array(info["F.E./kT"], dtype=np.float64)
        if "fail_code" in info:
            self.data["fail_code"] = np.array(info["fail_code"], dtype=np.int32)
        for k in ("Y", "Z", "density", "F.E./kT"):
            assert self.data["X"].shape == self.data[k].shape, "Shape mismatch in " + fname

    def zoom(self, factor, order=3, inplace=False):
        """Cubic-spline resampling of the surface (gc_binary.pyx:525-564)."""
        zx = scipy.ndimage.zoom(self.data["X"], factor, order=order)
        zy = scipy.ndimage.zoom(self.data["Y"], factor, order=order)
        zz = scipy.ndimage.zoom(self.data["Z"], factor, order=order)
        rho = scipy.ndimage.zoom(self.data["density"], factor, order=order)
        fe = scipy.ndimage.zoom(self.data["F.E./kT"], factor, order=order)
        if inplace:
            self.data["X"], self.data["Y"], self.data["Z"] = zx, zy, zz
            self.data["density"], self.data["F.E./kT"] = rho, fe
        return zz, (zx, zy), rho, fe


# ----------------------------------------------------------------------
# grid post-processing (host)
# ----------------------------------------------------------------------


def _marching_squares(grid_x, grid_y, grid_z, level):
    """Trace iso-contours of z(level) on a rectilinear grid.

    Native replacement for the reference's matplotlib-contour extraction
    (gc_binary.pyx:659-663): classic marching squares with linear edge
    interpolation, segments chained into polylines.  Returns a list of
    paths (each an [K,2] array of (x, y)), longest first.
    """
    z = np.asarray(grid_z)
    x = np.asarray(grid_x)
    y = np.asarray(grid_y)
    nr, nc = z.shape
    segs = []

    def interp(p1, p2, v1, v2):
        t = (level - v1) / (v2 - v1)
        return (p1[0] + t * (p2[0] - p1[0]), p1[1] + t * (p2[1] - p1[1]))

    for i in range(nr - 1):
        for j in range(nc - 1):
            corners = [
                ((x[i, j], y[i, j]), z[i, j]),
                ((x[i, j + 1], y[i, j + 1]), z[i, j + 1]),
                ((x[i + 1, j + 1], y[i + 1, j + 1]), z[i + 1, j + 1]),
                ((x[i + 1, j], y[i + 1, j]), z[i + 1, j]),
            ]
            if any(not np.isfinite(c[1]) for c in corners):
                continue
            idx = 0
            for b, (_, v) in enumerate(corners):
                if v > level:
                    idx |= 1 << b
            if idx in (0, 15):
                continue
            # edges: 0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0)
            pts = {}
            edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
            for e, (a, b) in enumerate(edges):
                va, vb = corners[a][1], corners[b][1]
                if (va > level) != (vb > level):
                    pts[e] = interp(corners[a][0], corners[b][0], va, vb)
            CASES = {
                1: [(3, 0)], 2: [(0, 1)], 3: [(3, 1)], 4: [(1, 2)],
                5: [(3, 2), (1, 0)], 6: [(0, 2)], 7: [(3, 2)],
                8: [(2, 3)], 9: [(2, 0)], 10: [(2, 1), (0, 3)],
                11: [(2, 1)], 12: [(1, 3)], 13: [(1, 0)], 14: [(0, 3)],
            }
            for a, b in CASES[idx]:
                if a in pts and b in pts:
                    segs.append((pts[a], pts[b]))

    # chain segments into polylines
    def key(p):
        return (round(p[0], 9), round(p[1], 9))

    adj = {}
    for s in segs:
        adj.setdefault(key(s[0]), []).append(s)
        adj.setdefault(key(s[1]), []).append(s)

    unused = set(range(len(segs)))
    seg_by_id = dict(enumerate(segs))
    paths = []
    id_at = {}
    for sid, s in seg_by_id.items():
        id_at.setdefault(key(s[0]), []).append(sid)
        id_at.setdefault(key(s[1]), []).append(sid)

    while unused:
        sid = next(iter(unused))
        unused.discard(sid)
        s = seg_by_id[sid]
        path = [s[0], s[1]]
        # extend forward and backward
        for end in (True, False):
            while True:
                tip = path[-1] if end else path[0]
                cands = [t for t in id_at.get(key(tip), []) if t in unused]
                if not cands:
                    break
                t = cands[0]
                unused.discard(t)
                a, b = seg_by_id[t]
                nxt = b if key(a) == key(tip) else a
                if end:
                    path.append(nxt)
                else:
                    path.insert(0, nxt)
        paths.append(np.array(path))

    paths.sort(key=lambda p: -len(p))
    return paths


def get_iso(t, grid_t, grid_mu1, grid_dmu2):
    """Trace the iso-contour of a gridded quantity (gc_binary.pyx:637-664).

    Returns a list of (mu_1, dmu_2) tuples along the longest contour.
    """
    paths = _marching_squares(grid_mu1, grid_dmu2, grid_t, t)
    if not paths:
        raise Exception("No contour found at level %s" % t)
    return [tuple(p) for p in paths[0]]


def check_gibbs_duhem(isobars, grid_x1, grid_p, grid_mu1, grid_dmu2, k=3, s=0.0):
    """Gibbs-Duhem consistency along isobars (gc_binary.pyx:566-635).

    err = x1 * dmu1/dx1 + (1 - x1) * dmu2/dx1 along each isobar; returns
    list of (p, errors, x1s, mu_points, q1s) per isobar ((p, None) when
    the isobar cannot be traced).
    """
    try:
        interp = scipy.interpolate.RegularGridInterpolator(
            (grid_dmu2[:, 0], grid_mu1[0, :]), grid_x1, method="linear", bounds_error=False, fill_value=np.nan
        )
    except (Exception, TypeError, ValueError) as e:
        raise Exception("Unable to create grid interpolator to check Gibbs-Duhem consistency : %s" % e)

    error = []
    for p in isobars:
        try:
            mu_vals_isobar = get_iso(p, grid_p, grid_mu1, grid_dmu2)
        except (Exception, TypeError, ValueError) as e:
            print("Unable to check Gibbs-Duhem consistency along P = %s isobar : %s" % (p, e))
            error.append((p, None))
            continue

        pts = np.array([(a[1], a[0]) for a in mu_vals_isobar])
        x1_vals = interp(pts)

        finite = np.isfinite(x1_vals)
        order = np.argsort(x1_vals[finite])
        xs = x1_vals[finite][order]
        mu1s = np.array([a[0] for a in mu_vals_isobar])[finite][order]
        mu2s = np.array([a[1] + a[0] for a in mu_vals_isobar])[finite][order]
        # splrep needs strictly increasing x
        keep = np.concatenate([[True], np.diff(xs) > 1e-12])
        mu1_x1 = scipy.interpolate.splrep(xs[keep], mu1s[keep], s=s, k=k)
        mu2_x1 = scipy.interpolate.splrep(xs[keep], mu2s[keep], s=s, k=k)

        error_p, x1_t, mu_t, q1_t = [], [], [], []
        for i in range(len(mu_vals_isobar)):
            x1v = x1_vals[i]
            if not np.isnan(x1v):
                q1 = x1v * scipy.interpolate.splev(x1v, mu1_x1, der=1)
                err = q1 + (1.0 - x1v) * scipy.interpolate.splev(x1v, mu2_x1, der=1)
                q1_t.append(q1)
                error_p.append(err)
                x1_t.append(x1v)
                mu_t.append(mu_vals_isobar[i])
        error.append((p, error_p, x1_t, mu_t, q1_t))

    return error


def parameterize_mesh(mu1_mesh, dmu2_mesh, x_mesh, y_mesh, x_pts):
    """Express one mesh vs another along a path (gc_binary.pyx:666-703)."""
    if mu1_mesh.shape != dmu2_mesh.shape:
        raise Exception("Unequal grid sizes")
    if x_mesh.shape != dmu2_mesh.shape:
        raise Exception("Unequal grid sizes")
    if x_mesh.shape != y_mesh.shape:
        raise Exception("Unequal grid sizes")

    pts = np.array([(a[1], a[0]) for a in x_pts])
    x = mu1_mesh[0, :]
    y = dmu2_mesh[:, 0]
    interp = scipy.interpolate.RegularGridInterpolator((y, x), x_mesh, method="linear")
    x_vals = interp(pts)
    interp = scipy.interpolate.RegularGridInterpolator((y, x), y_mesh, method="linear")
    y_vals = interp(pts)
    return list(zip(x_vals, y_vals))


def combine_isopleth_grids(mu1_arrays, dmu2_arrays, x1_arrays, rho_arrays=None, fe_arrays=None):
    """Concatenate isopleth grids along mu_1 with dmu_2 alignment checks
    and overlap trimming (gc_binary.pyx:705-819)."""
    if not isinstance(mu1_arrays, (list, np.ndarray, tuple)):
        raise Exception("Expects an array of mu1_arrays to combine isopleths")
    if not isinstance(dmu2_arrays, (list, np.ndarray, tuple)):
        raise Exception("Expects an array of dmu2_arrays to combine isopleths")
    if not isinstance(x1_arrays, (list, np.ndarray, tuple)):
        raise Exception("Expects an array of x1_arrays to combine isopleths")
    if not (len(mu1_arrays) == len(dmu2_arrays) and len(dmu2_arrays) == len(x1_arrays)):
        raise Exception("Must specify one mu_1, dmu_2, and x_1 for each isopleth")

    if rho_arrays is not None:
        if not isinstance(rho_arrays, (list, np.ndarray, tuple)):
            raise Exception("Expects an array of rho_arrays to combine isopleths")
        if len(mu1_arrays) != len(rho_arrays):
            raise Exception("Must specify one density for each isopleth")
    if fe_arrays is not None:
        if not isinstance(fe_arrays, (list, np.ndarray, tuple)):
            raise Exception("Expects an array of fe_arrays to combine isopleths")
        if len(mu1_arrays) != len(fe_arrays):
            raise Exception("Must specify one free energy for each isopleth")

    for i in range(len(mu1_arrays)):
        if not (mu1_arrays[i].shape == dmu2_arrays[i].shape and dmu2_arrays[i].shape == x1_arrays[i].shape):
            raise Exception("Each set of isopleth grids must have the same size")
        if rho_arrays is not None and mu1_arrays[i].shape != rho_arrays[i].shape:
            raise Exception("Each set of isopleth grids must have the same size")
        if fe_arrays is not None and mu1_arrays[i].shape != fe_arrays[i].shape:
            raise Exception("Each set of isopleth grids must have the same size")

    for i in range(len(mu1_arrays) - 1):
        for arrs in (mu1_arrays, dmu2_arrays, x1_arrays):
            if arrs[i].shape[0] != arrs[i + 1].shape[0]:
                raise Exception("dmu2 dimension not aligned")
        if rho_arrays is not None and rho_arrays[i].shape[0] != rho_arrays[i + 1].shape[0]:
            raise Exception("dmu2 dimension not aligned")
        if fe_arrays is not None and fe_arrays[i].shape[0] != fe_arrays[i + 1].shape[0]:
            raise Exception("dmu2 dimension not aligned")

    min_mu1 = [np.min(m1a) for m1a in mu1_arrays]
    if fe_arrays is None and rho_arrays is None:
        zz = dict(enumerate(zip(min_mu1, mu1_arrays, dmu2_arrays, x1_arrays)))
    elif fe_arrays is None:
        zz = dict(enumerate(zip(min_mu1, mu1_arrays, dmu2_arrays, x1_arrays, rho_arrays)))
    elif rho_arrays is None:
        zz = dict(enumerate(zip(min_mu1, mu1_arrays, dmu2_arrays, x1_arrays, fe_arrays)))
    else:
        zz = dict(enumerate(zip(min_mu1, mu1_arrays, dmu2_arrays, x1_arrays, rho_arrays, fe_arrays)))
    sorted_zz = sorted(zz.items(), key=lambda x: x[1][0])

    X = copy.copy(sorted_zz[0][1][1])
    Y = copy.copy(sorted_zz[0][1][2])
    Z = copy.copy(sorted_zz[0][1][3])
    A = B = None
    if len(sorted_zz[0][1]) == 5:
        A = copy.copy(sorted_zz[0][1][4])
    elif len(sorted_zz[0][1]) == 6:
        A = copy.copy(sorted_zz[0][1][4])
        B = copy.copy(sorted_zz[0][1][5])

    dmu2_ref = sorted_zz[0][1][2][:, 1]
    for i in range(1, len(sorted_zz)):
        this_entry = sorted_zz[i]
        last_entry = sorted_zz[i - 1]

        if not np.all(np.abs(this_entry[1][2][:, 0] - dmu2_ref) < 1.0e-9):
            raise Exception("dmu2 dimension not aligned")

        mu1_right = this_entry[1][1][0, :]
        max_mu1_left = np.max(last_entry[1][1][0, :])
        ncols = bisect.bisect_left(list(mu1_right), max_mu1_left)
        if mu1_right[ncols] == max_mu1_left:
            ncols += 1

        X = np.concatenate((X, this_entry[1][1][:, ncols:]), axis=1)
        Y = np.concatenate((Y, this_entry[1][2][:, ncols:]), axis=1)
        Z = np.concatenate((Z, this_entry[1][3][:, ncols:]), axis=1)
        if len(sorted_zz[0][1]) == 5:
            A = np.concatenate((A, this_entry[1][4][:, ncols:]), axis=1)
        elif len(sorted_zz[0][1]) == 6:
            A = np.concatenate((A, this_entry[1][4][:, ncols:]), axis=1)
            B = np.concatenate((B, this_entry[1][5][:, ncols:]), axis=1)

    if A is None and B is None:
        return Z, (X, Y)
    elif A is not None and B is None:
        return Z, (X, Y), A
    return Z, (X, Y), A, B
