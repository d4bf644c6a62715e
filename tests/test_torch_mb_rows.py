"""The row former (``cuda_mb.mb_rows``, ``csrc/mb_rows.cuh``) on the CPU.

The card runs the row former's fixed formulas over the table of moment
addresses and gates that ``cuda_mb.rows_table`` resolves on the host.
Here that table is read back twice and held to the plain
``pipeline._mb_rows`` bit for bit: by a small plain evaluator of the same
formulas in torch, and by ``csrc/mb_rows.cuh`` itself built with g++ for
the host (``tests/tail_host/mb_rows_host.cpp``, one bin per iteration, as
the kernel runs one bin per thread).  Both over nspec 1/2, orders 1/2,
props on and off, first_order_mom, used_ke and max_order 1-4, on the
seeded composites and on moments of random normals (where no two
addresses hold the same row, so a wrong address cannot agree by chance).
The table raises where ``_mb_rows`` raises, with its message, and the
kernel route refuses CPU tensors before any launch.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
from fhmcanalysis_torch.utils.profiling import counters
from torch_composites import ROW_CASES, ROW_MAX_ORDERS, cell, make_composite, row_inputs

torch.set_num_threads(1)

def _hists(nspec, max_order, used_ke):
    """(name, Hist, HistMeta) on the CPU: the row former's inputs on the
    nspec's cell (torch_composites.row_inputs)."""
    xs, mk = row_inputs("n31" if nspec == 2 else "n573", max_order, used_ke)
    meta = TS.HistMeta(**mk)
    return [(name, TS.from_host(x, device="cpu"), meta) for name, x in zip(("composite", "random"), xs)]


def _bits(t):
    return t.contiguous().view(torch.int64)


def _same_bits(got, want, where):
    assert got.shape == want.shape, where
    assert torch.equal(_bits(got), _bits(want)), (where, float((got - want).abs().max()))


def _evaluate(t: CM.Table, h):
    """The row former's formulas (csrc/mb_rows.cuh) as torch operations,
    reading the moments only through the table's flat rows."""
    S = t.S
    mom = h.mom.reshape(-1, h.nbins)
    beta, op = h.curr_beta, h.op
    dmu = [h.curr_mu[s] - h.curr_mu[0] for s in range(S)]

    def m(a):
        return mom[a]

    def zeros():
        return torch.zeros_like(op)

    def sgb(r):
        if r.zero:
            return zeros()
        der = -(m(r.bu) - m(r.b) * m(t.key[S]))
        for s in range(S):
            der = der + dmu[s] * (m(r.xni[s]) - m(r.b) * m(t.key[s]))
        if r.ke:
            der = der - (beta * beta).reciprocal() * (1.5 * r.ke) * op * m(r.bd)
        return der

    def sgm(r):
        return zeros() if r.zero else beta * (m(r.xni) - m(r.b) * m(t.key[1]))

    def sgb2(k):
        s = t.slot[k]

        def df(z, y):
            return sgb(z) - m(s.m) * sgb(t.slot[y].a) - m(t.key[y]) * sgb(s.a)

        der = -df(s.au, S)
        for i in range(S):
            der = der + dmu[i] * df(s.an[i], i)
        if s.a.ke:
            a = beta.reciprocal() * -2.0 * m(s.a.bd)
            der = der + op * (-1.5 * s.a.ke) / (beta * beta) * (a + sgb(s.ad))
        return der

    def cross(k):
        s = t.slot[k]
        f = m(s.pn) - m(t.key[1]) * m(s.m)
        return beta * (sgb(s.pnb) - m(t.key[1]) * sgb(s.a) - m(s.m) * sgb(t.slot[1].a)) + f

    def sgm2(k):
        s = t.slot[k]
        return beta * (sgm(s.mn) - m(s.m) * sgm(t.slot[1].ma) - m(t.key[1]) * sgm(s.ma))

    acc = zeros()
    for s in range(1, S):
        acc = acc + dmu[s] * m(t.key[s])
    x = [acc - m(t.key[S])] + ([beta * m(t.key[1])] if S == 2 else [])
    if t.order >= 2:
        acc = zeros()
        for s in range(1, S):
            acc = acc + dmu[s] * sgb(t.slot[s].a)
        x.append(acc - sgb(t.slot[S].a))
        if S == 2:
            x += [m(t.key[1]) + beta * sgb(t.slot[1].a), beta * beta * (m(t.f11[0]) - m(t.f11[1]) * m(t.f11[2]))]
    if not t.props:
        return torch.stack(x), None
    ks = range(S + 1)
    groups = [[m(t.key[k]) for k in ks], [sgb(t.slot[k].a) if t.gate1 else zeros() for k in ks]]
    if S == 2:
        groups.append([sgm(t.slot[k].ma) if t.gate1 else zeros() for k in ks])
    if t.khess:
        groups.append([sgb2(k) if t.gate2 else zeros() for k in ks])
        if S == 2:
            groups += [[cross(k) if t.gate2 else zeros() for k in ks], [sgm2(k) if t.gate2 else zeros() for k in ks]]
    return torch.stack(x), torch.stack([torch.stack(g) for g in groups])


def _plain(h, meta, order, props, fom):
    """_mb_rows' rows, or the exception it raises."""
    try:
        return TP._mb_rows(h, meta, order, props, fom)
    except (ValueError, IndexError) as e:
        return e


def _same_raise(want, call):
    with pytest.raises(type(want)) as got:
        call()
    if isinstance(want, ValueError):
        assert str(got.value) == str(want)


@pytest.mark.parametrize("used_ke", [False, True])
@pytest.mark.parametrize("max_order", ROW_MAX_ORDERS)
@pytest.mark.parametrize("nspec", [1, 2])
def test_table_reproduces_mb_rows(nspec, max_order, used_ke):
    """The table read back by the plain evaluator equals _mb_rows bit for
    bit in every case _mb_rows answers, and raises as it does elsewhere
    (order 2 at max_order 1)."""
    answered = 0
    for name, h, meta in _hists(nspec, max_order, used_ke):
        for order, props, fom in ROW_CASES:
            where = (name, order, props, fom)
            want = _plain(h, meta, order, props, fom)
            CM.rows_table.cache_clear()
            if isinstance(want, Exception):
                _same_raise(want, lambda: CM.rows_table(meta, order, props, fom))
                continue
            t = CM.rows_table(meta, order, props, fom)
            assert len(list(CM._ints(t))) == CM.TABLE_INTS
            got = _evaluate(t, h)
            _same_bits(got[0], want[0], where)
            assert (got[1] is None) == (want[1] is None) == (not props), where
            if props:
                _same_bits(got[1], want[1], where)
                assert want[1].shape == (CM.n_groups(nspec, order, fom), nspec + 1, h.nbins)
            assert want[0].shape == (CM.n_xrows(nspec, order), h.nbins)
            answered += 1
    assert answered == (2 * len(ROW_CASES) if max_order >= 2 else 4)


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """csrc/mb_rows.cuh built with g++ for the host, one bin an iteration."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the row former for the host")
    here = Path(__file__).parent
    so = tmp_path_factory.mktemp("mb_rows_host") / "libmb_rows_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-I", str(here / "tail_host"),
                    "-I", str(here.parent / "fhmcanalysis_torch" / "csrc"), str(here / "tail_host" / "mb_rows_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.mb_rows_host_run.argtypes = [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.mb_rows_host_table_ints.restype = ctypes.c_int
    return lib


def _host_run(lib, h, meta, order, props, fom):
    """The host build's rows, every output poisoned first so a row it
    leaves unwritten shows."""
    S, N = meta.nspec, h.nbins
    xrows = torch.full((CM.n_xrows(S, order), N), 12345.0, dtype=torch.float64)
    krows = torch.full((CM.n_groups(S, order, fom), S + 1, N), 12345.0, dtype=torch.float64) if props else None
    mom, mu = h.mom.contiguous(), h.curr_mu.contiguous()
    lib.mb_rows_host_run(CM._table_array(meta, order, props, fom), mom.data_ptr(), h.op.data_ptr(), h.curr_beta.data_ptr(), mu.data_ptr(),
                         xrows.data_ptr(), None if krows is None else krows.data_ptr(), N)
    return xrows, krows


@pytest.mark.parametrize("used_ke", [False, True])
@pytest.mark.parametrize("max_order", ROW_MAX_ORDERS)
@pytest.mark.parametrize("nspec", [1, 2])
def test_kernel_source_on_host_reproduces_mb_rows(host_rows, nspec, max_order, used_ke):
    """csrc/mb_rows.cuh, built for the host with the kernels' rounding,
    writes every row of _mb_rows bit for bit from the table the launch
    passes, whose layout is the header's."""
    assert host_rows.mb_rows_host_table_ints() == CM.TABLE_INTS
    answered = 0
    for name, h, meta in _hists(nspec, max_order, used_ke):
        for order, props, fom in ROW_CASES:
            want = _plain(h, meta, order, props, fom)
            if isinstance(want, Exception):
                continue
            got = _host_run(host_rows, h, meta, order, props, fom)
            _same_bits(got[0], want[0], (name, order, props, fom))
            if props:
                _same_bits(got[1], want[1], (name, order, props, fom))
            answered += 1
    assert answered == (2 * len(ROW_CASES) if max_order >= 2 else 4)


@pytest.mark.parametrize(
    "nspec, max_order, order, props, fom",
    [
        (1, 0, 1, True, False),  # the key rows themselves are past the moments
        (2, 0, 1, False, False),
        (1, 1, 2, True, False),  # order 2 reads sgB(U): U's power is max_order
        (2, 1, 2, False, False),  # sgB(N_1) first
        (2, 1, 2, True, True),
    ],
)
def test_max_order_too_low_raises_as_the_engine_does(nspec, max_order, order, props, fom):
    """Where the moments are too short, the table raises what _mb_rows
    raises (the ValueErrors with their message), before any launch."""
    d = make_composite(N=9, nspec=nspec, beta=1.0, mu0=(5.0, 0.0)[:nspec], seed=1, max_order=max_order)
    h = TS.from_host(d, device="cpu")
    meta = TS.HistMeta(nspec=nspec, max_order=max_order, used_ke=False, smooth=1, max_phases=4)
    want = _plain(h, meta, order, props, fom)
    assert isinstance(want, Exception)
    CM.rows_table.cache_clear()
    _same_raise(want, lambda: CM.rows_table(meta, order, props, fom))
    n0 = counters().get("launches.mb_rows", 0)
    _same_raise(want, lambda: CM.mb_rows(h, meta, order, props, fom))
    assert counters().get("launches.mb_rows", 0) == n0


def test_kernel_route_refuses_cpu_tensors():
    """engine='cuda' on CPU tensors raises in the row former's checks,
    before any launch, through the sweep, the solver and the row former
    itself; engine 'auto' and 'torch' on the CPU build the plain rows and
    launch nothing."""
    d, mk, mus = cell("n31", 4, max_order=3)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    before = {k: counters().get(k, 0) for k in ("launches.mb_rows", "launches.k2")}
    with pytest.raises(ValueError, match="mb_rows: lnpi is on cpu; the CUDA kernel needs CUDA tensors"):
        CM.mb_rows(h, meta, 2, True, False)
    with pytest.raises(ValueError, match="mb_rows: .* CUDA tensors"):
        TP.mu_beta_sweep_thermo(h, meta, mus, [1.0], [[-5.0]], order=2, engine="cuda")
    with pytest.raises(ValueError, match="mb_rows: .* CUDA tensors"):
        TSV.phase_eq_error([5.0], h, meta, beta=1.01, min_width=2, extrapolate=True, engine="cuda")
    for engine in ("auto", "torch"):
        TP.mu_beta_sweep_thermo(h, meta, mus, [1.0], [[-5.0]], order=2, engine=engine)
    assert {k: counters().get(k, 0) for k in before} == before
