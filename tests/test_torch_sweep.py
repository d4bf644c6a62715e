"""PyTorch port: the mu-sweep main path against the JAX package.

The port's mu_sweep_thermo on CPU runs the plain version (segment.py +
pipeline._point_thermo); it is held against JAX mu_sweep_thermo(engine=
"xla") on the three sweep cells, segmentation bit for bit and floats to
1e-12 absolute -- except <U> at N=1400, whose entries reach ~4e3
(U ~ -3N): two sums of 1400 such terms taken in different orders differ
by a few ulp of that magnitude (4e-12 measured), so <U> there is held to
1e-12 relative.  At N=31 the port is also held against K1's own CPU body
(mu_sweep_thermo_ds(mode="xla"), the double-single lanes path) at that
kernel's 1e-10 bar.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.state as TS
from fhmcanalysis_torch.utils.profiling import counters
import fhmcanalysis_tpu.core.pipeline as JP
import fhmcanalysis_tpu.core.state as JS
from fhmcanalysis_tpu.core.pallas_sweep import mu_sweep_thermo_ds
from torch_composites import cell, worst_abs_diff

torch.set_num_threads(1)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")


def _inputs(name, points):
    d, mk, mus = cell(name, points)
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk), mus


def _check(got, want, props, tol, rel=()):
    assert set(got) == set(want)
    for k in SEG:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    ok = np.asarray(want["mask"])
    for k in ("fe",) + (PROPS if props else ()):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        okx = ok.reshape(ok.shape + (1,) * (w.ndim - 2))
        if k in rel:
            scale = np.maximum(1.0, np.abs(np.where(okx, w, 0.0)))
            g, w = g / scale, w / scale
        d = worst_abs_diff(g, w, ok)
        assert d <= tol, (k, d)
        # off the phase mask both packages write exactly 0
        np.testing.assert_array_equal(np.where(okx, 0.0, g), 0.0)


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_sweep_matches_jax_xla(name, props, collect):
    th, tm, jh, jm, mus = _inputs(name, 64 if name == "n31" else 48)
    got = TP.mu_sweep_thermo(th, tm, mus, props=props, collect=collect)
    want = JP.mu_sweep_thermo(jh, jm, mus, props=props, collect=collect, engine="xla")
    _check(got, want, props, 1e-12, rel=("u",) if name == "n1400" else ())
    n_ph = got["n_phases"].numpy()
    assert got["valid"].all() and (n_ph == 1).any() and (n_ph == 2).any()


@pytest.mark.parametrize("collect", [None, "janus"])
@pytest.mark.parametrize("props", [True, False])
def test_sweep_matches_k1_cpu_body(props, collect):
    th, tm, jh, jm, mus = _inputs("n31", 64)
    got = TP.mu_sweep_thermo(th, tm, mus, props=props, collect=collect)
    want = mu_sweep_thermo_ds(jh, jm, mus, props=props, mode="xla", collect=collect)
    _check(got, want, props, 1e-10)


def test_plain_chunks_agree(monkeypatch):
    """Chunking over points changes nothing: every point is independent."""
    th, tm, _, _, mus = _inputs("n573", 40)
    whole = TP.mu_sweep_thermo(th, tm, mus)
    monkeypatch.setattr(TP, "_PLAIN_CHUNK_ELEMS", 7 * tm.max_phases * th.nbins)
    chunked = TP.mu_sweep_thermo(th, tm, mus)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k


def test_most_stable_phase():
    th, tm, jh, jm, mus = _inputs("n31", 64)
    out = TP.mu_sweep_thermo(th, tm, mus)
    want = JP.most_stable_phase(np.asarray(out["fe"]), np.asarray(out["mask"]))
    np.testing.assert_array_equal(TP.most_stable_phase(out["fe"], out["mask"]).numpy(), np.asarray(want))


def test_no_hidden_cpu_path():
    """A CPU tensor never reaches the kernel: engine='cuda' raises, the
    launch counter stays 0, and engine='torch' equals 'auto' here."""
    th, tm, _, _, mus = _inputs("n31", 16)
    before = counters().get("launches.k1", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TP.mu_sweep_thermo(th, tm, mus, engine="cuda")
    a = TP.mu_sweep_thermo(th, tm, mus, engine="auto")
    b = TP.mu_sweep_thermo(th, tm, mus, engine="torch")
    assert counters().get("launches.k1", 0) == before == 0
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="engine"):
        TP.mu_sweep_thermo(th, tm, mus, engine="pallas")
    with pytest.raises(KeyError):
        TP.mu_sweep_thermo(th, tm, mus, collect="no-such-transform")


def test_package_imports_without_jax_triton_or_nvcc():
    """The port imports neither JAX nor the JAX package, and needs neither
    triton nor nvcc to import (kernels build at first launch)."""
    code = (
        "import sys, fhmcanalysis_torch, fhmcanalysis_torch.core.cuda_sweep;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fhmcanalysis_tpu', 'triton')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env, timeout=120)

