"""PyTorch port: histogram state carry-over against the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.state as JS
from torch_composites import CELLS, make_composite

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_to_host_from_host_roundtrip(name):
    """JAX to_host -> port from_host -> port to_host is the identity."""
    d = make_composite(**CELLS[name])
    jd = JS.to_host(JS.make_hist(**d))
    h = TS.from_host(jd, device="cpu")
    back = TS.to_host(h)
    assert back.keys() == jd.keys()
    for k, v in jd.items():
        if isinstance(v, float):
            assert isinstance(back[k], float) and back[k] == v, k
        else:
            assert back[k].dtype == np.float64 and back[k].shape == v.shape, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    for f in dataclasses.fields(h):
        t = getattr(h, f.name)
        assert t.dtype == torch.float64 and t.device == h.device, f.name


def test_histmeta_mirrors_jax():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JS.HistMeta)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(TS.HistMeta)]
    assert tf == jf
    for kw in (dict(nspec=1, max_order=2), dict(nspec=2, max_order=3, smooth=10, max_phases=4, used_ke=True)):
        jm, tm = JS.HistMeta(**kw), TS.HistMeta(**kw)
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        assert (jm.mo1, jm.n_addr, jm.mom_shape(7)) == (tm.mo1, tm.n_addr, tm.mom_shape(7))
        assert hash(tm) == hash(TS.HistMeta(**kw))


def test_hist_device_replace_nbins():
    d = make_composite(**CELLS["n31"])
    h = TS.make_hist(d["lnpi"], d["mom"], d["op"], d["curr_mu"], d["curr_beta"], d["volume"], device="cpu")
    assert h.device == torch.device("cpu") and h.nbins == 31
    h2 = h.replace(lnpi=h.lnpi * 2)
    assert torch.equal(h2.lnpi, h.lnpi * 2) and h2.mom is h.mom
    with pytest.raises(dataclasses.FrozenInstanceError):
        h.lnpi = h.op


def test_default_device_is_the_card(monkeypatch):
    """With no device the port goes to CUDA; where there is none it raises
    and names device='cpu' instead of carrying on on the CPU."""
    d = make_composite(**CELLS["n31"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.from_host(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.make_hist(d["lnpi"], d["mom"], d["op"], d["curr_mu"], d["curr_beta"], d["volume"])
    h = TS.from_host(d, device="cpu")
    assert h.device == torch.device("cpu") and h.mom.device == h.device
