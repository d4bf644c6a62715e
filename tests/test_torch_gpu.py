"""PyTorch port on the card: the fused sweep kernel against the plain
version on the same card.  Imports no JAX, so it runs on the GPU machine:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(--noconftest: tests/conftest.py imports JAX, which that machine lacks.)

Segmentation fields must be equal; fe and the properties agree to 1e-10
absolute on valid masked slots (the JAX package's own kernel bar,
tests/test_pallas_sweep.py): the kernel sums in another order and uses
the card's f64 exp/log.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.state as TS
from torch_composites import SURFACE_KINDS, cell, janus_surfaces, random_surface, worst_abs_diff

SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU machine: python -m pytest -m gpu --noconftest tests/test_torch_gpu.py)")
    return torch.device("cuda", 0)


def _compare(h, meta, mus, props, collect):
    n0 = CS.sweep_thermo.launches
    got = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda")
    want = TP.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="torch")
    torch.cuda.synchronize()
    assert CS.sweep_thermo.launches == n0 + 1
    assert set(got) == set(want)
    for k in SEG:
        assert torch.equal(got[k], want[k]), k
    ok = (want["mask"] & want["valid"][:, None]).cpu()
    for k in ("fe",) + (PROPS if props else ()):
        assert worst_abs_diff(got[k].cpu(), want[k].cpu(), ok) <= 1e-10, k


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
@pytest.mark.parametrize("surface", range(4))
def test_kernel_janus_multipeak(cuda, surface):
    d, mk, _ = cell("n1400")
    h = TS.from_host(dict(d, lnpi=janus_surfaces(1400)[surface] * 10.0), device=cuda)
    _compare(h, TS.HistMeta(**mk), np.linspace(4.99, 5.01, 256), True, "janus")


@pytest.mark.gpu
def test_kernel_rejects_unsupported(cuda):
    d, mk, mus = cell("n31", 8)
    h = TS.from_host(d, device=cuda)
    with pytest.raises(ValueError, match="max_phases"):
        TP.mu_sweep_thermo(h, TS.HistMeta(**dict(mk, max_phases=9)), mus)
    with pytest.raises(TypeError, match="float64"):
        CS.sweep_thermo(h.lnpi.float(), h.op, h.mom[:2, 1, 0, 0, 0], h.volume, torch.zeros(3, dtype=torch.float64, device=cuda), 1, 4)
