"""Inputs and command line shared by the example workflows on the PyTorch port
(examples/torch_*.py).

Each workflow's ``run(inputs, device)`` takes its data either where the
JAX script reads it (a composite netCDF file, a directory of them, or a
window tree, the JAX script's path constant by default) or in memory: the
``read_composite`` dict, as ``histogram.from_composite`` takes it and a
patched window's ``to_composite()`` gives it.  Reading or writing a netCDF
file needs h5py; the in-memory form needs none.
"""

import argparse
import os
import re
import tempfile

from fhmcanalysis_torch.histogram.ntot import histogram
from fhmcanalysis_torch.win_patch import fhmc_equil, fhmc_patch

HERE = os.path.dirname(os.path.abspath(__file__))


def jax_data_path(script: str, name: str) -> str:
    """The path constant ``name`` of the JAX script ``script`` beside this
    file (the data the JAX workflow reads), from its source text: the JAX
    script imports JAX, which the port does not."""
    with open(os.path.join(HERE, script)) as f:
        return re.search(r'^%s = "([^"]*)"' % name, f.read(), re.M).group(1)


def parse_args(doc: str, default_data: str):
    """--device (default: the CUDA card) and --data (default: the JAX
    script's data path)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device of the workflow (default: the CUDA card)")
    ap.add_argument("--data", default=default_data, help="the workflow's data (default: %(default)s)")
    return ap.parse_args()


def load(source, beta_ref, mu_ref, smooth, device):
    """A histogram from a composite file or a ``read_composite`` dict."""
    if isinstance(source, dict):
        return histogram.from_composite(source, beta_ref, mu_ref, smooth=smooth, device=device)
    return histogram(source, beta_ref, mu_ref, smooth=smooth, device=device)


def load_patched(source, beta_ref, mu_ref, smooth, device, per_err, offset, patch_smooth=False):
    """A histogram of a window tree's composite: discover the windows, gate
    them on equilibration (trust=True), patch them into composite.nc in a
    temporary directory and load it, as the JAX scripts do; or of a
    composite already patched (a ``read_composite`` dict)."""
    if isinstance(source, dict):
        return load(source, beta_ref, mu_ref, smooth, device)
    with tempfile.TemporaryDirectory(prefix="fhmc_example_") as out:
        seq = fhmc_patch.get_patch_sequence(source)
        seq = fhmc_equil.test_nebr_equil(seq, per_err=per_err, fname=os.path.join(out, "maxEq"), trust=True)
        composite = os.path.join(out, "composite.nc")
        fhmc_patch.patch_all_windows(seq, out_fname=composite, log_fname=os.path.join(out, "patch.log"), offset=offset, smooth=patch_smooth)
        return load(composite, beta_ref, mu_ref, smooth, device)


def dmu2_sources(source):
    """{dMu_2: composite file or dict} of the simulations at one
    temperature, in the JAX scripts' order (the text order of the
    dMu2_<value> directory names); ``source`` is the temperature's
    directory or a {dMu_2: read_composite dict}."""
    if isinstance(source, dict):
        return {d: source[d] for d in sorted(source, key=lambda d: "dMu2_%.2f" % d)}
    names = sorted(x for x in os.listdir(source) if "dMu2" in x)
    return {float(n.split("_")[1]): os.path.join(source, n, "composite.nc") for n in names}
