"""Multi-device sharding of state-point grids over a list of devices.

The PyTorch port of the JAX package's ``parallel/mesh.py``.  The only axes
worth spreading across devices are the state-point grids: histograms are
small (10^2-10^4 bins) and go to every device whole, grids are large and
split.  The mesh keeps the JAX package's 2-D shape, axis "mu" (the mu_1
sweep axis) by axis "state" (the (beta, dMu) target axis), but it is a
plain grid of ``torch.device``s driven from one process: every sharded
function splits its grid into one contiguous block per device, runs the
port's single-device function on each block under that device, and joins
the results on the mesh's first device.  A device may appear more than
once (``grid_mesh(4, devices=["cuda:0"] * 4)`` is four shards of one card;
``["cpu"] * 8`` stands in for the JAX tests' eight virtual devices).

The JAX package returns a global array laid out over the mesh; here a
sharded result the functions do not join comes back as a list of per-device
blocks in mesh order (``shard_axis``, ``surface.py``).  Each shard runs its
single-device call on the card's current stream: on the sweeps, K3 and the
2-D device stages every shard's work is queued before the first result is
joined, so shards on distinct cards overlap; the solver and the 2-D host
back half synchronise inside each shard, and run one after another.  Where
the JAX package reduces across the mesh with an all-gather (``_global_min``,
a workaround for the TPU compiler's missing MIN all-reduce), the port takes
one ``torch.min`` over the per-shard minima.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import pipeline as _pipeline
from ..core import solve as _solve
from ..core.state import Hist, HistMeta, _device

__all__ = [
    "GridMesh",
    "grid_mesh",
    "sharded_mu_beta_sweep",
    "sharded_make_grid",
    "sharded_joint_state_sweep",
    "sharded_pore_state_sweep",
    "shard_map_mu_sweep",
    "sharded_trace_coexistence",
    "replicate",
    "shard_axis",
]


class GridMesh:
    """A 2-D ("mu", "state") grid of torch devices.

    devices    : numpy object array [a, b] of torch.device
    axis_names : ("mu", "state")
    shape      : {"mu": a, "state": b}, read as JAX code reads mesh.shape[name]
    """

    axis_names = ("mu", "state")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size < 1:
            raise ValueError(f"a mesh is a non-empty [a, b] grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """Every device of the mesh in mesh order (both axes flattened)."""
        return list(self.devices.ravel())

    def axis_devices(self, axis_name: str) -> list:
        """The devices along one mesh axis (the first row or column)."""
        if axis_name == "mu":
            return list(self.devices[:, 0])
        if axis_name == "state":
            return list(self.devices[0, :])
        raise ValueError(f"axis_name must be one of {self.axis_names}, got {axis_name!r}")

    def __repr__(self):
        return f"GridMesh({self.shape}, devices={[str(d) for d in self.device_list()]})"


def _indexed(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device with its index written out."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def grid_mesh(n_devices: int | None = None, devices=None) -> GridMesh:
    """Build a 2-D ("mu", "state") mesh over the given or available devices.

    Factors n into the most-square (a, b) split so both grid axes scale.
    devices=None means every CUDA device, and raises where there is none
    (the port never falls back to the CPU by itself); a list may name a
    device more than once.
    """
    if devices is None:
        _device(None)  # raises without a CUDA device
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices}: the mesh takes 1 to {len(devices)} of the devices given")
    a = int(np.floor(np.sqrt(n_devices)))
    while n_devices % a:
        a -= 1
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return GridMesh(grid.reshape(a, n_devices // a))


def _on(device):
    """The context a shard runs in: its card made current, or nothing on
    the CPU (or for no device)."""
    return torch.cuda.device(device) if device is not None and device.type == "cuda" else contextlib.nullcontext()


def _to(h: Hist, device) -> Hist:
    """``h`` with every tensor on ``device`` (itself where they are there already)."""
    return Hist(**{f: getattr(h, f).to(device) for f in h.__dataclass_fields__})


def _put(tree, device):
    """A Hist, tensor, numpy array, or a dict / tuple / list of them, on ``device``."""
    if isinstance(tree, Hist):
        return _to(tree, device)
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, dict):
        return {k: _put(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_put(v, device) for v in tree)
    return tree


def replicate(mesh: GridMesh, tree) -> list:
    """One copy of ``tree`` per mesh device, in mesh order: a port Hist, a
    tensor, a numpy array, or a dict / tuple / list of them.  A device named
    more than once gets one copy, shared by its entries."""
    copies = {}
    out = []
    for d in mesh.device_list():
        if d not in copies:
            copies[d] = _put(tree, d)
        out.append(copies[d])
    return out


def _blocks(x, n: int) -> list:
    """The leading axis of ``x`` (tensor or array-like) in n contiguous
    blocks of np.array_split's sizes (the first len % n one longer); empty
    blocks are dropped, but one block is always returned."""
    if torch.is_tensor(x):
        parts = list(torch.tensor_split(x, n))
    else:
        parts = np.array_split(np.asarray(x), n)
    return [p for p in parts if len(p)] or parts[:1]


def shard_axis(mesh: GridMesh, x, axis_name: str) -> list:
    """The leading axis of ``x`` in contiguous blocks, one per device along
    the named mesh axis, each on its device (mesh order).  The list is the
    port's stand-in for the JAX package's array sharded over that axis and
    replicated over the other."""
    devs = mesh.axis_devices(axis_name)
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return [b.to(d) for b, d in zip(_blocks(x, len(devs)), devs)]


def _gather(mesh: GridMesh, parts: list):
    """Per-shard tensors, or dicts of them, concatenated along the leading
    axis on the mesh's first device (one part is returned as it is)."""
    dev = mesh.device_list()[0]

    def cat(ts):
        return ts[0].to(dev) if len(ts) == 1 else torch.cat([t.to(dev) for t in ts])

    if isinstance(parts[0], dict):
        return {k: cat([p[k] for p in parts]) for k in parts[0]}
    return cat(parts)


def _global_min(mesh: GridMesh, mins: list) -> torch.Tensor:
    """The minimum of per-shard scalars, on the mesh's first device."""
    dev = mesh.device_list()[0]
    return torch.min(torch.stack([m.to(dev) for m in mins]))


def _fe_min(out: dict) -> torch.Tensor:
    """The least free energy over a sweep's real phases (+inf without one)."""
    return torch.where(out["mask"], out["fe"], torch.inf).min()


def _check_divisible(n: int, mesh: GridMesh, what: str) -> None:
    if n % mesh.size:
        raise ValueError("%s length %d not divisible by %d devices" % (what, n, mesh.size))


def _f64(x) -> torch.Tensor:
    """``x`` as a float64 tensor (a tensor stays on its device)."""
    return x.to(torch.float64) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, dtype=np.float64))


def _per_shard(mesh: GridMesh, h: Hist, grid, run) -> list:
    """run(h on d, block on d) for each device d and its block of ``grid``'s
    leading axis, each under its device, every shard queued before any
    result is read."""
    x = _f64(grid)
    devs = mesh.device_list()
    out = []
    for d, hd, xb in zip(devs, replicate(mesh, h), _blocks(x, len(devs))):
        with _on(d):
            out.append(run(hd, xb.to(d)))
    return out


def shard_map_mu_sweep(mesh: GridMesh, h: Hist, meta: HistMeta, mu_grid, props: bool = True, engine: str = "auto"):
    """The mu_1 sweep with the grid split over every mesh device.

    Each device runs pipeline.mu_sweep_thermo on its contiguous mu_1 block
    (kernel K1 on a card, the plain version on the CPU; ``engine`` as
    there); returns (outputs joined on the mesh's first device, the global
    minimum free energy over real phases).  mu_grid's length must be
    divisible by the device count.
    """
    mu = mu_grid if torch.is_tensor(mu_grid) else np.asarray(mu_grid)
    _check_divisible(len(mu), mesh, "mu grid")
    outs = _per_shard(mesh, h, mu, lambda hd, mb: _pipeline.mu_sweep_thermo(hd, meta, mb, props=props, engine=engine))
    mins = [_fe_min(o) for o in outs]
    return _gather(mesh, outs), _global_min(mesh, mins)


def sharded_mu_beta_sweep(
    mesh: GridMesh,
    h: Hist,
    meta: HistMeta,
    mu_grid,
    beta_grid,
    dmu_grid,
    order: int = 1,
    props: bool = True,
    engine: str = "auto",
):
    """One sharded (mu_1, beta, dMu) sweep plus the global min free energy.

    The mu_1 grid is split into contiguous blocks over every mesh device
    (both axes flattened, as the JAX package's SPMD kernel arm lays it
    out); each device runs pipeline.mu_beta_sweep_thermo on its block
    against every target (kernel K2's product mode on a card, the plain
    version on the CPU).  Each point's arithmetic does not depend on its
    block, so one layout serves every engine.  Returns (outputs with [M, A]
    leading axes joined on the mesh's first device, the global minimum
    free energy over real phases).  engine: "auto" | "torch" | "cuda"
    (pipeline.mu_beta_sweep_thermo), or the JAX package's "pallas", which
    means the kernel ("cuda").
    """
    engine = "cuda" if engine == "pallas" else engine
    outs = _per_shard(
        mesh, h, mu_grid,
        lambda hd, mb: _pipeline.mu_beta_sweep_thermo(hd, meta, mb, beta_grid, dmu_grid, order=order, props=props, engine=engine),
    )
    mins = [_fe_min(o) for o in outs]
    return _gather(mesh, outs), _global_min(mesh, mins)


def sharded_trace_coexistence(
    mesh: GridMesh,
    h: Hist,
    meta: HistMeta,
    betas,
    mu_guess,
    lnZ_tol: float = 1.0e-5,
    dmu=None,
    order: int = 1,
    min_width: int = 0,
):
    """Phase-diagram tracing over the mesh: the temperatures are split into
    contiguous blocks over every device (both axes flattened), and each
    device runs solve.trace_coexistence on its block (K2's paired mode on a
    card, K1 where nothing is extrapolated; the plain versions on the CPU).

    Solves are independent per temperature, so a shard gives the mu* the
    whole trace gives.  A mu_guess or dmu given per temperature is split
    with the temperatures.  Each shard's Nelder-Mead tests for its end on
    the host, so the shards run one after another.  Returns
    trace_coexistence's dict joined along beta on the mesh's first device.
    """
    b = torch.atleast_1d(_f64(betas))
    T = b.shape[0]
    _check_divisible(T, mesh, "beta grid")

    def per_beta(v, ndim_one):
        """v's blocks where it holds one value per temperature, else v for every shard."""
        if v is None:
            return None
        t = _f64(v)
        if t.dim() == ndim_one and t.shape[0] == T and T > 1:
            return _blocks(t, mesh.size)
        return None

    guesses, dmus = per_beta(mu_guess, 1), per_beta(dmu, 2)
    devs = mesh.device_list()
    outs = []
    for i, (d, hd, bb) in enumerate(zip(devs, replicate(mesh, h), _blocks(b, len(devs)))):
        with _on(d):
            outs.append(_solve.trace_coexistence(
                hd, meta, bb.to(d), guesses[i].to(d) if guesses else mu_guess, lnZ_tol=lnZ_tol,
                dmu=dmus[i].to(d) if dmus else dmu, order=order, min_width=min_width,
            ))
    return _gather(mesh, outs)


def sharded_make_grid(mesh: GridMesh, iso, mu1_bounds, dmu2_bounds, delta, m=2.5, mu1_chunk=None, engine="auto", collect=None):
    """Isopleth surface with the mu_1 grid axis split over every mesh device
    (both axes flattened): isopleth.make_grid(mesh=...).  The bracket runs
    once on the host; each device evaluates its contiguous column block of
    cells (kernel K3 on a card, the plain version on the CPU).  Cells are
    independent along mu_1, so the surface is the single-device one."""
    return iso.make_grid(mu1_bounds, dmu2_bounds, delta, m=m, mu1_chunk=mu1_chunk, mesh=mesh, engine=engine, collect=collect)


def sharded_pore_state_sweep(
    mesh: GridMesh, joint_hist, fh, p_vals, beta_vals, A, nnebr=1, max_peaks=10,
    segment_engine="auto", return_surfaces=True,
):
    """Slit-pore (p, beta) state sweep with the state axis S split over every
    mesh device: two_dim.pore_state_sweep(mesh=...).  Each device runs the
    single-device sweep on its block of states; states are independent, so
    the outputs are the single-device sweep's."""
    from ..two_dim.pore_pipeline import pore_state_sweep

    return pore_state_sweep(
        joint_hist, fh, p_vals, beta_vals, A, nnebr=nnebr, max_peaks=max_peaks, mesh=mesh,
        segment_engine=segment_engine, return_surfaces=return_surfaces,
    )


def sharded_joint_state_sweep(
    mesh: GridMesh, joint_hist, beta, mu_ref, mu_targets, nnebr=1, max_peaks=10,
    segment_engine="auto", return_surfaces=True,
):
    """Joint (N_1, N_tot) GC state sweep with the (mu_1, mu_2) target axis S
    split over every mesh device: two_dim.joint_state_sweep(mesh=...), the
    contract of sharded_pore_state_sweep."""
    from ..two_dim.joint_pipeline import joint_state_sweep

    return joint_state_sweep(
        joint_hist, beta, mu_ref, mu_targets, nnebr=nnebr, max_peaks=max_peaks, mesh=mesh,
        segment_engine=segment_engine, return_surfaces=return_surfaces,
    )
