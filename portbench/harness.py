"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell, configuration, entry or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives:

* ``workloads/<cell>.json``: the entry, the traffic parameters, the
  calls the check samples, the calls the trace covers and the limits of
  the numbers that decide ``correct``;
* the configuration's file (``BENCHMARK.json`` ``configs[].file``);
* ``entries/<entry>.py``: set-up, the per-call draw from the seed, the
  timed call, its work and its check against the plain reference;
* ``metrics/<metric>.py``: each metric's reader, ``read(ctx)``, which
  returns a number or None where the run holds nothing to read, and, for
  a metric read from the program's counters, ``counters()``: name ->
  a function that reads one, which the harness reads around every call.

A run: set-up (the seed's composites on the card, the program's kernels
loaded, the cell's shapes warmed), then calls back to back for the
window's seconds, each ending once its outputs are complete, a closed
loop of one client; then the check of a sample of the window's calls
against the reference, and one JSON line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fhmcanalysis_tpu")  # top-level module names no run may load


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def module(kind: str, name: str) -> types.ModuleType:
    """portbench/<kind>/<name>.py, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} file {path.relative_to(REPO)} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries that a cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return e2e, layer


class Cell:
    """A workload of BENCHMARK.json with its files resolved by name."""

    def __init__(self, name: str, bench: dict | None = None, overrides: dict | None = None):
        bench = benchmark() if bench is None else bench
        spec = next((w for w in bench["workloads"] if w["name"] == name), None)
        if spec is None:
            raise LookupError(f"BENCHMARK.json has no workload {name!r}")
        cfg_spec = next(c for c in bench["configs"] if c["name"] == spec["config"])
        self.name, self.spec = name, spec
        self.cfg = read_json(REPO / cfg_spec["file"])
        self.wl = read_json(HERE / "workloads" / f"{name}.json")
        for key, value in (overrides or {}).items():  # smaller sizes for the CPU tests
            (self.cfg if key in self.cfg else self.wl)[key] = value
        self.entry = module("entries", self.wl["entry"])
        self.e2e, self.layer = metrics_of(bench, name)
        self.readers = {m["name"]: module("metrics", m["name"]) for m in self.e2e + self.layer}


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def _counters(cell: Cell) -> dict:
    out = {}
    for reader in cell.readers.values():
        out.update(getattr(reader, "counters", dict)())
    return out


def _window(cell: Cell, st: dict, seed: int, seconds: float, trace: bool, cuda: bool):
    """Calls back to back for seconds, on the host's clock (every entry's
    call ends once its outputs are complete); returns (calls, kept,
    traced, profile, window_s).  kept: a reservoir of check_calls (index,
    params, outputs) drawn from the seed; traced: the first trace_calls
    calls' params and what their rooflines keep, under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    entry, wl = cell.entry, cell.wl
    rng, pick = _rng(seed, 1), _rng(seed, 3)
    K, n_trace = wl["check_calls"], wl["trace_calls"] if trace else 0
    calls, kept, traced = [], [], []
    counters = _counters(cell)
    prof = window_range = None
    if n_trace:
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        window_range = record_function("portbench.window")
        window_range.__enter__()
    t0 = time.perf_counter()
    while True:
        i = len(calls)
        p = entry.draw(st, rng)
        args = entry.make(st, p)
        c0 = {k: f() for k, f in counters.items()}
        if i < n_trace:
            with record_function("portbench.call"):
                out = entry.call(st, args)
            traced.append({"p": p, "keep": entry.keep(st, out)})
        else:
            out = entry.call(st, args)
        calls.append({"p": p, "work": entry.work(st, p, out), "counters": {k: f() - c0[k] for k, f in counters.items()}})
        if i < K:
            kept.append((i, p, out))
        else:
            j = int(pick.integers(0, i + 1))
            if j < K:
                kept[j] = (i, p, out)
        del out, args
        if i + 1 == n_trace:
            window_range.__exit__(None, None, None)
            prof.stop()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if prof is not None and len(calls) < n_trace:
        window_range.__exit__(None, None, None)
        prof.stop()
    return calls, kept, traced, prof, window_s


class Trace:
    """What the per-layer readers take from the profiler: the traced
    window, the device's operations in it and the host's."""

    def __init__(self, prof):
        dev, host, self.t0, self.t1 = [], [], None, None
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name == "portbench.window" and e.device_type.name == "CPU":
                self.t0, self.t1 = a, b
            elif e.name.startswith("portbench."):
                if e.device_type.name == "CPU":
                    host.append((e.name, a, b))
            elif e.device_type.name == "CUDA":
                dev.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
        if self.t0 is None:
            raise RuntimeError("the profiler recorded no window")
        self.ops = sorted((n, max(a, self.t0), min(b, self.t1)) for n, a, b in dev if b > self.t0 and a < self.t1)
        self.host = host
        self.window_s = (self.t1 - self.t0) / 1e6
        merged = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e6

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name match() accepts."""
        return sum(b - a for n, a, b in self.ops if match(n)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window, summed by the innermost
        host operation under way at each gap's middle ("portbench.call":
        the entry's own Python between torch operations; "portbench.window":
        the harness between calls)."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
        host = sorted(self.host, key=lambda h: h[1])
        starts = np.array([h[1] for h in host])
        ends = np.array([h[2] for h in host])
        span = ends - starts
        tot = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            hi = int(np.searchsorted(starts, mid, side="right"))
            inside = np.nonzero(ends[:hi] >= mid)[0]
            name = host[inside[np.argmin(span[inside])]][0] if len(inside) else "portbench.window"
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda", overrides: dict | None = None, bench: dict | None = None) -> dict:
    """One run of cell name; returns the result line's object."""
    import torch

    cell = Cell(name, bench, overrides)
    entry, wl = cell.entry, cell.wl
    cuda = device.startswith("cuda")
    st = entry.setup(cell.cfg, wl, seed, torch.device(device))
    # warm calls of the cell's own shapes, their outputs held together so
    # that the allocator already caches as many calls' outputs as the
    # window keeps for the check (warm_calls > check_calls), and every
    # kernel the window's bookkeeping launches is loaded
    warm, held = _rng(seed, 2), []
    for _ in range(wl["warm_calls"]):
        p = entry.draw(st, warm)
        out = entry.call(st, entry.make(st, p))
        entry.work(st, p, out)
        entry.keep(st, out)
        held.append(out)
    del held
    if cuda:
        torch.cuda.synchronize()
    # the set-up's objects (torch's, the program's, the composites) out of
    # the collector's reach: a collection in the window walks only what the
    # window's own calls made, however large the set-up's heap is
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    calls, kept, traced, prof, window_s = _window(cell, st, seed, seconds, trace, cuda)
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = Trace(prof) if prof is not None and cuda else None
    prof = None
    if cuda:
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(cell=cell, cfg=cell.cfg, wl=wl, entry=entry, state=st, setup_s=setup_s, window_s=window_s, calls=calls, traced=traced, trace=tr)
    metrics = {}
    for m in cell.layer if trace else cell.e2e:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    traced.clear()

    numbers = {}
    for _, p, out in kept:
        for k, v in entry.check(st, p, out).items():
            numbers[k] = max(numbers.get(k, v), v)
    limits = wl["limits"]
    correct = bool(kept) and set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}

    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": cell.spec["chips"],
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": sum(c["work"]["attempted"] for c in calls), "failed": sum(c["work"]["failed"] for c in calls),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["calls"] = len(calls)
    result["checks"] = checks
    return result


def loaded_forbidden() -> list:
    """The forbidden top-level module names this process has loaded,
    compared whole (fhmcanalysis_torch is not fhmcanalysis_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: list, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = Cell(args.workload).spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import fhmcanalysis_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}, which no run may import", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
