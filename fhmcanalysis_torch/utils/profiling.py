"""The port's tracing: a profiler window, spans at its layer boundaries,
and counters.

``trace(logdir)`` profiles the host and the CUDA device over a block and
writes the timeline for Perfetto.  ``span(name)`` marks a range of host
time inside the program (``fhmc.entry.*`` a whole call, then
``fhmc.prologue.*``, ``fhmc.launch.*``, ``fhmc.post.*``, ``fhmc.solver.*``
inside it); ``counters()`` is a snapshot of the program's counts since the
process started (kernel launches, host syncs, solver steps, the kernel
libraries' load and build seconds, the package's import seconds).

A span records only while a torch profiler is recording: otherwise it is
one shared no-op, and its cost one flag read.  It records a CPU range on
the profiler's own clock, not a user annotation, so the profiler mirrors
nothing of it onto the device's timeline: the device's operations stay
the kernels and copies alone, and every idle gap between them falls inside
the spans the host was in.  A counter is one dict add under a lock,
always on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch

__all__ = ["trace", "span", "spanned", "add", "counters"]

_recording = torch._C._autograd._profiler_enabled
# a CPU range of the RecordFunction machinery, as torch's own operators
# record; record_function's ranges are user annotations, which the
# profiler copies onto the device's timeline
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_counts: dict = {}
_adding = threading.Lock()  # kernel libraries may load on several threads at once


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and, where there is one, the CUDA device over the
    block and write the timeline to ``logdir/trace.json`` (Chrome trace
    format, readable in Perfetto or TensorBoard); yields the
    ``torch.profiler.profile``, whose ``events()`` and ``key_averages()``
    are readable after the block.  The program's spans appear as
    ``fhmc.*`` ranges on the host's thread."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name: str):
    """A context manager that records the block as the host range ``name``
    while a profiler records, and does nothing otherwise."""
    return _Range(name) if _recording() else _OFF


def spanned(name: str):
    """Decorator: every call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def add(name: str, n=1) -> None:
    """Add n to the counter ``name``."""
    with _adding:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter: name -> its total in this process.

    ``launches.k1`` / ``k2`` / ``k3``: kernel launches; ``launches.k2_xarea``:
    K2's launches that formed x' once into its shared-memory area;
    ``launches.k2_tile``: those of them that also formed their targets'
    key' once, in blocks of 8 targets x 8 mu values;
    ``launches.mb_rows``: the row former's launches; ``launches.b2d``: the
    2-D boundary integrals kernel's launches (one a 2-D sweep on the card,
    and one more where the tie fallback runs); ``host_syncs``:
    reads of a tensor's value back to the host by the program's own code;
    ``solver.steps``: Nelder-Mead steps; ``iso.cells``: the cells of the
    grids ``isopleth.make_grid`` evaluates; ``kernel.loads`` /
    ``kernel.load_s``: kernel libraries loaded and checked, and the seconds
    that took; ``kernel.builds`` / ``kernel.build_s``: the same for their
    nvcc builds; ``setup.import_s``: seconds to import the package (torch
    already imported).  A counter nothing has moved is absent."""
    with _adding:
        return dict(_counts)
