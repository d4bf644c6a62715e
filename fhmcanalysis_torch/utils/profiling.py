"""Lightweight tracing and timing helpers.

The reference has no observability beyond prints (SURVEY §5); these wrap
torch.profiler for device traces and provide a wall-clock timer that
waits for the device, the counterparts of the JAX package's
``utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["trace", "Timer", "force_completion"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and, where there is one, the CUDA device over the
    block and write the timeline to ``logdir/trace.json`` (Chrome trace
    format, readable in Perfetto or TensorBoard); yields the
    ``torch.profiler.profile``, whose ``events()`` and ``key_averages()``
    are readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def force_completion(tree) -> None:
    """Wait until the work producing the tensors of a nested dict, list,
    tuple or dataclass (a Hist) is done: synchronise each CUDA device they
    lie on.  CPU tensors are complete when returned, so for them this does
    nothing."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating section timer with forced device completion."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            force_completion(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        force_completion(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = ["%-30s %10s %8s" % ("section", "total_s", "calls")]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append("%-30s %10.4f %8d" % (k, self.totals[k], self.counts[k]))
        return "\n".join(lines)
