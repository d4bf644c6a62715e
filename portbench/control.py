"""Readings that the limits of ``correct`` are set from, at a cell's own
sizes:

    python portbench/control.py --workload <cell> --seeds 1,2,3 --side control
    python portbench/control.py --workload <cell> --seeds 1,...,12 --side program

For each seed, the cell's set-up and the first check_calls draws of its
traffic; then per draw either the program's call (side program: the lower
readings) or the plain reference computed in float32 put in the
program's place (side control: the configuration states float64, and
float32 is the step below it; the upper readings), each judged by the
cell's own check against the reference in float64.  Prints one JSON line
per seed with the worst of each number over its draws.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def readings(name: str, seed: int, side: str, device: str = "cuda", overrides: dict | None = None, bench: dict | None = None) -> dict:
    import torch

    cell = harness.Cell(name, bench, overrides)
    entry, wl = cell.entry, cell.wl
    st = entry.setup(cell.cfg, wl, seed, torch.device(device))
    rng = harness._rng(seed, 1)
    draws = [entry.draw(st, rng) for _ in range(wl["check_calls"])]
    numbers = {}
    for p in draws:
        out = entry.call(st, entry.make(st, p)) if side == "program" else entry.reference(st, p, torch.float32)
        for k, v in entry.check(st, p, out).items():
            numbers[k] = max(numbers.get(k, v), v)
        del out
    limits = wl["limits"]
    return {"workload": name, "seed": seed, "side": side, "numbers": numbers,
            "correct": all(numbers[k] <= limits[k] for k in limits), "limits": limits}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--side", choices=("program", "control"), required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), args.side)
        r["seconds"] = time.perf_counter() - t
        r["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
