"""Joint 2-D histogram container: lnPI(op_1, op_2) from ragged slices.

Behavioral parity target: the reference's moments/histogram/two_dim/
joint_hist.pyx:22-301 (the entry container, ragged assembly onto a
padded rectangle, and the JSON persistence format).  The format is a
contract — the padded surface layout, per-row bounds indices, and JSON
schema are consumed by pore_hist, the device sweeps, and the phase
organizer — but the implementation here is its own: assembly is one
vectorized searchsorted scatter per slice instead of the reference's
O(rows x cols) ``list.index`` scan, and assembled state is invalidated
whenever a slice is added so a made-then-modified histogram can never
be swept stale.

The PyTorch port's copy of the JAX package's ``two_dim/joint_hist.py``
(host-only numpy; same class, keys, JSON format and assertion messages).
"""

from __future__ import annotations

import copy
import json

import numpy as np

__all__ = ["joint_hist"]

# keys make() derives from the entries; dropped whenever entries change
_ASSEMBLED_KEYS = ("ln(PI)", "op_1", "op_2", "bounds_idx", "props")


class joint_hist(object):
    """Ragged-slice joint histogram (joint_hist.pyx:145-301 behavior).

    Slices of lnPI(op_2) at fixed op_1 accumulate via add()/enter();
    make() assembles them onto one padded [H, N] surface with -inf fill
    for cells no slice covers, per-row [min, max] column bounds, and a
    padded surface per property.  The device sweeps (joint_pipeline,
    pore_pipeline) treat a made histogram as read-only; adding a slice
    after make() drops the assembled arrays so the next sweep re-makes.
    """

    class entry(object):
        """One lnPI(op_2) slice plus its named property vectors.

        All vectors in a slice must share one length, and op_vals must
        be sorted ascending (joint_hist.pyx:28-143 invariants).
        """

        def __init__(self):
            self.clear_all()

        def clear_all(self):
            self.data = {}

        def clear_props(self):
            self.data["props"] = {}

        def set(self, lnpi, op_vals, name_val_dict):
            self.set_lnpi(lnpi, op_vals)
            for p in name_val_dict:
                self.set_prop(p, name_val_dict[p])

        def set_lnpi(self, lnpi, op_vals):
            assert len(op_vals) == len(lnpi), "Size mismatch between ln(PI) and order parameters"
            self.data["ln(PI)"] = np.array(lnpi, dtype=np.float64)
            assert np.all(sorted(op_vals) == np.asarray(op_vals)), "Order parameter values are not sorted"
            self.data["op_vals"] = np.array(op_vals, dtype=np.float64)
            if "props" in self.data:
                for x in self.data["props"]:
                    assert self._check_size(self.data["props"][x]), (
                        "Size of existing properties vectors is different from new ln(PI)"
                    )

        def set_prop(self, name, val):
            assert self._check_size(val), "Size of new property vector is different from existing ones"
            if "props" not in self.data:
                self.data["props"] = {}
            self.data["props"][name] = val

        def _check_size(self, x):
            """Length agreement against whichever vector exists first."""
            if "ln(PI)" in self.data:
                ref_size = len(self.data["ln(PI)"])
            elif "op_vals" in self.data:
                ref_size = len(self.data["op_vals"])
            elif "props" in self.data and len(self.data["props"]) > 0:
                first = next(iter(self.data["props"]))
                ref_size = len(self.data["props"][first])
            else:
                ref_size = len(x)
            return len(x) == ref_size

    def __init__(self):
        self.clear()

    def clear(self):
        self.data = {}

    def add(self, op1, entry):
        """Store a (deep-copied) slice at op_1 (joint_hist.pyx:163-178).

        Any previously assembled surface is invalidated: make() output
        must always reflect the current entries, and the sweeps use
        the presence of 'ln(PI)' as the "already made" signal.
        """
        if "entries" not in self.data:
            self.data["entries"] = {}
        self.data["entries"][op1] = copy.deepcopy(entry)
        for k in _ASSEMBLED_KEYS:
            self.data.pop(k, None)

    def enter(self, op1, lnpi, op_vals, name_val_dict):
        """add() from raw arrays (joint_hist.pyx:180-199)."""
        e = self.entry()
        e.set(lnpi, op_vals, name_val_dict)
        self.add(op1, e)

    def make(self):
        """Assemble the padded joint surface (joint_hist.pyx:201-247
        output contract).

        Rows are the sorted op_1 values, columns the sorted union of
        every slice's op_2 values.  Cells no slice covers read -inf in
        ln(PI) and 0 in each property; bounds_idx[row] holds the
        [first, last] covered column.  Each slice lands via one
        searchsorted + fancy-index scatter (columns are exact members
        of the union, so searchsorted is an exact lookup; duplicate
        op_2 values within a slice resolve to the last occurrence,
        matching serial overwrite order).
        """
        op1_vals = sorted(self.data["entries"])
        entries = [self.data["entries"][x].data for x in op1_vals]
        op2_vals = np.unique(np.concatenate([e["op_vals"] for e in entries]))
        H, N = len(op1_vals), len(op2_vals)

        lnpi = np.full((H, N), -np.inf, dtype=np.float64)
        bounds = np.zeros((H, 2), dtype=np.int64)
        prop_names = sorted(entries[0]["props"]) if entries else []
        props = {p: np.zeros((H, N), dtype=np.float64) for p in prop_names}

        for j, e in enumerate(entries):
            cols = np.searchsorted(op2_vals, e["op_vals"])
            lnpi[j, cols] = e["ln(PI)"]
            bounds[j] = [cols.min(), cols.max()]
            assert sorted(e["props"]) == prop_names, "Properties are not all the same, or some are missing"
            for p in prop_names:
                props[p][j, cols] = e["props"][p]

        self.data["ln(PI)"] = lnpi
        self.data["op_1"] = np.array(op1_vals, dtype=np.float64)
        self.data["op_2"] = np.asarray(op2_vals, dtype=np.float64)
        self.data["bounds_idx"] = bounds
        self.data["props"] = props

    def to_json(self, fname):
        """Persist the assembled surface (joint_hist.pyx:249-270 JSON
        schema: indent=4, sorted keys, entries excluded)."""
        obj = {k: v for k, v in self.data.items() if k != "entries"}
        out = {
            "ln(PI)": np.asarray(obj["ln(PI)"]).tolist(),
            "op_1": np.asarray(obj["op_1"]).tolist(),
            "op_2": np.asarray(obj["op_2"]).tolist(),
            "bounds_idx": np.asarray(obj["bounds_idx"]).tolist(),
            "props": {p: np.asarray(v).tolist() for p, v in obj["props"].items()},
        }
        with open(fname, "w") as f:
            json.dump(out, f, indent=4, sort_keys=True)

    def from_json(self, fname):
        """Load an assembled surface (joint_hist.pyx:272-301), replacing
        all current state."""
        self.clear()
        with open(fname, "r") as f:
            raw = json.load(f)

        for key in ("ln(PI)", "op_1", "op_2", "bounds_idx", "props"):
            assert key in raw, "Missing %s information" % key

        self.data["ln(PI)"] = np.array(raw["ln(PI)"], dtype=np.float64)
        self.data["op_1"] = np.array(raw["op_1"], dtype=np.float64)
        self.data["op_2"] = np.array(raw["op_2"], dtype=np.float64)
        self.data["bounds_idx"] = np.array(raw["bounds_idx"], dtype=np.float64)
        self.data["props"] = {p: np.array(v, dtype=np.float64) for p, v in raw["props"].items()}
