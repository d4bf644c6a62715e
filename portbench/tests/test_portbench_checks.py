"""The check that decides ``correct``, shown to fail: the harness's whole
run on the CPU at small sizes (its look for a card skipped), with the
timed path broken underneath, and the float32 control in the program's
place."""

import time

import pytest
import torch
from conftest import BENCH, SMALL

from portbench import control, harness

SEED = 2**33 + 17


def run(name):
    return harness.run(name, SEED, 0.3, False, time.perf_counter(), device="cpu", overrides=SMALL[name], bench=BENCH)


def altered(fn, field):
    """fn with one answer altered where it is produced."""

    def wrapped(*a, **k):
        out = fn(*a, **k)
        v = out[field]
        v.view(-1)[0] = v.view(-1)[0] * (1 + 1e-6) + 1e-6
        return out

    return wrapped


def half_left_out(fn):
    """fn that computes the first half of its points and repeats it for the
    rest (a launch that covers half the batch)."""

    def wrapped(h, meta, mu, *a, **k):
        n = mu.shape[0] // 2
        out = fn(h, meta, mu[:n], *a, **k)
        return {key: torch.cat([v, v[: mu.shape[0] - n]]) for key, v in out.items()}

    return wrapped


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name, body, field", [("sw573.sweep", "mu_sweep_body", "fe"), ("sw573.sweep", "mu_sweep_body", "x_i"),
                                               ("bin31.mbsweep", "mu_beta_sweep_body", "fe"), ("bin31.mbsweep", "mu_beta_sweep_body", "left")])
def test_sweep_answer_altered(monkeypatch, name, body, field):
    from fhmcanalysis_torch.core import pipeline

    if field == "left":
        def alter(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                out["left"].view(-1)[0] += 1
                return out
            return wrapped
        monkeypatch.setattr(pipeline, body, alter(getattr(pipeline, body)))
    else:
        monkeypatch.setattr(pipeline, body, altered(getattr(pipeline, body), field))
    assert not run(name)["correct"]


def test_sweep_half_left_out(monkeypatch):
    from fhmcanalysis_torch.core import pipeline

    monkeypatch.setattr(pipeline, "mu_sweep_body", half_left_out(pipeline.mu_sweep_body))
    assert not run("sw573.sweep")["correct"]


def test_mbsweep_half_left_out(monkeypatch):
    from fhmcanalysis_torch.core import pipeline

    body = pipeline.mu_beta_sweep_body

    def half(h, meta, mu, *a, **k):
        n = len(mu) // 2
        out = body(h, meta, mu[:n], *a, **k)
        return {key: torch.cat([v, v[: len(mu) - n]]) for key, v in out.items()}

    monkeypatch.setattr(pipeline, "mu_beta_sweep_body", half)
    assert not run("bin31.mbsweep")["correct"]


@pytest.mark.parametrize("name", list(SMALL))
def test_float32_control_is_not_correct(name):
    """The plain reference in float32 put in the program's place fails the
    cell's check; the program passes it on the same draws."""
    over = dict(SMALL[name], check_calls=1)
    assert control.readings(name, SEED, "program", "cpu", over, BENCH)["correct"]
    assert not control.readings(name, SEED, "control", "cpu", over, BENCH)["correct"]
