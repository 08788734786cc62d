"""The port's fault-tolerance planners against the reference's, on the same
inputs: ``StepTimer``, ``FleetMonitor``, ``plan_rescale`` and
``plan_serve_rescale`` give the same outputs and raise for the same
impossible fleets, and ``FleetServeMonitor.report`` on plain callables
gives the reference's report.  Pure Python on both sides."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.ft import elastic as ref_elastic
from repro.ft import straggler as ref_straggler
from repro.serve.runtime import FleetServeMonitor as RefFleetServeMonitor
from repro_torch.ft import elastic, straggler
from repro_torch.serve import FleetServeMonitor

CFGS = [dict(), dict(window=16, z_thresh=4.0), dict(warmup=0, baseline_min=2, recent=3),
        dict(window=8, trend_thresh=1.2, min_ratio=1.1, baseline_alpha=0.2)]


def timer_trace(mod, cfg: dict, xs) -> list:
    """Everything a timer reports after each record."""
    t = mod.StepTimer(mod.StragglerConfig(**cfg))
    out = []
    for x in xs:
        t.record(x)
        out.append((t.baseline, list(t.times), t.is_straggling(), t.recommendation()))
    return out


def fleet_trace(mod, cfg: dict, rows) -> list:
    m = mod.FleetMonitor(len(rows[0]), mod.StragglerConfig(**cfg))
    out = []
    for row in rows:
        for w, x in enumerate(row):
            m.record(w, x)
        out.append((m.stragglers(), m.recommendations()))
    return out


# the step-time sequences of the reference's own straggler tests
CASES = {
    "compile_spike": [5.0, 5.0, 4.0, 3.0] + [0.1] * 20 + [0.5] * 8,
    "warmup_only": [100.0] * 4 + [1.0] * 8,
    "gradual": [1.0] * 12 + [1.0 + 2.0 * i / 60 for i in range(1, 61)],
    "benign_drift": [1.0] * 12 + [1.0 + 0.2 * i / 300 for i in range(1, 301)],
    "substrate": [1.0 + np.random.default_rng(0).normal() * 0.01] * 16 + [3.0] * 8,
}


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_timer_cases(case, cfg):
    xs = CASES[case]
    assert timer_trace(straggler, cfg, xs) == timer_trace(ref_straggler, cfg, xs)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cfg", CFGS)
def test_step_timer_seeded(seed, cfg):
    rng = np.random.default_rng(seed)
    xs = list(np.abs(rng.normal(1.0, 0.3, 120)) * np.where(rng.uniform(size=120) < 0.1, 4, 1))
    assert timer_trace(straggler, cfg, xs) == timer_trace(ref_straggler, cfg, xs)


@settings(deadline=None, max_examples=60)
@given(st.lists(st.floats(0.0, 10.0, allow_nan=False), max_size=80),
       st.sampled_from(range(len(CFGS))))
def test_step_timer_drawn(xs, which):
    cfg = CFGS[which]
    assert timer_trace(straggler, cfg, xs) == timer_trace(ref_straggler, cfg, xs)


FLEETS = {
    # the reference's fleet cases: a worker degrading 20x, a uniform fleet
    # with per-host jitter, a worker 3x slower throughout
    "slow_worker": [[0.1] * 4] * 24 + [[2.0 if w == 2 else 0.1 for w in range(4)]] * 12,
    "uniform": [[0.1 + 0.001 * w for w in range(4)]] * 24,
    "substrate": [[1.0 + r * 0.01 + (2.0 if w == 2 else 0.0) for w, r in enumerate(row)]
                  for row in np.random.default_rng(1).normal(size=(20, 4))],
}


@pytest.mark.parametrize("cfg", CFGS[:2])
@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_monitor_cases(case, cfg):
    rows = FLEETS[case]
    assert fleet_trace(straggler, cfg, rows) == fleet_trace(ref_straggler, cfg, rows)


@settings(deadline=None, max_examples=40)
@given(st.integers(1, 6), st.integers(0, 40), st.integers(0, 2**31 - 1))
def test_fleet_monitor_drawn(n_workers, steps, seed):
    rng = np.random.default_rng(seed)
    rows = (np.abs(rng.normal(1.0, 0.2, (steps, n_workers)))
            * np.where(rng.uniform(size=(steps, n_workers)) < 0.15, 5.0, 1.0)).tolist()
    if not rows:
        rows = [[1.0] * n_workers]
    assert fleet_trace(straggler, {}, rows) == fleet_trace(ref_straggler, {}, rows)


def test_median_matches():
    for xs in ([], [3.0], [2.0, 1.0], [5.0, 1.0, 3.0], [4.0, 1.0, 3.0, 2.0]):
        assert straggler._median(xs) == ref_straggler._median(xs)


def outcome(fn, *args, **kw):
    """``fn``'s plan as plain values, or the type of what it raised."""
    try:
        p = fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))
    return (p.mesh_shape, p.axis_names, p.dropped_pods)


@pytest.mark.parametrize("n,mp,pods", [
    (512, 16, 2), (256, 16, 2), (384, 16, 2), (100, 16, 1), (8, 2, 1), (12, 2, 3),
    (24, 4, 4), (7, 7, 2), (64, 8, 3), (0, 4, 1), (15, 4, 2)])
def test_plan_rescale_matches(n, mp, pods):
    assert (outcome(elastic.plan_rescale, n, model_parallel=mp, pods=pods)
            == outcome(ref_elastic.plan_rescale, n, model_parallel=mp, pods=pods))


@settings(deadline=None, max_examples=80)
@given(st.integers(0, 600), st.integers(1, 32), st.integers(1, 8))
def test_plan_rescale_drawn(n, mp, pods):
    assert (outcome(elastic.plan_rescale, n, model_parallel=mp, pods=pods)
            == outcome(ref_elastic.plan_rescale, n, model_parallel=mp, pods=pods))


@pytest.mark.parametrize("n,shards", [(8, 4), (7, 4), (3, 4), (0, 4), (8, 0), (-1, 2),
                                      (2, -1), (16, 16), (17, 8)])
def test_plan_serve_rescale_matches(n, shards):
    assert (outcome(elastic.plan_serve_rescale, n, shards)
            == outcome(ref_elastic.plan_serve_rescale, n, shards))


@settings(deadline=None, max_examples=80)
@given(st.integers(-2, 200), st.integers(-2, 40))
def test_plan_serve_rescale_drawn(n, shards):
    assert (outcome(elastic.plan_serve_rescale, n, shards)
            == outcome(ref_elastic.plan_serve_rescale, n, shards))


def plain_report(rep: dict) -> dict:
    plan = lambda p: None if p is None else (p.mesh_shape, p.axis_names, p.dropped_pods)
    return dict(rep, plan=plan(rep["plan"]), degraded_plan=plan(rep["degraded_plan"]))


@pytest.mark.parametrize("n_shards,n_devices,slow,flagged", [
    (4, 8, 2, [2]), (4, 8, None, []), (2, 2, 1, []), (4, 4, 0, [0])])
def test_fleet_serve_monitor_report(n_shards, n_devices, slow, flagged):
    """Recorded timings and probes of plain callables (one shard made slow
    by its recorded times; two shards are too few to call one an outlier):
    both packages report the same stragglers, advice and replica plans."""
    reps = []
    for cls in (FleetServeMonitor, RefFleetServeMonitor):
        mon = cls(n_shards, n_devices)
        for step in range(36):
            for s in range(n_shards):
                mon.record(s, 2.0 if (s == slow and step >= 24) else 0.1)
        fns = [lambda q, i, f: None] * n_shards
        times = mon.probe(fns, None, None, None)
        assert len(times) == n_shards and all(t >= 0 for t in times)
        reps.append(mon.report())
    assert plain_report(reps[0]) == plain_report(reps[1])
    assert reps[0]["stragglers"] == flagged


def test_fleet_serve_monitor_rejects_uneven_fleet():
    for cls in (FleetServeMonitor, RefFleetServeMonitor):
        with pytest.raises(ValueError):
            cls(3, 8)

