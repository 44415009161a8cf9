"""Unit tests for bench.py's timing machinery: agreement-driven
re-rounds, spread statistics and the metric records — all with a fake
clock, no device."""

import itertools

import bench


def _fake_clock(durations):
    """perf_counter sequence: each timing round reads the clock twice
    (start, end); rounds last the given durations."""
    times = []
    t = 0.0
    for d in durations:
        times.append(t)          # round start
        t += d
        times.append(t)          # round end
    it = iter(times + [t] * 100)
    return lambda: next(it)


def test_timeit_stats_agreement_rerounds(monkeypatch):
    # rounds: 1.0 then 1.5 (no agreement), 1.04 agrees with 1.0 -> stop
    monkeypatch.setattr(bench.time, "perf_counter",
                        _fake_clock([1.0, 1.5, 1.2, 1.04]))
    st = bench._timeit_stats(lambda: 0.0, iters=1, rounds=3)
    assert st["rounds"] == 4
    assert st["agreed"]
    assert abs(st["best"] - 1.0) < 1e-9
    assert min(abs(st["median"] - x) for x in (1.2, 1.04)) < 1e-9
    assert st["cv"] > 0.0


def test_timeit_stats_cap(monkeypatch):
    # never agrees: strictly growing durations -> stops at max_rounds
    monkeypatch.setattr(bench.time, "perf_counter",
                        _fake_clock([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))
    st = bench._timeit_stats(lambda: 0.0, iters=1, rounds=3, max_rounds=5)
    assert st["rounds"] == 5
    assert not st["agreed"]
    assert abs(st["best"] - 1.0) < 1e-9


def test_timeit_stats_immediate_agreement(monkeypatch):
    monkeypatch.setattr(bench.time, "perf_counter",
                        _fake_clock([1.0, 1.01, 1.02]))
    st = bench._timeit_stats(lambda: 0.0, iters=1, rounds=3)
    assert st["rounds"] == 3 and st["agreed"]


def test_metric_records_spread(monkeypatch, capsys):
    monkeypatch.setattr(bench.time, "perf_counter",
                        _fake_clock([1.0, 1.01, 1.02]))

    def fn():
        bench._timeit(lambda: 0.0, iters=1)
        return 42.0

    bench._metric("demo_metric", fn, unit="u", target=84.0)
    err = capsys.readouterr().err
    assert '"value": 42.0' in err
    assert '"vs_baseline": 0.5' in err
    # no fixed per-platform ceiling rides in the record
    assert "ceiling" not in err
    assert '"spread_cv"' in err and '"rounds_agreed_10pct": true' in err


def test_metric_failure_is_recorded(monkeypatch, capsys):
    """A metric that raises still prints its failure and lands in the
    list that makes bench.py exit non-zero."""
    monkeypatch.setattr(bench, "_FAILED", [])

    def boom():
        raise RuntimeError("no lowering")

    bench._metric("broken_metric", boom)
    assert "broken_metric failed: RuntimeError" in capsys.readouterr().err
    assert bench._FAILED == ["broken_metric"]
