"""Whole runs of each cell, shrunk, on the CPU (the program's plain
versions): a sound run is correct; the control, and the program broken
underneath the timed entry, are not. And the import guard and the trace
reduction."""
import random
import sys
import time
import types
from types import SimpleNamespace

import pytest
import torch

from chipbench import harness, trace
from chipbench.references import cnn_eq as ref
from chipbench.tests.conftest import TINY

CPU = torch.device("cpu")
CELLS = sorted(TINY)


def run(name, wrap=None, seed=2 ** 31 + 11):
    result, _, err = harness.run(name, seed, 0.2, False, CPU,
                                 time.perf_counter(), wrap=wrap,
                                 traffic=TINY[name])
    return result, err


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, err = run(name)
    assert result["correct"] and result["failed"] == 0, err
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"eq_sym_per_s", "eq_latency_p95_ms",
                                      "setup_s"}
    assert result["attempted"] > 0
    assert err[-2:] == [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
                        for k, v in result["compared"].items()]
    if name.startswith("imdd40"):           # the int8 datapath is exact
        assert result["compared"]["max_gap"]["value"] == 0.0


def test_stacked_heads_run_is_correct():
    """The rows entry with several heads: each row through its own head's
    weights in one stacked launch."""
    result, _, err = harness.run(
        "proakis_b.sectors_1024", 2 ** 31 + 13, 0.2, False, CPU,
        time.perf_counter(),
        traffic=dict(TINY["proakis_b.sectors_1024"], heads=3,
                     rows_per_head=2))
    assert result["correct"] and result["failed"] == 0, err


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    spec = harness.cell(name)
    spec.traffic.update(TINY[name])
    from chipbench.systems.cnn_eq import System
    for seed in (3, 4, 5):
        system = System(spec.config, spec.traffic, seed, CPU)
        low = ref.lower_precision(system.datapath())
        samples = [(i, system.reference(i, low)) for i in range(3)]
        numbers, failed = harness.compare(system, samples, spec.limits,
                                          system.datapath())
        assert not harness.within(numbers, spec.limits), numbers
        assert failed == 3


def alter_one(step):
    def broken(x):
        y = step(x).clone()
        y.view(-1)[y.numel() // 3] += 2.0
        return y
    return broken


def half_left_out(step):
    def broken(x):
        y = step(x).clone()
        rows = y if y.dim() == 2 else y.view(2, -1)
        rows[rows.shape[0] // 2:] = rows[:rows.shape[0] // 2].mean(0)
        return y
    return broken


def stale(step):
    last = []

    def broken(x):
        y = step(x)
        out = last[0] if last else y
        last[:] = [y]
        return out
    return broken


@pytest.mark.parametrize("fault", [alter_one, half_left_out, stale])
@pytest.mark.parametrize("name", CELLS)
def test_broken_program_is_not_correct(name, fault):
    result, err = run(name, wrap=fault)
    assert not result["correct"], err
    assert result["failed"] > 0


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules() == []
    for ok in ("repro_torch.core", "reprox", "jaxtyping"):
        sys.modules[ok] = types.ModuleType(ok)
    try:
        harness.guard("test")
        for bad in ("jax", "repro.core"):
            sys.modules[bad] = types.ModuleType(bad)
            try:
                with pytest.raises(harness.ForbiddenImport):
                    harness.guard("test")
            finally:
                del sys.modules[bad]
    finally:
        for ok in ("repro_torch.core", "reprox", "jaxtyping"):
            del sys.modules[ok]


def _loads_repro(fn):
    def loading(*args, **kw):
        sys.modules["repro"] = types.ModuleType("repro")
        return fn(*args, **kw)
    return loading


@pytest.mark.parametrize("late", ["compare", "end_to_end"])
def test_a_late_forbidden_import_prints_no_result(monkeypatch, capsys,
                                                  late):
    """A module of the JAX package loaded after the window, by the
    comparison or by the system's end-to-end numbers, fails the run with
    exit code 3 and no result line."""
    from chipbench import run as run_mod
    from chipbench.systems import cnn_eq

    name = "imdd40.stream_n64"
    cell = harness.cell

    def tiny_cell(n, *a, **kw):
        spec = cell(n, *a, **kw)
        spec.traffic.update(TINY[name])
        return spec
    monkeypatch.setattr(harness, "cell", tiny_cell)
    monkeypatch.setattr(run_mod, "card", lambda chips: CPU)
    if late == "compare":
        monkeypatch.setattr(harness, "compare", _loads_repro(harness.compare))
    else:
        monkeypatch.setattr(cnn_eq.System, "end_to_end",
                            _loads_repro(cnn_eq.System.end_to_end))
    # whatever the test leaves under "repro" goes again at its end
    monkeypatch.setitem(sys.modules, "repro", None)
    del sys.modules["repro"]
    code = run_mod.main(["--workload", name, "--seed", str(2 ** 31 + 5),
                         "--seconds", "0.2", "--trace", "0"])
    out, err = capsys.readouterr()
    assert code == 3
    assert out == "" and "forbidden import: loaded repro" in err


def test_sound_main_prints_the_result_last(monkeypatch, capsys):
    import json
    from chipbench import run as run_mod

    name = "proakis_b.sectors_1024"
    cell = harness.cell

    def tiny_cell(n, *a, **kw):
        spec = cell(n, *a, **kw)
        spec.traffic.update(TINY[name])
        return spec
    monkeypatch.setattr(harness, "cell", tiny_cell)
    monkeypatch.setattr(run_mod, "card", lambda chips: CPU)
    code = run_mod.main(["--workload", name, "--seed", str(2 ** 31 + 7),
                         "--seconds", "0.2", "--trace", "0"])
    out, err = capsys.readouterr()
    assert code == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "compared"
    assert err.strip().splitlines()[-1].startswith("compared rms_gap")


def test_the_harness_names_no_metric_of_a_family():
    src = (harness.HERE / "harness.py").read_text()
    assert "eq_" not in src and "kept_symbols" not in src


def test_sampler_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        s = harness.Sampler(2, random.Random(seed))
        for i in range(10):
            s.offer(i, None)
        picks += [i for i, _ in s.kept]
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 50 and max(counts) < 110


def ev(name, t0, t1, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=t0, end=t1))


def test_trace_reduction():
    events = [ev(trace.WINDOW, 0, 100, "cpu"),
              ev("chipbench.wait", 40, 60, "cpu"),
              ev("aten::pad", 90, 99, "cpu"),
              ev(trace.WINDOW, 0, 100, "gpu"),        # an annotation
              ev("k1", 10, 30, "gpu"), ev("k2", 25, 40, "gpu"),
              ev("k1", 60, 90, "gpu"), ev("k3", 95, 120, "gpu")]
    s = trace.summarize(events, device_type="gpu")
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 30 + 5) * 1e-6)
    assert s["by_name"]["k1"] == pytest.approx(50e-6)
    assert s["by_name"]["k3"] == pytest.approx(5e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k1"
    assert dict(b["idle_gaps"]) == pytest.approx({
        "no host range": 10e-6, "chipbench.wait": 20e-6,
        "aten::pad": 5e-6})
    ctx = SimpleNamespace(trace=s)
    assert harness.reader("device_idle")(ctx) == pytest.approx(35.0)


def test_a_non_finite_output_is_not_correct_and_prints_as_json():
    import json

    def nan_out(step):
        def broken(x):
            y = step(x).clone()
            y.view(-1)[0] = float("nan")
            return y
        return broken
    result, err = run("proakis_b.sectors_1024", wrap=nan_out)
    assert not result["correct"]
    line = json.dumps(result, allow_nan=False)
    assert json.loads(line)["compared"]["max_gap"]["value"] == "nan"
