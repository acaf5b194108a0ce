"""BENCHMARK.json against the benchmark's rules, and every file a cell
needs found by its name."""
import json
import re

import pytest

from chipbench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]


def text_ok(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and not re.search(
        r"[\n\r\t]", s)


def test_top_level_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(text_ok(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for word in MANIFEST["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    need, may = KEYS[section]
    entries = MANIFEST[section]
    assert 1 <= len(entries)
    for e in entries:
        assert need <= set(e) <= need | may, e
        assert NAME.match(e["name"]), e["name"]
    assert len({e["name"] for e in entries}) == len(entries)


def test_names_units_and_metrics():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and text_ok(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_configs():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(pairs) <= 24
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(pairs) // 4)
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert w["config"] in configs and NAME.match(w["traffic"])
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if w["name"] in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", CELLS)
                   for m in MANIFEST["per_layer"])
    assert {w["config"] for w in MANIFEST["workloads"]} == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_files_under_paths_are_named_from_name_characters():
    for p in MANIFEST["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            assert PATH.match(str(f.relative_to(ROOT))), f


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    spec = harness.cell(name)
    assert spec.traffic["entry"] in ("stream", "rows")
    assert set(spec.limits) == {"max_gap", "rms_gap"}
    __import__(f"chipbench.systems.{spec.config['system']}")
    assert (ROOT / spec.config["reference"]).is_file()
    assert spec.per_layer and {m["name"] for m in spec.end_to_end} >= {
        "setup_s"}


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_found_by_name(name):
    assert callable(harness.reader(name))
