"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, and that every configuration, mix, entry and metric it
names has its file."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.bench_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and \
            (harness.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert (harness.HERE / "entries" / f"{cfg['entry']}.py").is_file()
        if "reference" in cfg:               # a pairing's plain reference
            assert (harness.HERE / "reference" /
                    f"{cfg['reference']}.py").is_file()
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    ws = SPEC["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
        assert json.loads((harness.ROOT / cfg["file"]).read_text())[
            "chips"] == w["chips"]
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        # every cell a per-layer metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", sorted(w["name"] for w in SPEC["workloads"]))
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in harness.metrics_for(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(SPEC, cell, True)


def test_a_full_check_fits_with_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
