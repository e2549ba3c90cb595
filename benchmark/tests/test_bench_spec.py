"""BENCHMARK.json against the contract's rules, and every piece found by name."""

import json
import re
from pathlib import Path

from uvbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|factor)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got)), group


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert e2e["setup_s"] == cells
    for c in cells:
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s"), c
        assert any(c in m.get("workloads", []) for m in BENCH["per_layer"]), c
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]], (m["name"], c)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct")
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_check_fits_the_budget():
    """A full check of 24 cells at this run length fits 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_piece_found_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        assert cell.workload["config"] == w["config"]
        assert cell.workload["why"] == w["why"]
        assert {"setup", "window", "end_to_end", "release", "check"} <= set(dir(cell.traffic))
        for m in cell.per_layer:
            assert callable(cell.readers[m["name"]].read)
    files = {p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert files >= {m["name"] for m in BENCH["per_layer"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_paths_hold_only_the_benchmark():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_metrics_without_a_workloads_key_follow_the_rules():
    """An end-to-end metric without `workloads` belongs to every cell; a
    per-layer one to every cell that reports the metric it moves."""
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"].append({"name": "extra_fps", "unit": "frames/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock"})
    bench["per_layer"].append({"name": "drc_encode_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "Draco encoder",
                               "moves": "extra_fps"})
    bench["per_layer"] = bench["per_layer"][-1:]
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert {m["name"] for m in cell.end_to_end} >= {"extra_fps", "setup_s"}
        assert [m["name"] for m in cell.per_layer] == ["drc_encode_ms"]
