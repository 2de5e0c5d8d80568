"""BENCHMARK.json keeps to its contract, and a configuration, a cell, a
traffic mix and a per-layer metric added as files only are found by name."""
import json
import re
from pathlib import Path

from benchmark import harness
from benchmark.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_names_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).exists()
        assert c["name"] in {w["config"] for w in b["workloads"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:
        cell = harness.Cell(w["name"])
        reported = {m["name"] for m in cell.metrics[0]}
        assert "setup_s" in reported and len(reported) >= 2 and cell.metrics[1]
        for m in cell.metrics[1]:
            assert m["moves"] in reported
    assert len(json.dumps(b)) < 64 * 1024


def test_added_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    (root / "benchmark/metrics/requests_done.py").write_text("def read(run):\n    return run.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "serving", "moves": "frames_per_s",
                               "workloads": ["tiny-serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.execute("tiny-serve", 3, 1.0, 1, device="cpu", root=Path(root))
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] == result["attempted"] >= 2
    assert "request_p50_s" in result["metrics"]
