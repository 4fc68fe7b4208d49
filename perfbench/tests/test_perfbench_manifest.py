"""BENCHMARK.json keeps to the contract, and every configuration, traffic
mix, system, reference and per-layer metric it names is found by name."""

import json
import re

import pytest

from perfbench.harness import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_lines():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for entry in MAN["configs"] + MAN["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in (MAN["configs"], MAN["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = manifest.cell(cell)
    assert c.mix["kind"] in ("train", "eval")
    for attr in ("make_inputs", "make_members", "System", "expected",
                 "compare"):
        assert hasattr(c.system, attr)
    for attr in ("train_steps", "rollout", "philox_normals"):
        assert hasattr(c.reference, attr)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported, (cell, m["name"])
        assert callable(c.readers[m["name"]].read)
    work = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert work["chips"] == 1
    pair = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pair) == len(set(pair))


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("perfbench/")
    assert conf["source"].startswith("https://")
    assert conf["reduced"] == []
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(cfg["limits"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
