"""BENCHMARK.json keeps to the contract's shapes, and every file it names
loads."""

import json
import os
import re

import pytest

from genobench import spec

B = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert B["paths"] == ["genobench"]
    assert all(TEXT.match(w) for w in B["command"])
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert TEXT.match(e[k]), (k, e[k])
    assert len(set(names)) == len(names)


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert set(e2e) == {"reads_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in B["end_to_end"] + B["per_layer"]:
        assert os.path.exists(spec.metric_path(m["name"])), m["name"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    assert TEXT.match(w["why"])
    cell = spec.cell(w["name"], B)
    assert cell.config["geno"] and cell.config["runner"]
    for key in ("coverage", "read_len", "rc_frac", "high_q", "high_share",
                "error_rate", "batch_reads"):
        assert key in cell.mix
    assert cell.end_to_end and cell.per_layer


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("genobench/")
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for k in c["reduced"]:
        assert NAME.match(k) and k in cfg
        assert k in cfg.get("source_sizes", {})
    assert {w["config"] for w in B["workloads"]} >= {c["name"]}
