"""What a run is asked to do, read from ``BENCHMARK.json`` and the files it
names: the cell (workload), its configuration file and its mix file, and
the metrics the cell reports. Nothing here knows a cell by name."""

from __future__ import annotations

import dataclasses
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's object
    mix: dict             # the mix file's object
    end_to_end: list      # the BENCHMARK.json metric entries it reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def mix_path(name: str) -> str:
    return os.path.join(HERE, "mixes", name + ".json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", name + ".py")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The workload ``name`` of BENCHMARK.json, with its files loaded."""
    bench = bench or load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(wl)})")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, cfgs[w["config"]]["file"]))
    mix = load_json(mix_path(w["traffic"]))
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
