"""What ``BENCHMARK.json`` names, found by name on disk.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is one data file: ``configs/<config>.json`` (from the ``configs``
entry's ``file``) and ``traffic/<traffic>.json``; a training configuration
(``"kind": "lm_train"``) also names its model module (``model``: the plain
reference and the count).  A per-layer metric is one reader,
``metrics/<metric name>.py``, holding ``read(ctx) -> float | None``.
Nothing here names a cell, a configuration or a metric: a new one is new
files and new entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Callable, List, Optional

#: the benchmark's own folder and the checkout's root
HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of the benchmark with everything it names, loaded."""

    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def load_spec(path: pathlib.Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads`` key: all)."""
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_file(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"


def metric_file(name: str) -> pathlib.Path:
    return HERE / "metrics" / f"{name}.py"


def find_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell called ``name``, its configuration and traffic read."""
    spec = spec if spec is not None else load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(ROOT / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_file(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if reports(m, name)])


def reader(metric_name: str) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = metric_file(metric_name)
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(spec: dict) -> List[str]:
    """What is malformed in ``spec``: names, units, references by name,
    and whether every cell reports what its per-layer metrics move."""
    out: List[str] = []
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for kind, items in (("config", spec["configs"]),
                        ("workload", spec["workloads"]),
                        ("metric", spec["end_to_end"] + spec["per_layer"])):
        seen = set()
        for it in items:
            n = it["name"]
            if not NAME_RE.match(n):
                out.append(f"{kind} name {n!r} has a forbidden character")
            if n in seen:
                out.append(f"{kind} name {n!r} is used twice")
            seen.add(n)
            if kind == "metric" and not UNIT_RE.match(it["unit"]):
                out.append(f"metric {n!r}: unit {it['unit']!r}")
            if kind == "metric" and it["better"] not in ("lower", "higher"):
                out.append(f"metric {n!r}: better {it['better']!r}")
    for c in spec["configs"]:
        if not (ROOT / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        else:
            with open(ROOT / c["file"]) as f:
                model = json.load(f).get("model")
            if model is not None and not (ROOT / model).is_file():
                out.append(f"config {c['name']}: no model module {model}")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                out.append(f"config {c['name']}: reduced key {k!r}")
    pairs = set()
    for w in spec["workloads"]:
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']}")
        for k in ("config", "traffic"):
            if not NAME_RE.match(w[k]):
                out.append(f"workload {w['name']}: {k} {w[k]!r}")
        if not traffic_file(w["traffic"]).is_file():
            out.append(f"workload {w['name']}: no traffic file for "
                       f"{w['traffic']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        own = [m for m in spec["end_to_end"] if reports(m, w["name"])]
        if "setup_s" not in {m["name"] for m in own} or len(own) < 2:
            out.append(f"workload {w['name']}: needs setup_s and one more "
                       f"end-to-end metric")
        if not any(reports(m, w["name"]) for m in spec["per_layer"]):
            out.append(f"workload {w['name']}: no per-layer metric")
    for m in spec["end_to_end"] + spec["per_layer"]:
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m['name']}: no workload {c}")
    for m in spec["per_layer"]:
        if not metric_file(m["name"]).is_file():
            out.append(f"metric {m['name']}: no reader "
                       f"{metric_file(m['name']).relative_to(ROOT)}")
        moved = e2e.get(m["moves"])
        if moved is None or m["moves"] == "setup_s":
            out.append(f"metric {m['name']}: moves {m['moves']!r}, not an "
                       f"end-to-end metric of the cells")
            continue
        for c in m.get("workloads", list(cells)):
            if not reports(moved, c):
                out.append(f"metric {m['name']}: cell {c} does not report "
                           f"{m['moves']}")
    return out
