"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; the configuration's file is the entry's `file`, the traffic mix is
`pngbench/traffic/<traffic>.json`, and a per-layer metric's reader is
`pngbench/metrics/<name>.py`, a module with `read(ctx)`.  The code that a
configuration or a traffic mix names is found the same way: the
configuration's `content` is `pngbench/content/<content>.py` (the pixels
a run sends) and the traffic's `op` is `pngbench/ops/<op>.py` (the call
it makes and what its check compares).  Adding a cell, a configuration,
a traffic mix, a kind of content, an operation or a metric is adding
files and entries: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load() -> dict:
    return _read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> dict:
    """The cell named `workload` with its configuration, its traffic and
    the metrics it reports: {"workload", "config", "traffic",
    "end_to_end", "per_layer"}."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"pngbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(ROOT, conf["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json"))

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in e2e_names]
    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def plugin(folder: str, name: str):
    """The module pngbench/<folder>/<name>.py, loaded by its path."""
    path = os.path.join(HERE, folder, name + ".py")
    if not NAME.match(name) or not os.path.isfile(path):
        raise SystemExit(f"pngbench: no {folder} named {name!r} "
                         f"(pngbench/{folder}/<name>.py)")
    spec = importlib.util.spec_from_file_location(
        f"pngbench_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """read(ctx) of pngbench/metrics/<metric>.py."""
    return plugin("metrics", metric).read
