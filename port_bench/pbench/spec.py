"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations,
traffic mixes and metrics. Each has files of its own under the harness's
directory, so a later change adds a cell, a configuration, a traffic kind
or a metric by adding files:

* ``workloads/<cell>.json``: the engine's settings for the cell (slots,
  pages, max_seq, decode window), the correctness check's sample and
  limit;
* ``<config file>`` (the path ``BENCHMARK.json`` gives): the published
  configuration and the weights' recipe;
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one kind;
* ``traffic/<kind>.py``: the generator of that kind;
* ``metrics/<metric>.py``: the reader of one metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HARNESS_DIR)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, root: str = ROOT,
         harness_dir: str = HARNESS_DIR) -> dict:
    """Everything one run of cell ``name`` reads: its entry in
    ``BENCHMARK.json``, its own settings, its configuration, its traffic
    mix and the metrics it reports (end-to-end and per-layer)."""
    bench = load_benchmark(root)
    entry = _by_name(bench["workloads"], name, "workload")
    conf_entry = _by_name(bench["configs"], entry["config"], "config")
    mix = _read_json(os.path.join(harness_dir, "traffic",
                                  entry["traffic"] + ".json"))
    return {
        "name": name,
        "entry": entry,
        "settings": _read_json(os.path.join(harness_dir, "workloads",
                                            name + ".json")),
        "config": _read_json(os.path.join(root, conf_entry["file"])),
        "config_name": conf_entry["name"],
        "mix": mix,
        "end_to_end": bench["end_to_end"],
        "per_layer": bench["per_layer"],
    }


def _module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str, harness_dir: str = HARNESS_DIR):
    """The generator module of a traffic kind (``traffic/<kind>.py``)."""
    return _module(os.path.join(harness_dir, "traffic", kind + ".py"),
                   "port_bench_traffic_" + kind)


def metric_reader(name: str, harness_dir: str = HARNESS_DIR):
    """The reader module of a metric (``metrics/<name>.py``): ``read(run)``
    returns the value, or None when the run holds nothing to read."""
    return _module(os.path.join(harness_dir, "metrics", name + ".py"),
                   "port_bench_metric_" + name)


def readers(metrics: List[dict],
            harness_dir: str = HARNESS_DIR) -> Dict[str, object]:
    return {m["name"]: metric_reader(m["name"], harness_dir)
            for m in metrics}
