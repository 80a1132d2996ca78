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
* ``metrics/<metric>.py``: the reader of one metric;
* ``families/<model_type>.py``: the architecture of every configuration
  whose published ``model_type`` it is named after (``family``).
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
    ``BENCHMARK.json``, its own settings, its configuration and the
    configuration's family, its traffic mix and the metrics it reports
    (end-to-end and per-layer, ``reported``). Raises ``MissingFamily``
    where the configuration's family has no file."""
    bench = load_benchmark(root)
    entry = _by_name(bench["workloads"], name, "workload")
    conf_entry = _by_name(bench["configs"], entry["config"], "config")
    mix = _read_json(os.path.join(harness_dir, "traffic",
                                  entry["traffic"] + ".json"))
    config = _read_json(os.path.join(root, conf_entry["file"]))
    return {
        "name": name,
        "entry": entry,
        "settings": _read_json(os.path.join(harness_dir, "workloads",
                                            name + ".json")),
        "config": config,
        "config_name": conf_entry["name"],
        "family": family(config, harness_dir),
        "mix": mix,
        "end_to_end": reported(bench["end_to_end"], name),
        "per_layer": reported(bench["per_layer"], name),
    }


def reported(metrics: List[dict], cell_name: str) -> List[dict]:
    """The metrics that cell ``cell_name`` reports: those whose
    ``workloads`` key lists it, and those without the key."""
    return [m for m in metrics
            if cell_name in m.get("workloads", [cell_name])]


def _module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class MissingFamily(FileNotFoundError):
    """A configuration whose ``model_type`` has no family file."""


def family(cfg: dict, harness_dir: str = HARNESS_DIR):
    """The architecture module of configuration ``cfg``,
    ``families/<model_type>.py``. It defines ``build_model(cfg, seed,
    device)``, the port's model made from the seed's raw weights;
    ``logits(cfg, seed, seqs, starts, device, act=None)``, the plain
    reference's f32 logits, teacher-forced, ``act`` the control's
    rounding; and ``Work(cfg)``, the work counts (``pbench/work.py``'s
    meanings)."""
    mtype = cfg["model_type"]
    path = os.path.join(harness_dir, "families", mtype + ".py")
    if not os.path.isfile(path):
        raise MissingFamily(
            f"no family file {os.path.relpath(path, ROOT)} for model_type "
            f"{mtype!r}")
    return _module(path, "port_bench_family_" + mtype)


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
