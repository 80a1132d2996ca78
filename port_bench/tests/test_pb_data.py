"""The benchmark's files: every cell, configuration, traffic mix and
metric of BENCHMARK.json parses and is found by name, within the
contract's limits."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import HARNESS, REPO
from pbench import port, spec, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(e["name"] for e in b["end_to_end"] + b["per_layer"])) \
        == len(b["end_to_end"]) + len(b["per_layer"])
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_parses(cell):
    c = spec.cell(cell)
    cfg, st = c["config"], c["settings"]
    # the longest request fits in a slot and the pool holds every slot's
    mix = c["mix"]
    longest = mix["prompt"]["max"] + mix["output"]["max"]
    assert longest <= st["max_seq"]
    assert st["pages"] >= st["slots"] * -(-longest // port.PAGE_SIZE)
    assert cfg["num_hidden_layers"] >= 1 and weights.linear_shapes(cfg)
    assert 0 < st["check"]["max_logit_gap"]
    assert c["end_to_end"] and c["per_layer"]


def test_configs_keep_published_sizes():
    """Widths and depth as published; the one key ``reduced`` names is
    OPT's ``torch_dtype``, served in bf16 where it states float16."""
    b = _bench()
    for conf in b["configs"]:
        with open(os.path.join(REPO, conf["file"])) as f:
            cfg = json.load(f)
        assert cfg["hidden_size"] == 4096 and cfg["num_hidden_layers"] == 32
        assert cfg["torch_dtype"] == cfg["serve"]["activations"]
        want = [] if cfg["model_type"] == "mistral" else ["torch_dtype"]
        assert conf["reduced"] == want


@pytest.mark.parametrize("conf", [c["name"] for c in _bench()["configs"]])
def test_every_config_has_its_family(conf):
    """``families/<model_type>.py`` with its three names."""
    entry = next(c for c in _bench()["configs"] if c["name"] == conf)
    with open(os.path.join(REPO, entry["file"])) as f:
        cfg = json.load(f)
    fam = spec.family(cfg)
    assert callable(fam.build_model) and callable(fam.logits)
    assert fam.Work(cfg).weight_bytes > 0


def test_missing_family_is_named():
    with pytest.raises(spec.MissingFamily,
                       match=r"port_bench/families/no-such\.py"):
        spec.family({"model_type": "no-such"})


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_reports_what_its_per_layer_metrics_move(cell):
    """A cell reports ``setup_s``, another end-to-end metric and a
    per-layer one, and every per-layer metric it reports moves one of its
    end-to-end metrics."""
    c = spec.cell(cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])


def test_metric_workloads_name_cells():
    """A metric's ``workloads`` lists cells of BENCHMARK.json; only those
    report it, and a metric without the key is reported everywhere."""
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            listed = m.get("workloads", cells)
            assert listed and set(listed) <= set(cells), m["name"]
            for name in cells:
                got = {x["name"] for x in spec.cell(name)[kind]}
                assert (m["name"] in got) == (name in listed)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    for m in _bench()[kind]:
        r = spec.metric_reader(m["name"])
        assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"],
                                                m["source"])
        if kind == "per_layer":
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])


def test_traffic_kinds_are_found():
    for name in os.listdir(os.path.join(HARNESS, "traffic")):
        if name.endswith(".json"):
            with open(os.path.join(HARNESS, "traffic", name)) as f:
                kind = json.load(f)["kind"]
            assert hasattr(spec.traffic_kind(kind), "make")
