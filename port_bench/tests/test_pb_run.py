"""Whole runs of tiny cells on the CPU (the port's plain kernels): the
result line, the check's verdict under planted faults, a cell added by
files alone, the refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import HARNESS, REPO, TINY, TINY_LIMIT, make_tree

TESTS = os.path.dirname(os.path.abspath(__file__))


def _run(root, argv, fault=None, python_path=REPO, control=False,
         device="cpu"):
    """run.main (or control.main) of the harness under ``root``, on the
    CPU unless ``device`` says otherwise, in a process of its own: (exit
    code, stdout lines, stderr)."""
    mod = "control" if control else "run"
    code = (f"import sys; sys.path[:0] = [{os.path.join(root, 'port_bench')!r},"
            f" {TESTS!r}]; import {mod}, pb_faults; "
            f"sys.exit({mod}.main({argv!r}, device={device!r}"
            + (f", fault=pb_faults.{fault}" if fault else "") + "))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, text=True,
                       capture_output=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=python_path,
                                OMP_NUM_THREADS="2"))
    return p.returncode, p.stdout.strip().splitlines(), p.stderr


def _result(lines):
    return json.loads(lines[-1])


ARGS = ["--seed", str(2**31 + 77), "--seconds", "3"]


@pytest.mark.parametrize("cell", ["tiny-llama.chat", "tiny-opt.chat"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_tiny_run(tree, cell, trace):
    rc, out, err = _run(tree, ["--workload", cell, *ARGS, "--trace", trace])
    assert rc == 0, err[-3000:]
    r = _result(out)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = ({"admit_host_ms", "window_ms_per_step", "mfu"} if trace == "1"
            else {"output_tok_s", "tpot_p95_ms", "peak_mem_gib", "setup_s"})
    assert want <= set(r["metrics"])
    # metrics whose ``workloads`` key does not list the tiny cell
    assert not {"ttft_p95_ms", "ttft_p95_ms.saturated"} & set(r["metrics"])
    assert err.rstrip().splitlines()[-1].startswith("check short_requests")


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_planted_faults_fail_the_check(tree, fault):
    rc, out, err = _run(tree, ["--workload", "tiny-llama.chat", *ARGS],
                        fault=fault)
    assert rc == 0, err[-3000:]
    r = _result(out)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["tiny-llama.chat", "tiny-opt.chat"])
def test_control_fails_the_limit(tree, cell):
    rc, out, err = _run(tree, ["--workload", cell, "--seeds", "1,2,3",
                               "--seconds", "3"], control=True)
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert len(rows) == 3
    limit = TINY_LIMIT[cell.split(".")[0]]
    for r in rows:
        for side, ok in (("program", True), ("control", False)):
            assert r[side]["correct"] is ok, r
            assert r[side]["checks"]["max_logit_gap"]["limit"] == limit


def test_cell_added_by_files_alone(tree):
    """A new configuration, traffic kind, traffic mix, per-layer metric
    and cell: files added, and BENCHMARK.json's entries; no file of the
    harness edited."""
    pb = os.path.join(tree, "port_bench")
    cfg = dict(TINY["tiny-llama"], num_hidden_layers=1)
    with open(os.path.join(pb, "configs", "tiny-one.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "traffic", "closed.py"),
                os.path.join(pb, "traffic", "closedcopy.py"))
    with open(os.path.join(pb, "traffic", "tinymix.json")) as f:
        mix = dict(json.load(f), kind="closedcopy", clients=2)
    with open(os.path.join(pb, "traffic", "pairs.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "requests_done.py"), "w") as f:
        f.write('LAYER = "serving loop"\nUNIT, BETTER, SOURCE, MOVES = '
                '"requests", "higher", "program_counter", "output_tok_s"\n'
                "def read(run):\n    lp = run.loop\n"
                "    return sum(lp.inside(r.done) for r in lp.requests)\n")
    shutil.copy(os.path.join(pb, "workloads", "tiny-llama.chat.json"),
                os.path.join(pb, "workloads", "tiny-one.pairs.json"))
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-one", "source": "test",
                             "file": "port_bench/configs/tiny-one.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-one.pairs",
                               "config": "tiny-one", "traffic": "pairs",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "serving loop",
                               "moves": "output_tok_s"})
    with open(path, "w") as f:
        json.dump(bench, f)
    rc, out, err = _run(tree, ["--workload", "tiny-one.pairs", *ARGS,
                               "--trace", "1"])
    assert rc == 0, err[-3000:]
    r = _result(out)
    assert r["correct"] and r["metrics"]["requests_done"]["value"] > 0
    assert "clients" in err and '"clients": 2' in err


def _add_architecture(tree, model_type):
    """A configuration of ``model_type`` and its cell ``tiny-fam.chat``,
    as files and BENCHMARK.json's entries; for ``tiny-fam`` also its
    family file and its reference (``tests/tiny_family/``)."""
    pb = os.path.join(tree, "port_bench")
    if model_type == "tiny-fam":
        src = os.path.join(TESTS, "tiny_family")
        shutil.copy(os.path.join(src, "tiny-fam.py"),
                    os.path.join(pb, "families", "tiny-fam.py"))
        shutil.copy(os.path.join(src, "tiny_fam.py"),
                    os.path.join(pb, "reference", "tiny_fam.py"))
    cfg = dict(TINY["tiny-llama"], model_type=model_type)
    del cfg["sliding_window"]
    with open(os.path.join(pb, "configs", "tiny-fam.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "workloads", "tiny-llama.chat.json"),
                os.path.join(pb, "workloads", "tiny-fam.chat.json"))
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-fam", "source": "test",
                             "file": "port_bench/configs/tiny-fam.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-fam.chat", "config": "tiny-fam",
                               "traffic": "tinymix", "chips": 1,
                               "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.mark.parametrize("fault", [None, "token_altered"])
def test_architecture_added_by_files_alone(tree, fault):
    """A configuration whose ``model_type`` names a family file added with
    its reference: the cell runs, is correct and reports its traced
    per-layer metrics; a token altered where it is produced fails it."""
    _add_architecture(tree, "tiny-fam")
    rc, out, err = _run(tree, ["--workload", "tiny-fam.chat", *ARGS,
                               "--trace", "0" if fault else "1"],
                        fault=fault)
    assert rc == 0, err[-3000:]
    r = _result(out)
    assert r["correct"] is (fault is None), r["checks"]
    if fault is None:
        assert {"admit_host_ms", "window_ms_per_step", "mfu"} \
            <= set(r["metrics"])


def test_refuses_a_model_type_without_a_family(tree):
    """Exit 4 and no result line; the last line of standard error names
    the missing file."""
    _add_architecture(tree, "tiny-none")
    rc, out, err = _run(tree, ["--workload", "tiny-fam.chat", *ARGS])
    assert rc == 4 and not any(line.startswith("{") for line in out)
    assert "port_bench/families/tiny-none.py" in err.rstrip().splitlines()[-1]


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the harness: no result."""
    make_tree(str(tmp_path))
    rc, out, err = _run(str(tmp_path), ["--workload", "tiny-llama.chat",
                                        *ARGS], python_path="")
    assert rc != 0 and not any(line.startswith("{") for line in out)
    assert "squeezellm_tpu_torch" in err


def test_refuses_without_a_card(capsys):
    import torch

    import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "mistral-7b-w4.chat16", *ARGS]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_top_level_names():
    import run

    names = ["squeezellm_tpu_torch", "squeezellm_tpu_torch.serving",
             "numpy", "jaxlib.xla_client", "squeezellm_tpu.ops",
             "jax_plugins"]
    assert run.forbidden_modules(names) == ["jaxlib", "squeezellm_tpu"]
    assert run.forbidden_modules(["squeezellm_tpu_torch.models"]) == []


@pytest.mark.gpu
def test_control_at_cell_size(cuda):
    """The control on the card at the chat cell's own size, three seeds:
    the program's served tokens pass the cell's limit, the control's
    fail it."""
    p = subprocess.run([sys.executable, os.path.join(HARNESS, "control.py"),
                        "--workload", "mistral-7b-w4.chat16", "--seeds",
                        "41,42,43", "--seconds", "10"], cwd=REPO, text=True,
                       capture_output=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if x[:1] == "{"]
    assert len(rows) == 3
    for r in rows:
        print(json.dumps(r))
        assert r["program"]["correct"] is True, r
        assert r["control"]["correct"] is False, r


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mistral-7b-w4.chat16",
                                  "opt-6.7b-w4.chat16"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_planted_faults_at_cell_size(cuda, cell, fault):
    """Each fault under the timed path, on the card at the cell's own
    size in a 10 s window: ``correct`` false."""
    rc, out, err = _run(REPO, ["--workload", cell, "--seed", "4500000001",
                               "--seconds", "10"], fault=fault,
                        device="cuda")
    assert rc == 0, err[-3000:]
    r = _result(out)
    print(json.dumps({"cell": cell, "fault": fault, "checks": r["checks"],
                      "sampled": err.split("reference: ")[-1][:80]}))
    assert r["correct"] is False, r["checks"]
