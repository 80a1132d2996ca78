"""Mellum2-12B-A2.5B in the harness: its family found by ``model_type``,
the work counts of the published configuration against a hand count, the
K13 rooflines' readers, and a reference that loads nothing of the port or
of JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

from conftest import HARNESS
from pbench import loop, spec, work

with open(os.path.join(HARNESS, "configs", "mellum2-12b-w4.json")) as f:
    CFG = json.load(f)


def test_published_work_hand_count():
    w = spec.family(CFG).Work(CFG)
    h, f, q, kv = 2304, 896, 32 * 128, 4 * 128
    attn = [(q, h), (kv, h), (kv, h), (h, q)]
    expert = [(f, h), (f, h), (h, f)]
    assert w.attn_macs == sum(o * i for o, i in attn) + 64 * h
    assert w.expert_macs == 3 * f * h == 6193152

    def packed(shapes):
        return sum(o * i / 2 + o * 16 * 4 + round(o * i * 0.0045) * 8
                   + (o + 1) * 4 + i * 10 * 4 + 10 * 4 for o, i in shapes)

    assert w.expert_bytes == packed(expert)
    assert w.expert_bytes == 3818356  # 3.82 MB (3.64 MiB) an expert
    assert w.fixed_bytes == (28 * (packed(attn) + 64 * h * 4 + 2 * h * 4)
                             + 98304 * h * 2)
    assert w.kv_row == 2 * 4 * 128 * 2  # 56 KiB a token over 28 layers
    assert (w.sliding, w.full, w.window) == (21, 7, 1024)
    # 16 rows: 64 (1 - (7/8)^16) = 56.4 experts a layer
    assert w.experts_read(16) == pytest.approx(28 * 64 * (1 - (7 / 8) ** 16))
    assert w.experts_read(16) / 28 == pytest.approx(56.44, abs=0.01)
    nb, fl = w.moe_decode(16)
    assert nb == pytest.approx(w.experts_read(16) * w.expert_bytes)
    assert fl == 2 * 16 * 8 * 6193152 * 28
    # a decode step of contexts 100 and 2000: sliding layers read 100 and
    # 1024 keys, full ones 100 and 2000
    nb, fl = w.decode_step([100, 2000])
    mb, mf = w.moe_decode(2)
    att = 4 * 32 * 128 * (21 * 1124 + 7 * 2100)
    assert fl == 2 * 2 * (28 * w.attn_macs + 98304 * h) + mf + att
    assert nb == (w.fixed_bytes + mb + 2 * h * 2
                  + w.kv_row * (21 * 1124 + 7 * 2100 + 28 * 2)
                  + 2 * 98304 * 4)
    # a prompt of 1500: sliding layers attend the window from row 1025
    nb, fl = w.prefill(1500)
    mb, mf = w.moe_prefill(1500)
    keys_s, keys_f = work.attended_sum(1500, 1024), 1500 * 1501 // 2
    assert fl == (2 * 1500 * 28 * w.attn_macs + mf + 2 * 98304 * h
                  + 4 * 32 * 128 * (21 * keys_s + 7 * keys_f))
    assert mf == 2 * 1500 * 8 * 6193152 * 28
    # the experts are most of a token's MACs: 1.39 G of 2.21 G
    per_token = 28 * (w.attn_macs + 8 * w.expert_macs) + 98304 * h
    assert 28 * 8 * w.expert_macs == pytest.approx(1.387e9, rel=1e-3)
    assert per_token == pytest.approx(2.21e9, rel=5e-3)


def _run(work_obj, device_ops, traced_windows, prompts=()):
    wins = [loop.Span(0.0, 1.0, True, steps=s, contexts=c)
            for s, c in traced_windows]
    adm = [loop.Span(0.0, 1.0, True, prompts=list(prompts))]
    lp = loop.Loop(opened=0.0, closed=2.0, requests=[], admissions=adm,
                   windows=wins, decode_steps=0, traffic={})
    return types.SimpleNamespace(loop=lp, work=work_obj,
                                 trace={"device_ops": device_ops},
                                 peak_bytes=0, setup_s=0.0)


def test_k13_rooflines_read_the_kernels_by_name():
    w = spec.family(CFG).Work(CFG)
    dec = spec.metric_reader("moe_dec_roofline")
    pre = spec.metric_reader("moe_prefill_roofline")
    run = _run(w, [["moe_dec_kernel", 0.5], ["moe_mma_kernel", 0.25]],
               [(8, [300] * 16), (4, [500] * 12)], prompts=[256, 40])
    want = 8 * work.bound_s(*w.moe_decode(16)) + \
        4 * work.bound_s(*w.moe_decode(12))
    assert dec.read(run) == pytest.approx(100 * want / 0.5)
    want = (work.bound_s(*w.moe_prefill(256))
            + work.bound_s(*w.moe_prefill(40)))
    assert pre.read(run) == pytest.approx(100 * want / 0.25)
    # a dense configuration's run, or one whose trace lacks the kernels,
    # reads nothing and raises nothing
    dense = _run(types.SimpleNamespace(), [["moe_dec_kernel", 0.5]],
                 [(8, [300])], prompts=[256])
    assert dec.read(dense) is None and pre.read(dense) is None
    bare = _run(w, [["dec_mma_kernel", 0.5]], [(8, [300])], prompts=[256])
    assert dec.read(bare) is None and pre.read(bare) is None


def test_mellum_reference_imports_neither_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.mellum, "
            "pbench.experts; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'squeezellm_tpu_torch', 'squeezellm_tpu', "
            "'jax', 'jaxlib', 'flax'}))" % HARNESS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.stdout.strip() == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_planted_faults_at_mellum_size(cuda, fault):
    """Each planted fault under the timed path of the Mellum cell, on the
    card at its own size in a 10 s window: ``correct`` false."""
    from test_pb_run import REPO, _result, _run

    rc, out, err = _run(REPO, ["--workload", "mellum2-12b-w4.chat16",
                               "--seed", "4500000019", "--seconds", "10"],
                        fault=fault, device="cuda")
    assert rc == 0, err[-3000:]
    r = _result(out)
    print(json.dumps({"fault": fault, "checks": r["checks"]}))
    assert r["correct"] is False, r["checks"]


def wrong_expert_tile(eng):
    """A fault of K13's alone: in every launch, the first row tile of the
    routing's tile map (the lowest expert that holds rows) computed with
    the next expert's weights. Patched into the process before the
    engine's warm-up, so the captured decode steps hold it too."""
    import torch

    from squeezellm_tpu_torch.ops import moe_lut

    orig = moe_lut.tile_map

    def tile_map(offsets, ntiles, tile):
        t = orig(offsets, ntiles, tile)
        e = t[0, :1]
        t[0, :1] = torch.where(e >= 0, (e + 1) % (offsets.numel() - 1), e)
        return t

    moe_lut.tile_map = tile_map


@pytest.mark.gpu
def test_k13_fault_at_mellum_size(cuda):
    """One row tile of each K13 launch given the wrong expert, under the
    Mellum cell's timed path on the card at its own size (the weight
    recipe's down projections at gain 0.5 included): ``correct`` false."""
    from test_pb_run import REPO, TESTS

    code = (f"import sys; sys.path[:0] = "
            f"[{os.path.join(REPO, 'port_bench')!r}, {TESTS!r}]; "
            f"import run, test_pb_mellum; sys.exit(run.main("
            f"['--workload', 'mellum2-12b-w4.chat16', '--seed', "
            f"'4500000023', '--seconds', '10'], device='cuda', "
            f"fault=test_pb_mellum.wrong_expert_tile))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                       capture_output=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps({"fault": "wrong_expert_tile", "checks": r["checks"]}))
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
def test_mellum_control_at_cell_size(cuda):
    """The control on the card at the Mellum cell's size, three seeds: the
    program's served tokens pass the cell's limit, the control's fail
    it."""
    from test_pb_run import REPO

    p = subprocess.run([sys.executable, os.path.join(HARNESS, "control.py"),
                        "--workload", "mellum2-12b-w4.chat16", "--seeds",
                        "4500000041,4500000042,4500000043", "--seconds",
                        "10"], cwd=REPO, text=True, capture_output=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if x[:1] == "{"]
    assert len(rows) == 3
    for r in rows:
        print(json.dumps({k: r[k]["checks"] for k in ("program",
                                                      "control")}))
        assert r["program"]["correct"] is True, r
        assert r["control"]["correct"] is False, r
