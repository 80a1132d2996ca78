"""Pins of the two dense families' numbers, recorded at commit 36f9b1b
(before the architecture was chosen through ``families/<model_type>.py``):
the seeded raw weights and the plain reference's logits of the tiny
configurations, bit for bit, and the work counts of the published
configurations, exactly. A change to the harness's structure must leave
every one of them as it is; a change to the recipe, the reference or the
counts changes the benchmark's yardstick and has to say so."""

from __future__ import annotations

import hashlib
import json
import os

import pytest
import torch

from conftest import HARNESS, TINY
from pbench import mixes, weights, work
from reference import model as ref

SEEDS = (4, 2**31 + 77)

# sha256 over (path, dtype, shape, bytes) of every tensor, in order
WEIGHTS = {
    "tiny-llama/4/layer0":
        "637c56338f4aba44f69db7a6265384ae05fa1ae60b0235813146da5764594597",
    "tiny-llama/4/layer1":
        "4dfaf0141253659f4de7fbc551ba209d91e4481e5e606afe72ec59794eb51a26",
    "tiny-llama/4/globals":
        "9f8d8f191fcaa2543bcfb7514e963645f7f6dbae99ba3340a6202dd7b000d3c0",
    "tiny-llama/2147483725/layer0":
        "a20144b41e05617ff46740f903ae64ec8f2b92263d582747e7b045574cde17ca",
    "tiny-llama/2147483725/layer1":
        "c78667dd989913e682349f1e6da36109017a4dd8bff0cb7710a2af797eab7e47",
    "tiny-llama/2147483725/globals":
        "ceec7369a675ce8d82e311c5556afbb5eaae23e3233c311925db06bee48fc10b",
    "tiny-opt/4/layer0":
        "b150f20e6699cc25a9a289c13e4cf804dccbfe98ae692110cacfbc1893cb0ec5",
    "tiny-opt/4/layer1":
        "542480bb23d9bf4600538444413fa9ae4041bc34071dd5520eea2cfcaa494a0d",
    "tiny-opt/4/globals":
        "9f552d2abdfc6770f4d45cf49c49f15a1581bd6b5e8c98f7f5dabf6b4982f8d0",
    "tiny-opt/2147483725/layer0":
        "464ddd83d73f36113c9deae2729149abf10ed238723231cbfb9a2ff97b2d6f41",
    "tiny-opt/2147483725/layer1":
        "316b0d890b1f4fe8705bcf5afd867fee020d8c00e5316956be00dce1eeb82d36",
    "tiny-opt/2147483725/globals":
        "daadad4e51d12e2e5ce46bca417c9e328607c4afee7fabd6b0110ac833cb56bd",
}
LOGITS = {
    "tiny-llama/f32":
        "d7db877dc42b038d7b1fc702e5e5a49b109072afae24743775abd8b6794db816",
    "tiny-llama/fp8":
        "b1611f429d36bba546a703d9b348e1df601c7224fe447bc9d913ff70b0a9838f",
    "tiny-opt/f32":
        "8fbe6da7b688dbd7b2faa6507c63d0f2c663d93cb36020c16a98a7176c449821",
    "tiny-opt/fp8":
        "1245f85f2033166ef463f00337a5e226de6e9e3eaaa9313e2102e987f6cbc7f6",
}
# (bytes, flops) of each count; the three contexts of a step also together
WORK = {
    "mistral-7b-w4": {
        "weight_bytes": 4147511168.0, "layer_macs": 218103808,
        "kv_row": 4096,
        "decode_step[1]": (4147909504.0, 14221312000),
        "decode_step[300]": (4187100032.0, 14378074112),
        "decode_step[5000]": (4684649344.0, 16368271360),
        "decode_step[1,300,5000]": (4724636544.0, 44967657472),
        "prefill(64)": (4156552064.0, 894705860608),
        "prefill(1024)": (4290245504.0, 14569059647488),
        "prefill(6144)": (5003277184.0, 94559335874560)},
    "opt-6.7b-w4": {
        "weight_bytes": 3999207680.0, "layer_macs": 201326592,
        "kv_row": 16384,
        "decode_step[1]": (4000473728.0, 13297254400),
        "decode_step[300]": (4157235840.0, 13454016512),
        "decode_step[5000]": (6621389440.0, 15918170112),
        "decode_step[1,300,5000]": (6780683648.0, 42669441024),
        "prefill(64)": (4034011776.0, 826136068096),
        "prefill(1024)": (4553056896.0, 13469697703936),
        "prefill(6144)": (7321297536.0, 89062464290816)},
}


def _flat(obj, pre=""):
    if isinstance(obj, torch.Tensor):
        yield pre, obj
    elif isinstance(obj, dict):
        for k in obj:
            yield from _flat(obj[k], f"{pre}.{k}" if pre else k)
    else:  # a tuple or list of tensors
        for i, v in enumerate(obj):
            yield from _flat(v, f"{pre}.{i}")


def digest(obj) -> str:
    h = hashlib.sha256()
    for name, t in _flat(obj):
        t = t.detach().contiguous().cpu()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_raw_weights_pinned(name, seed):
    cfg = TINY[name]
    for i in range(cfg["num_hidden_layers"]):
        assert digest(weights.layer(cfg, seed, i, "cpu")) \
            == WEIGHTS[f"{name}/{seed}/layer{i}"], i
    assert digest(weights.globals_(cfg, seed, "cpu")) \
        == WEIGHTS[f"{name}/{seed}/globals"]


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("act", ["f32", "fp8"])
def test_reference_logits_pinned(name, act):
    cfg = TINY[name]
    seqs = [mixes.prompt_tokens(9, i, 120, cfg["vocab_size"])
            for i in range(2)]
    got = ref.logits(cfg, 4, seqs, [0, 100], "cpu",
                     act=ref.fp8 if act == "fp8" else None)
    assert digest(got) == LOGITS[f"{name}/{act}"]


@pytest.mark.parametrize("name", sorted(WORK))
def test_work_counts_pinned(name):
    with open(os.path.join(HARNESS, "configs", name + ".json")) as f:
        w = work.Work(json.load(f))
    got = {"weight_bytes": w.weight_bytes, "layer_macs": w.layer_macs,
           "kv_row": w.kv_row}
    for c in (1, 300, 5000):
        got[f"decode_step[{c}]"] = w.decode_step([c])
    got["decode_step[1,300,5000]"] = w.decode_step([1, 300, 5000])
    for n in (64, 1024, 6144):
        got[f"prefill({n})"] = w.prefill(n)
    assert got == WORK[name]
